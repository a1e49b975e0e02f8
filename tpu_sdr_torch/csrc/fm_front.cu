// K1 — fused WBFM front end for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel tpu_sdr/ops/pallas_fm.py `_kernel` (:177,
// launched by `_front_pallas` :617) in its broadcast-rotation form:
//
//   u8 I/Q (one little-endian int16 per complex sample: I low, Q high)
//   -> x = 2u - 255 (the "x255" scale: exact 9-bit integers)
//   -> fs/4 rotation, sample k times j**(k + phase)
//   -> L-tap FIR decimating by d: y[m] = sum_j w[j] x[d*m - (L-1) + j]
//   -> discriminator z[m] = atan2(Im, Re)(y[m] conj(y[m-1])) / pi, with the
//      6-term minimax atan of the TPU kernel (_ATAN6_COEFFS).
//
// Bound.  A 25 MB block (12,533,760 samples) reads 25.1 MB and writes
// 8.4 MB: 10.0 us at 3.35 TB/s; its 144 FMA an output are 9.0 us of f32
// FMA.  A CUDA-core FIR therefore cannot come near the bound with any issue
// overhead (the first port's one-output-a-thread form took 0.107 ms).  This
// form moves the FIR onto the tensor cores, as the TPU kernel did:
//
// The product.  Eight consecutive outputs m = 8g + o read windows that
// start at 8dg - (L-1) + d*o, so all eight lie in one row of 16*KS
// samples starting at R_g = 8dg - (L-1) - delta, delta = (1 - L) mod 8
// (R_g is a multiple of 8: 16-byte rows, and the fs/4 rotation of row
// sample s is (s + phase) & 3 whatever g).  With A[g, s] = x[R_g + s] and
// B[s, o] = w[s - delta - d*o] (zero outside 0..L-1), Y = A B: one
// constant (16*KS x 8) band.  The x255 samples are exact in f16; the taps,
// scaled by a power of two that brings the largest to [2^14, 2^15), split
// exactly into f16 hi + lo (the port's taps are sums of two bf16, the TPU
// kernel's split), so two f16 mma.sync.m16n8k16 passes accumulating in f32
// give the f32 FIR.  Default shape (L = 72, d = 6): KS = 8, and B's 32
// fragment registers stay in registers for the whole kernel.
//
// Warp tiles.  A warp owns tiles of 16 rows and runs them as its own
// pipeline, with no block-wide barrier in the loop.  Row 0 of a tile is the
// group before it, so the tile's first predecessor comes out of the same
// product (overlap-save inside the MMA, no separate halo dot): 120 new
// outputs a tile.  The raw bytes (2 a sample) of a tile stream into the
// warp's 3-slot shared-memory ring two tiles ahead, as a bulk copy
// (TMA, cp.async.bulk) issued by lane 0 and completed on a per-slot
// mbarrier; samples outside the block are stored one by one (zero bytes).
// The MMA's A fragments are decoded straight from the bytes: one 32-bit
// load (I Q I Q of two samples) gives both the re and the im pair, a byte
// permute putting the two bytes on the exponent of 1024 (the
// magic-exponent trick, no I2F), then a subtract and an FMA folding the
// x255 scale and the fs/4 rotation's sign (a lane's pattern is fixed by
// its column and the phase).  Rows are 48 samples (24 words) apart, so
// rows r and r+4 share banks: the fragment loads are 2-way conflicted,
// which measured no slower than a second, shifted copy of every tile.
//
// Epilogue.  A lane holds y for two adjacent outputs of rows r and r+8;
// y[m-1] comes from the neighbouring lane by shuffle; only tile 0 reads
// the external carry.  The ring holds zero bytes for samples k < 0, and
// outputs whose window reaches there swap them for the carry's f32 history.
//
// Shapes with a band deeper than 8 k-steps run the same design with the
// band in shared memory and runtime bounds.
//
// Measured (PERF.md; chip_variants.py takes parts out): ~2.7x the HBM
// bound on a 25 MB block as a lone launch.  The loads and z stores cost
// little once the rest is there; the mma.sync passes (the band is 128 deep
// for 72 taps, twice for hi and lo: 2.1 GFLOP of f16 MMA) cost about a
// quarter; most of the rest is per-tile instruction issue (the byte
// decode, the epilogue's atan) and a launch's fixed cost.
// Next: wgmma, fewer decode instructions (int8 MMA on the raw bytes).
//
// Carries.  The (4, 128) f32 carry keeps the TPU layout: rows 0/1 lanes
// [0, L-1) the rotated FIR history in the x255 scale (samples -(L-1)..-1),
// rows 2/3 the last 128 decimated samples (lane 127 is the
// discriminator's previous sample), other lanes passed through.
//
// Stations.  One launch runs a batch of stations, as the TPU kernel's
// (stations, nchunks) grid does: blockIdx.y is the station, whose bytes,
// carries and z row sit at strides of their own (the sharded chain's
// carries are slices of its halo records), so a row's alignment is worked
// out in the kernel.  A station's blocks split one wave of the card with
// the others; block x = 0 of each writes that station's carry.  The fs/4
// phase is one for all stations or one a station (an int32 array on the
// device).  A lane's rotation pattern is fixed by its column and the
// phase, so a thread works out its byte codes once.  With one phase for
// all (one station, the sharded chain, a batch in step) it is a
// compile-time constant, as in the one-station form, and the codes fold
// into the decode's instructions; with a phase a station, each block reads
// its own at run time (one kernel, one launch), at some cost back to back
// (chip_variants.py's fm_front/runtime_phase; a switch into four constant-
// phase bodies instead, fm_front/four_bodies, costs a cold launch more: its
// code is four times the size).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kFastKS = 8;      // k-steps of 16 samples a row, fast form
constexpr int kRing = 3;        // raw-byte stages in flight or in use
constexpr int kMaxWarps = 8;
constexpr int kTileOutputs = 120;

struct FrontArgs {
  const uint8_t* iq;
  long long iq_stride;  // bytes from one station's row to the next
  long long n;          // complex samples a station
  long long M;          // outputs a station, n / d
  const float* carry_in;
  long long carry_in_stride;   // floats from one station's carry to the next
  const float* taps;
  float* z;
  long long z_stride;          // floats from one station's z row to the next
  float* carry_out;
  long long carry_out_stride;  // floats
  const int* phases;    // per-station fs/4 phases on the device, or null
  int phase;            // every station's phase when phases is null
  int L, d, delta, ks;
  int span;             // samples a tile stages (a multiple of 8)
  int copy_bytes;       // a ring slot: a tile's raw bytes, a multiple of 128
};

// One station's part of a launch (blockIdx.y): its bytes, carries and z
// row, and their alignment, which the row strides may change from row to
// row.
struct Row {
  const uint8_t* iq;
  const float* carry_in;
  float* z;
  float* carry_out;
  bool aligned16;  // iq is 16-byte aligned
  bool z8;         // z is 8-byte aligned
};

// atan(t) ~= t * P(t^2) on [0, 1], 6-term equioscillating fit (9.9e-6 rad).
__device__ __forceinline__ float atan2_poly6(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float t = __fdividef(lo, hi == 0.0f ? 1.0f : hi);
  const float s = t * t;
  float p = -1.3883453812e-02f;
  p = p * s + 5.8200158710e-02f;
  p = p * s - 1.2155903309e-01f;
  p = p * s + 1.9558953030e-01f;
  p = p * s - 3.3295015732e-01f;
  p = p * s + 9.9999125472e-01f;
  float r = p * t;
  if (ay > ax) r = 1.5707963267948966f - r;
  if (x < 0.0f) r = 3.141592653589793f - r;
  return y < 0.0f ? -r : r;  // x = y = 0 gives 0 here too
}

// fs/4 rotation of (i, q) by j**rot, branch-free (lanes rotate by
// different amounts): re = i, -q, -i, q; im = q, i, -q, -i.
__device__ __forceinline__ void rotate(int rot, float i, float q, float* re,
                                      float* im) {
  const bool swap = rot & 1;
  const float a = swap ? q : i, b = swap ? i : q;
  *re = ((rot & 3) == 1 || (rot & 3) == 2) ? -a : a;
  *im = (rot & 2) ? -b : b;
}

// A sample's two bytes (I low, Q high), centred to the x255 scale and
// rotated.
__device__ __forceinline__ void unpack_rotated(uint32_t v, int rot, float* re,
                                               float* im) {
  rotate(rot, 2.0f * (float)(v & 0xFF) - 255.0f,
         2.0f * (float)((v >> 8) & 0xFF) - 255.0f, re, im);
}

__device__ __forceinline__ uint32_t h2_bits(__half2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __half2 bits_h2(uint32_t v) {
  return *reinterpret_cast<__half2*>(&v);
}

// Which byte of a sample's (I, Q) pair carries re (or im) at rotation
// `rot`, and its sign: re = I, -Q, -I, Q; im = Q, I, -Q, -I.
__host__ __device__ constexpr int src_byte(int rot, bool im) {
  return ((rot & 1) != 0) != im ? 1 : 0;
}
__host__ __device__ constexpr bool negative(int rot, bool im) {
  return im ? (rot & 3) >= 2 : ((rot & 3) == 1 || (rot & 3) == 2);
}

// ---- Hopper's bulk copy engine (TMA) with an mbarrier per ring slot ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(n)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mma_f16(float (&acc)[4], const uint32_t (&x)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(b0), "r"(b1));
}

// The power of two that brings the largest |tap| to [2^14, 2^15), found
// by the whole warp from the staged taps.
__device__ __forceinline__ int tap_exponent(const float* taps, int L,
                                            int lane) {
  float big = 0.0f;
  for (int j = lane; j < L; j += 32) big = fmaxf(big, fabsf(taps[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
  }
  // big = 1.f * 2^(x - 127): bring it to [2^14, 2^15)
  const int x = (__float_as_int(big) >> 23) & 0xFF;
  return big > 0.0f ? 14 - (x - 127) : 0;
}

// 2^e as a float, exactly (|e| < 127).
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// Fragment registers of the band at k-step kk for this lane: b[0..1] the
// hi parts, b[2..3] the lo parts.  Lane (r, c) holds B[16kk + 2c + {0,1}]
// and B[16kk + 2c + 8 + {0,1}] of output column o = r, scaled by 2^e.
__device__ __forceinline__ void band_fragment(const FrontArgs& a,
                                              const float* taps, int e,
                                              int kk, int lane, uint32_t* b) {
  const int o = lane >> 2, c = lane & 3;
  float hi[4], lo[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int s = 16 * kk + 2 * c + (t & 1) + 8 * (t >> 1);
    const int j = s - a.delta - a.d * o;
    const float w = (j >= 0 && j < a.L) ? taps[j] * pow2(e) : 0.0f;
    hi[t] = __half2float(__float2half_rn(w));
    lo[t] = w - hi[t];
  }
  b[0] = h2_bits(__floats2half2_rn(hi[0], hi[1]));
  b[1] = h2_bits(__floats2half2_rn(hi[2], hi[3]));
  b[2] = h2_bits(__floats2half2_rn(lo[0], lo[1]));
  b[3] = h2_bits(__floats2half2_rn(lo[2], lo[3]));
}

// A raw word (bytes I Q I Q of two samples) as the rotated x255 pair of one
// component in packed f16, for this lane's rotation: `sel` picks the two
// bytes onto the exponent of 1024 (f16 0x6400), then 2s(h - 1024) - 255s.
struct PairCode {
  uint32_t sel, two, off;
};

__device__ __forceinline__ uint32_t decode(uint32_t w, PairCode p) {
  const __half2 h = bits_h2(__byte_perm(w, 0x64u, p.sel));
  const __half2 u = __hsub2(h, bits_h2(0x64006400u));
  return h2_bits(__hfma2(u, bits_h2(p.two), bits_h2(p.off)));
}

// The code of samples at rotations (ra, rb), the first at byte 0 of a word.
__device__ __forceinline__ PairCode pair_code(int ra, int rb, bool im) {
  const bool na = negative(ra, im), nb = negative(rb, im);
  return {0x4040u | (uint32_t)src_byte(ra, im) |
              ((2u + (uint32_t)src_byte(rb, im)) << 8),
          (na ? 0xC000u : 0x4000u) | ((nb ? 0xC000u : 0x4000u) << 16),
          (na ? 0x5BF8u : 0xDBF8u) | ((nb ? 0x5BF8u : 0xDBF8u) << 16)};
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// One station's work in a block.  Shared memory: per warp, the raw-byte
// ring (kRing slots of a tile's bytes) and its kRing mbarriers; per block,
// the band's fragments (generic form), the carry's f32 history and the
// taps.
template <bool FAST>
__device__ __forceinline__ void front(const FrontArgs& a, const Row& row,
                                      int phase) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3;
  const int W = blockDim.x >> 5;
  const int ks = FAST ? kFastKS : a.ks;
  const int copy_bytes = a.copy_bytes;
  const int slot_bytes = copy_bytes;
  uint8_t* ring = smem + warp * (kRing * slot_bytes);
  unsigned char* block_area = smem + W * kRing * slot_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(block_area) + warp * kRing;
  uint32_t* band = reinterpret_cast<uint32_t*>(block_area + round16(8 * kRing * W));
  float* hist = reinterpret_cast<float*>(band + ks * 128);
  float* staps = hist + 2 * kLanes;

  // a warp tile: 16 rows of 8 outputs, row 0 the group before the tile
  // (its last output is the predecessor of the tile's first), so 120 new
  // outputs a tile
  const long long tiles = (a.M + kTileOutputs - 1) / kTileOutputs;
  // warps walk tiles t, t + (all warps), ...; block 0, which also writes
  // the carry's rows, starts from the last warp's place so that its warps
  // are among those with one tile fewer
  const long long step = (long long)gridDim.x * W;
  const long long first = step - 1 - ((long long)blockIdx.x * W + warp);
  auto tile_k0 = [&](long long s) {
    return (long long)kTileOutputs * a.d * s - 8LL * a.d - (a.L - 1) - a.delta;
  };
  // raw bytes of warp tile s into ring slot `slot`: the whole 16-byte
  // chunks inside the (aligned) block by a bulk copy (TMA) from lane 0, the
  // samples around them one at a time, zero outside the block; the slot's
  // mbarrier completes a phase when all of it is in
  // tiles [inner_lo, inner_hi) lie wholly in the (aligned) block
  const long long tile_samples = (long long)kTileOutputs * a.d;
  const long long inner_lo =
      (a.L - 1 + a.delta + 8LL * a.d + tile_samples - 1) / tile_samples;
  const long long inner_hi = row.aligned16
      ? (a.n - a.span + a.L - 1 + a.delta + 8LL * a.d) / tile_samples + 1
      : 0;
  auto issue = [&](long long s, int slot) {
    if (s >= tiles) return;
    const long long k0 = tile_k0(s);
    uint8_t* dst = ring + slot * slot_bytes;
    if (s >= inner_lo && s < inner_hi) {
      if (lane == 0) {
        mbar_expect_bytes(&bars[slot], 2 * a.span);
        bulk_copy(dst, row.iq + 2 * k0, 2 * a.span, &bars[slot]);
      }
      return;
    }
    const long long lo = k0 > 0 ? k0 : 0;
    const long long hi = k0 + a.span < a.n ? k0 + a.span : a.n;
    long long bulk_lo = lo, bulk_hi = lo;  // samples, multiples of 8
    if (row.aligned16 && hi > lo) {
      bulk_lo = (lo + 7) & ~7LL;
      bulk_hi = hi & ~7LL;
      if (bulk_hi < bulk_lo) bulk_hi = bulk_lo;
    }
    if (bulk_lo != k0 || bulk_hi != k0 + a.span) {
      for (int k = lane; k < a.span; k += 32) {
        const long long kk = k0 + k;
        if (kk >= bulk_lo && kk < bulk_hi) continue;
        const uint16_t v = (kk >= 0 && kk < a.n)
            ? (uint16_t)(row.iq[2 * kk] | (row.iq[2 * kk + 1] << 8)) : (uint16_t)0;
        *reinterpret_cast<uint16_t*>(dst + 2 * k) = v;
      }
      __syncwarp();
    }
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)(2 * (bulk_hi - bulk_lo));
      if (bytes == 0) {
        mbar_arrive(&bars[slot]);
      } else {
        mbar_expect_bytes(&bars[slot], bytes);
        bulk_copy(dst + 2 * (bulk_lo - k0), row.iq + 2 * bulk_lo, bytes,
                  &bars[slot]);
      }
    }
  };
  // the taps and the carry's f32 history (tile 0 adds it where its windows
  // reach k < 0), staged once, their loads ahead of the first copies
  for (int l = tid; l < a.L; l += blockDim.x) staps[l] = a.taps[l];
  for (int l = tid; l < 2 * kLanes; l += blockDim.x) hist[l] = row.carry_in[l];
  if (blockIdx.x == 0) {  // the carry's rows 0/1 and rows 2/3 left of M
    for (int l = tid; l < kLanes; l += blockDim.x) {
      // rows 2/3 lanes left of the call's first sample (calls under 128
      // outputs): the old row, shifted by M
      if (l < kLanes - a.M) {
        row.carry_out[2 * kLanes + l] = row.carry_in[2 * kLanes + l + a.M];
        row.carry_out[3 * kLanes + l] = row.carry_in[3 * kLanes + l + a.M];
      }
      // rows 0/1: xext[n + l] of xext = [history (L-1) | block (n)]
      float re = row.carry_in[0 * kLanes + l], im = row.carry_in[1 * kLanes + l];
      if (l < a.L - 1) {
        const long long pos = a.n + l;
        if (pos < a.L - 1) {
          re = row.carry_in[0 * kLanes + pos];
          im = row.carry_in[1 * kLanes + pos];
        } else {
          const long long k = pos - (a.L - 1);
          unpack_rotated(row.iq[2 * k] | (row.iq[2 * k + 1] << 8),
                         (int)((k + phase) & 3), &re, &im);
        }
      }
      row.carry_out[0 * kLanes + l] = re;
      row.carry_out[1 * kLanes + l] = im;
    }
  }
  if (lane == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int i = 0; i < kRing - 1; ++i) issue(first + i * step, i);
  __syncthreads();

  // the band, scaled by 2^e, built once by the block; the fast form then
  // keeps it in registers
  const int e = tap_exponent(staps, a.L, lane);
  const float unscale = pow2(-e);
  for (int i = tid; i < ks * 32; i += blockDim.x) {
    band_fragment(a, staps, e, i >> 5, i & 31, band + 4 * i);
  }
  __syncthreads();
  uint32_t breg[FAST ? kFastKS : 1][4];
  if constexpr (FAST) {
#pragma unroll
    for (int kk = 0; kk < kFastKS; ++kk) {
      const uint4 v = *reinterpret_cast<const uint4*>(band + 4 * (kk * 32 + lane));
      breg[kk][0] = v.x;
      breg[kk][1] = v.y;
      breg[kk][2] = v.z;
      breg[kk][3] = v.w;
    }
  }

  // this lane's fragments: rows r and r + 8, samples 2c, 2c+1 (+8) of each
  // k-step, rotated by (2c + phase) & 3 and the next
  const PairCode code_re = pair_code((2 * c + phase) & 3, (2 * c + 1 + phase) & 3, false);
  const PairCode code_im = pair_code((2 * c + phase) & 3, (2 * c + 1 + phase) & 3, true);
  const int row_stride = 8 * a.d;
  const int w_row = (row_stride * r + 2 * c) / 2;           // 32-bit words
  const int w_r8 = 4 * row_stride;                          // row r + 8
  const unsigned full = 0xffffffffu;

  // tiles before plain_end write z with no bounds and no carry rows
  const long long plain_end = row.z8 && a.M >= kLanes
      ? (a.M - kLanes) / kTileOutputs : 0;
  int it = 0;
  for (long long s = first; s < tiles; s += step, ++it) {
    const int slot = it % kRing;
    issue(s + (kRing - 1) * step, (it + kRing - 1) % kRing);
    mbar_wait(&bars[slot], (it / kRing) & 1);
    const uint8_t* raw = ring + slot * slot_bytes;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(raw) + w_row;

    // ---- the banded product: 16 rows x 8 outputs, hi and lo passes, in
    // four independent accumulator chains; fragments decoded from bytes ----
    float acc_re[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_im[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float lo_re[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float lo_im[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    auto kstep = [&](int kk, const uint32_t* bb) {
      const int w = 8 * kk;
      const uint32_t raw4[4] = {words[w], words[w + w_r8], words[w + 4],
                                words[w + w_r8 + 4]};
      uint32_t xr[4], xi[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        xr[t] = decode(raw4[t], code_re);
        xi[t] = decode(raw4[t], code_im);
      }
      mma_f16(acc_re, xr, bb[0], bb[1]);
      mma_f16(lo_re, xr, bb[2], bb[3]);
      mma_f16(acc_im, xi, bb[0], bb[1]);
      mma_f16(lo_im, xi, bb[2], bb[3]);
    };
    if constexpr (FAST) {
#pragma unroll
      for (int kk = 0; kk < kFastKS; ++kk) kstep(kk, breg[kk]);
    } else {
      for (int kk = 0; kk < ks; ++kk) {
        const uint4 v = *reinterpret_cast<const uint4*>(band + 4 * (kk * 32 + lane));
        const uint32_t bb[4] = {v.x, v.y, v.z, v.w};
        kstep(kk, bb);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc_re[t] = (acc_re[t] + lo_re[t]) * unscale;
      acc_im[t] = (acc_im[t] + lo_im[t]) * unscale;
    }

    // outputs of this lane: m[0], m[0]+1 (row r), m[2], m[2]+1 (row r+8);
    // row 0's belong to the previous tile
    const long long m_lo = kTileOutputs * s + 8 * (r - 1) + 2 * c;
    const long long mm[4] = {m_lo, m_lo + 1, m_lo + 64, m_lo + 65};

    // the ring holds zero bytes (x = -255, rotated) for samples k < 0;
    // windows reaching there swap them for the carry's f32 history
    if (s < inner_lo && tile_k0(s) < 0) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long start = (long long)a.d * mm[t] - (a.L - 1);
        for (long long k = start < -(a.L - 1) ? 0 : start; k < 0; ++k) {
          const float w = staps[k - start];
          float g_re, g_im;
          rotate((int)((k + phase) & 3), -255.0f, -255.0f, &g_re, &g_im);
          acc_re[t] = fmaf(w, hist[0 * kLanes + (a.L - 1) + k] - g_re, acc_re[t]);
          acc_im[t] = fmaf(w, hist[1 * kLanes + (a.L - 1) + k] - g_im, acc_im[t]);
        }
      }
    }

    // ---- discriminator: y[m] conj(y[m-1]) ----
    float b_re[4], b_im[4];
    b_re[1] = acc_re[0];
    b_im[1] = acc_im[0];
    b_re[3] = acc_re[2];
    b_im[3] = acc_im[2];
    b_re[0] = __shfl_up_sync(full, acc_re[1], 1);
    b_im[0] = __shfl_up_sync(full, acc_im[1], 1);
    b_re[2] = __shfl_up_sync(full, acc_re[3], 1);
    b_im[2] = __shfl_up_sync(full, acc_im[3], 1);
    const float l31_re = __shfl_sync(full, acc_re[1], 31);
    const float l31_im = __shfl_sync(full, acc_im[1], 31);
    if (lane == 0) {  // row 8's predecessor: row 7's last output
      b_re[2] = l31_re;
      b_im[2] = l31_im;
    }
    if (s == 0 && lane == 4) {  // output 0's: the carried sample
      b_re[0] = row.carry_in[2 * kLanes + kLanes - 1];
      b_im[0] = row.carry_in[3 * kLanes + kLanes - 1];
    }
    float zz[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float cr = acc_re[t] * b_re[t] + acc_im[t] * b_im[t];
      const float ci = acc_im[t] * b_re[t] - acc_re[t] * b_im[t];
      zz[t] = atan2_poly6(ci, cr) * 0.31830988618379067f;
    }
    __syncwarp();  // the slot is refilled next
    if (s < plain_end) {  // whole tile, no carry rows, 8-byte aligned z
      float* zt = row.z + m_lo;
      if (r > 0) *reinterpret_cast<float2*>(zt) = make_float2(zz[0], zz[1]);
      *reinterpret_cast<float2*>(zt + 64) = make_float2(zz[2], zz[3]);
      continue;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long m = mm[t];
      if (m >= 0 && m < a.M && (r > 0 || t >= 2)) {
        row.z[m] = zz[t];
        const long long l = m - (a.M - kLanes);  // last 128 -> rows 2/3
        if (l >= 0) {
          row.carry_out[2 * kLanes + l] = acc_re[t];
          row.carry_out[3 * kLanes + l] = acc_im[t];
        }
      }
    }
  }
}

// The kernel: blockIdx.y is the station.  PHASE >= 0 is every station's
// fs/4 phase; PHASE < 0 reads each station's from `phases` (or `phase`).
template <int PHASE, bool FAST>
__global__ void __launch_bounds__(256)
fm_front_kernel(const __grid_constant__ FrontArgs a) {
  const long long s = blockIdx.y;
  Row row;
  row.iq = a.iq + s * a.iq_stride;
  row.carry_in = a.carry_in + s * a.carry_in_stride;
  row.z = a.z + s * a.z_stride;
  row.carry_out = a.carry_out + s * a.carry_out_stride;
  row.aligned16 = ((uintptr_t)row.iq % 16) == 0;
  row.z8 = ((uintptr_t)row.z % 8) == 0;
  front<FAST>(a, row, PHASE >= 0 ? PHASE
                          : a.phases != nullptr ? (a.phases[s] & 3) : a.phase);
}

template <int PHASE, bool FAST>
int launch(const FrontArgs& a, int stations, int warps, size_t smem,
           cudaStream_t stream) {
  auto kernel = fm_front_kernel<PHASE, FAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 32 * warps, smem)) != cudaSuccess) {
    return (int)err;
  }
  const long long tiles = (a.M + kTileOutputs - 1) / kTileOutputs;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // one wave over the whole launch: the stations share it
  grid = (grid + stations - 1) / stations;
  if (grid > (tiles + warps - 1) / warps) grid = (tiles + warps - 1) / warps;
  kernel<<<dim3((unsigned)grid, (unsigned)stations), 32 * warps, smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

// One phase for all stations: the kernel with it a compile-time constant;
// a phase a station: the kernel that reads each at run time.
template <bool FAST>
int launch_phase(const FrontArgs& a, int stations, int warps, size_t smem,
                 cudaStream_t stream) {
  if (a.phases != nullptr) {
    return launch<-1, FAST>(a, stations, warps, smem, stream);
  }
  switch (a.phase) {
    case 0: return launch<0, FAST>(a, stations, warps, smem, stream);
    case 1: return launch<1, FAST>(a, stations, warps, smem, stream);
    case 2: return launch<2, FAST>(a, stations, warps, smem, stream);
    default: return launch<3, FAST>(a, stations, warps, smem, stream);
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over `stations` rows: station s reads 2n bytes
// at iq_u8 + s*iq_stride (2-byte aligned), rotates them from fs/4 phase
// phases[s] (an int32 device array) or, with phases null, from `phase`,
// and reads the (4, 128) f32 carry at carry_in + s*carry_in_stride; it
// writes n/decim f32 at z + s*z_stride and its new carry at carry_out +
// s*carry_out_stride (no carry_out row may overlap a carry_in row).
// taps: L f32 (each a sum of two bf16, as make_kernel_params gives them,
// within 2^24 of the largest).  Returns 0 or the CUDA error of the launch.
int tsdr_fm_front_batch(const void* iq_u8, long long iq_stride, int stations,
                        long long n, const int* phases, int phase,
                        const float* carry_in, long long carry_in_stride,
                        const float* taps, int num_taps, int decim, float* z,
                        long long z_stride, float* carry_out,
                        long long carry_out_stride, void* stream) {
  if (n <= 0 || decim <= 0 || n % decim != 0 || num_taps < 1 ||
      num_taps - 1 > kLanes || phase < 0 || phase > 3 || stations < 1 ||
      stations > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  FrontArgs a;
  a.iq = (const uint8_t*)iq_u8;
  a.iq_stride = iq_stride;
  a.n = n;
  a.M = n / decim;
  a.carry_in = carry_in;
  a.carry_in_stride = carry_in_stride;
  a.taps = taps;
  a.z = z;
  a.z_stride = z_stride;
  a.carry_out = carry_out;
  a.carry_out_stride = carry_out_stride;
  a.phases = phases;
  a.phase = phase;
  a.L = num_taps;
  a.d = decim;
  a.delta = ((1 - num_taps) % 8 + 8) % 8;
  a.ks = (a.delta + 7 * decim + num_taps + 15) / 16;
  const bool fast = a.ks <= kFastKS;
  if (fast) a.ks = kFastKS;
  // a warp tile: 16 rows of 8 outputs and the band's reach
  const long long span = 8LL * decim * 15 + 16LL * a.ks;
  const long long copy = (2 * span + 127) / 128 * 128;
  const size_t warp_bytes = kRing * (size_t)copy;
  const size_t block_bytes = 512 * (size_t)a.ks + 4 * 2 * kLanes +
                             round16(4 * num_taps);
  a.span = (int)span;
  a.copy_bytes = (int)copy;
  const size_t kBudget = 200 * 1024;
  for (int warps = kMaxWarps; warps >= 1; warps >>= 1) {
    const size_t smem = warps * warp_bytes + round16(8 * kRing * warps) +
                        block_bytes;
    if (smem > kBudget) continue;
    return fast ? launch_phase<true>(a, stations, warps, smem,
                                     (cudaStream_t)stream)
                : launch_phase<false>(a, stations, warps, smem,
                                      (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches K1 on one station: the batch entry with one row.  iq_u8: 2n
// bytes (2-byte aligned); carry_in and carry_out: distinct (4, 128) f32;
// z: n/decim f32.
int tsdr_fm_front(const void* iq_u8, long long n, int phase,
                  const float* carry_in, const float* taps, int num_taps,
                  int decim, float* z, float* carry_out, void* stream) {
  return tsdr_fm_front_batch(iq_u8, 0, 1, n, nullptr, phase, carry_in, 0,
                             taps, num_taps, decim, z, 0, carry_out, 0,
                             stream);
}

const char* tsdr_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
