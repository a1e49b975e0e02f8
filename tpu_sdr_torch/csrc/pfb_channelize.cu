// K3 — PFB channelizer for Hopper (sm_90a): branch FIR, then FFT.
//
// Replaces the Pallas TPU kernel tpu_sdr/ops/pallas_channelizer.py
// `_kernel` (:92, launched by `channelize_fused` :161), and computes the
// function its dense product stands for:
//
//   x[f, p]   = 2u - 255 of complex sample p of frame f (u8 I/Q, I low);
//               frames before the call come from the (2H, K) carry
//   fir[f, p] = sum_{t<R} G[t, p] * x[f - t, p]          (G = h_poly, f32)
//   Y[f, k]   = (1/255) sum_p fir[f, p] * exp(-2 pi i p k / K)
//   y[f]      = [Y_re | Y_im] over the columns k in [c0, c0 + Ko)
//
// The TPU kernel multiplied the frame windows by M2 = G x DFT folded into
// one (R*K, 2K) matrix because it has a matrix unit and no complex FFT;
// here the branch filter and the DFT stay factored.
//
// Bound.  At K = 64, R = 9 a frame costs 2,304 FLOP of FIR and ~1,900 of
// FFT, against 128 bytes read and 512 written: ~7 FLOP a byte, far below
// the card's balance, so K3 is bound by its memory traffic (125 MB and
// ~37 us at 3.35 TB/s for a 25 MB block of u8).  The design therefore
// touches each byte once and keeps everything between the load and the
// store on chip:
//
// * Staging: persistent blocks walk tiles of TM frames; a tile's raw
//   bytes plus its 8 history frames, (TM + 8) * 128 B, arrive in shared
//   memory by 16-byte cp.async copies, the next tile's in flight (two
//   buffers) while the current one is computed.
// * FIR: two warps filter 8 consecutive frames of all 64 branches, a lane
//   one branch, with the 9-frame window in registers; only the call's
//   first frames (the carry) and its ragged end read global memory.
//   Results go to shared memory, one padded row a frame.
// * FFT: 8 lanes a frame; lane j takes branches p = j + 8q, q < 8, does a
//   radix-8 DFT over q in registers, multiplies by W64^(j*k1)/255 (a
//   host-built f64 -> f32 table: the 1/255 of the x255 scale is folded in,
//   no __sinf), transposes the 8 x 8 values across the frame's lanes by
//   __shfl_xor_sync and does the second radix-8 DFT over j: lane j then
//   holds Y[j + 8*k2].
// * Stores: the values go back to the frame's row in natural order, and
//   each warp writes its 4 rows' windows as float4 streaming stores (one
//   128-byte line a quarter warp; 4-byte stores in the FFT's digit order
//   cost ~30% of the kernel's time in an earlier form).
// * Tiles of TM = 16 frames (8 frames where a short read, such as the
//   CLI's 5,440 frames, would leave SMs without two tiles), 8*TM threads.
//
// What is left is the memory traffic: on the H100 the kernel takes ~1.15x
// a device copy of its 125 MB, and with both the FIR and the FFT taken out
// it still takes ~93% of its time (chip_variants.py).
//
// Any other even K (and any R) takes a direct-DFT path: the same FIR into
// shared memory, then each output column as a sum over the K branches with
// a shared-memory table of exp(-2 pi i n / K) / 255.  The sum runs in 16
// partial sums (branch p into sum p mod 16), added pairwise at the end: one
// float32 running sum of K terms errs by ~sqrt(K / 2) of its roundings
// (~122 dB under the exact PFB at K = 1024), 16 of K / 16 terms by a
// quarter of that.
//
// Carry.  Blocks run in parallel, so each reads its own history straight
// from the input; only the call's first R-1 frames read the external
// carry.  The carry keeps the TPU layout: (2H, K) f32, H = R-1, the last H
// input frames in the x255 scale, re rows then im rows, bit-equal to the
// plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFastK = 64;                  // the factored path: 64 = 8 x 8
constexpr int kFastR = 9;
constexpr int kRun = 8;                     // frames a FIR warp filters
constexpr int kWindow = kRun + kFastR - 1;  // frames a FIR lane loads
constexpr int kRowFloats = 2 * kFastK + 16; // fir row: 64 complex + pad
constexpr int kDirectThreads = 256;
constexpr int kDirectSums = 16;             // partial sums a direct column
constexpr size_t kDirectSmem = 96 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRsqrt2 = 0.70710678118654752f;

__device__ __forceinline__ float2 unpack_one(uint32_t v) {
  // bytes I Q (in the low half) -> (re, im) in the x255 scale (exact)
  return make_float2(2.0f * (float)(v & 0xFFu) - 255.0f,
                     2.0f * (float)((v >> 8) & 0xFFu) - 255.0f);
}

// Branch p of frame g as (re, im): the input for 0 <= g < m, the carry
// for g < 0, zeros past the end.
__device__ __forceinline__ float2 load_one(const uint16_t* __restrict__ iq,
                                           const float* __restrict__ carry,
                                           long long g, long long m, int K,
                                           int H, int p) {
  if (g >= m) return make_float2(0.0f, 0.0f);
  if (g >= 0) return unpack_one(__ldg(iq + g * K + p));
  return make_float2(carry[(H + g) * K + p], carry[(2 * H + g) * K + p]);
}

__device__ __forceinline__ void fir_tap(float2& a, float g, float2 v) {
  a.x = fmaf(g, v.x, a.x);
  a.y = fmaf(g, v.y, a.y);
}

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// 4-point DFT in place, natural order, W4 = -i.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = a1 - a3;
  a0 = t0 + t2;
  a2 = t0 - t2;
  a1 = make_float2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
  a3 = make_float2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
}

// 8-point DFT in place, natural order, W8 = exp(-2 pi i / 8): two 4-point
// DFTs of the even and odd samples, then one radix-2 step.
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  float2 e0 = a[0], e1 = a[2], e2 = a[4], e3 = a[6];
  float2 o0 = a[1], o1 = a[3], o2 = a[5], o3 = a[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = make_float2((o1.x + o1.y) * kRsqrt2, (o1.y - o1.x) * kRsqrt2);
  o2 = make_float2(o2.y, -o2.x);
  o3 = make_float2((o3.y - o3.x) * kRsqrt2, -(o3.x + o3.y) * kRsqrt2);
  a[0] = e0 + o0;
  a[4] = e0 - o0;
  a[1] = e1 + o1;
  a[5] = e1 - o1;
  a[2] = e2 + o2;
  a[6] = e2 - o2;
  a[3] = e3 + o3;
  a[7] = e3 - o3;
}

// 8 x 8 transpose across the 8 lanes of a frame: lane j holds row j on
// entry and column j on return.  Three butterfly steps; at step s a lane
// swaps with lane j ^ s the half of its values whose index bit s differs
// from its own.
__device__ __forceinline__ void transpose8(float2 (&a)[8], int j) {
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
    const bool upper = (j & s) != 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & s) continue;
      const float2 send = upper ? a[i] : a[i | s];
      const float2 recv = make_float2(__shfl_xor_sync(kFull, send.x, s),
                                      __shfl_xor_sync(kFull, send.y, s));
      if (upper) {
        a[i] = recv;
      } else {
        a[i | s] = recv;
      }
    }
  }
}

// New carry (block 0): frames [m, m+H) of [carry | input], x255.
__device__ void write_carry(const uint8_t* __restrict__ bytes, long long m,
                            int K, int H, const float* __restrict__ carry_in,
                            float* __restrict__ carry_out) {
  for (int i = threadIdx.x; i < H * K; i += blockDim.x) {
    const int h = i / K;
    const int p = i - h * K;
    const long long pos = m + h;
    float re, im;
    if (pos < H) {
      re = carry_in[pos * K + p];
      im = carry_in[(H + pos) * K + p];
    } else {
      const long long s = 2 * ((pos - H) * K + p);
      re = 2.0f * (float)bytes[s] - 255.0f;
      im = 2.0f * (float)bytes[s + 1] - 255.0f;
    }
    carry_out[h * K + p] = re;
    carry_out[(H + h) * K + p] = im;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Stage the raw bytes of tile frames [m0 - 8, m0 + TM) that lie in
// [0, m) into buf (frame g at row g - m0 + 8): 16-byte cp.async copies,
// or 2-byte loads where the input is not 16-byte aligned.
template <int TM>
__device__ __forceinline__ void stage_tile(const uint16_t* __restrict__ iq,
                                           long long m, long long m0,
                                           uint16_t* buf, bool aligned) {
  const long long g0 = m0 - (kFastR - 1);
  const long long lo = g0 < 0 ? 0 : g0;
  const long long hi = m0 + TM < m ? m0 + TM : m;
  const int first = (int)(lo - g0) * (kFastK / 8);  // 16-byte chunks
  const int last = (int)(hi - g0) * (kFastK / 8);
  const uint16_t* src = iq + g0 * kFastK;
  if (aligned) {
    for (int c = first + threadIdx.x; c < last; c += blockDim.x)
      cp_async16(buf + 8 * c, src + 8 * c);
  } else {
    for (int c = 8 * first + threadIdx.x; c < 8 * last; c += blockDim.x)
      buf[c] = src[c];
  }
}

// K = 64, R = 9: persistent blocks of 8*TM threads walk tiles of TM
// frames; the next tile's bytes are in flight (cp.async, two buffers)
// while the current one is filtered, transformed and stored.
template <int TM>
__global__ void __launch_bounds__(8 * TM)
pfb64_kernel(const uint16_t* __restrict__ iq, long long m, int c0, int Ko,
             const float* __restrict__ carry_in,
             const float* __restrict__ taps, const float2* __restrict__ tw,
             float* __restrict__ y, float* __restrict__ carry_out) {
  constexpr int kSpan = (TM + kFastR - 1) * kFastK;  // samples a stage
  __shared__ __align__(16) uint16_t stage[2][kSpan];
  __shared__ __align__(16) float rows[TM * kRowFloats];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int j = tid & 7;
  const int p = 32 * (w & 1) + lane;  // a FIR lane's branch
  const bool aligned = ((uintptr_t)iq & 15) == 0;
  const long long tiles = (m + TM - 1) / TM;

  long long t = blockIdx.x;
  if (t < tiles) stage_tile<TM>(iq, m, t * TM, stage[0], aligned);
  asm volatile("cp.async.commit_group;\n" ::);
  float g[kFastR];
#pragma unroll
  for (int i = 0; i < kFastR; ++i) g[i] = __ldg(taps + i * kFastK + p);
  float2 wj[8];  // W64^(j*k1) / 255
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) wj[k1] = __ldg(tw + j * k1);

  for (int cur = 0; t < tiles; t += gridDim.x, cur ^= 1) {
    if (t + gridDim.x < tiles)
      stage_tile<TM>(iq, m, (t + gridDim.x) * TM, stage[cur ^ 1], aligned);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const long long m0 = t * TM;

    // ---- FIR: warps 2s, 2s+1 filter frames f0 .. f0+kRun-1, a lane one
    // branch, from the staged bytes (from global memory and the carry at
    // the call's first frames and its ragged end)
    if (w < 2 * TM / kRun) {
      const int r0 = (w >> 1) * kRun;  // = f0 - m0
      const long long f0 = m0 + r0;
      float2 x[kWindow];  // frames f0-8 .. f0+kRun-1
      if (f0 >= kFastR - 1 && f0 + kRun <= m) {
        const uint16_t* s = stage[cur] + r0 * kFastK + p;
#pragma unroll
        for (int i = 0; i < kWindow; ++i) x[i] = unpack_one(s[i * kFastK]);
      } else {
#pragma unroll
        for (int i = 0; i < kWindow; ++i)
          x[i] = load_one(iq, carry_in, f0 - (kFastR - 1) + i, m, kFastK,
                          kFastR - 1, p);
      }
      float* out = rows + r0 * kRowFloats + 2 * p;
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int i = 0; i < kFastR; ++i) fir_tap(a, g[i], x[r + kFastR - 1 - i]);
        *reinterpret_cast<float2*>(out + r * kRowFloats) = a;
      }
    }
    __syncthreads();

    // ---- FFT: 8 lanes a frame, a warp 4 frames
    float* row = rows + (tid >> 3) * kRowFloats;
    float2 a[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      a[q] = *reinterpret_cast<const float2*>(row + 2 * (j + 8 * q));
    dft8(a);                                            // over q: index k1
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) a[k1] = cmul(a[k1], wj[k1]);
    transpose8(a, j);                                   // lane j: k1 = j
    dft8(a);                                            // over j: index k2
    __syncwarp();
    // natural order back in the frame's row: [Y_re[0..64) | Y_im[0..64)]
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      row[j + 8 * k2] = a[k2].x;
      row[kFastK + j + 8 * k2] = a[k2].y;
    }
    __syncwarp();

    // ---- stores: the warp's 4 rows, columns [c0, c0 + Ko) of each half
    const long long fw = m0 + 4 * w;
    const float* wrows = rows + 4 * w * kRowFloats;
    if (((c0 | Ko) & 3) == 0) {  // float4: Ko/4 of re then Ko/4 of im
      const int q4 = Ko / 4;
#pragma unroll
      for (int fr = 0; fr < 4; ++fr) {
        if (lane < 2 * q4 && fw + fr < m) {
          const int src = lane < q4 ? c0 + 4 * lane : kFastK + c0 + 4 * (lane - q4);
          __stcs(reinterpret_cast<float4*>(y + (fw + fr) * 2 * Ko) + lane,
                 *reinterpret_cast<const float4*>(wrows + fr * kRowFloats + src));
        }
      }
    } else {
      for (int fr = 0; fr < 4 && fw + fr < m; ++fr) {
        for (int c = lane; c < 2 * Ko; c += 32) {
          const int src = c < Ko ? c0 + c : kFastK + c0 + c - Ko;
          __stcs(y + (fw + fr) * 2 * Ko + c, wrows[fr * kRowFloats + src]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  if (blockIdx.x == 0)
    write_carry(reinterpret_cast<const uint8_t*>(iq), m, kFastK, kFastR - 1,
                carry_in, carry_out);
}

// Any even K, any R: the FIR, one (frame, branch) an item, then a direct
// DFT, one (frame, output column) an item.
__global__ void __launch_bounds__(kDirectThreads)
pfb_direct_kernel(const uint16_t* __restrict__ iq, long long m, int K, int R,
                  int c0, int Ko, int TM, const float* __restrict__ carry_in,
                  const float* __restrict__ taps,
                  const float2* __restrict__ tw, float* __restrict__ y,
                  float* __restrict__ carry_out) {
  extern __shared__ float2 smem2[];
  float2* twid = smem2;
  float2* fir = twid + K;  // (TM, K)
  const int H = R - 1;
  const long long m0 = (long long)blockIdx.x * TM;
  for (int i = threadIdx.x; i < K; i += blockDim.x) twid[i] = tw[i];
  for (int i = threadIdx.x; i < TM * K; i += blockDim.x) {
    const int lf = i / K;
    const int p = i - lf * K;
    const long long f = m0 + lf;
    float2 a = make_float2(0.0f, 0.0f);
    if (f < m) {
      for (int t = 0; t < R; ++t)
        fir_tap(a, __ldg(taps + t * K + p), load_one(iq, carry_in, f - t, m,
                                                     K, H, p));
    }
    fir[i] = a;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * Ko; i += blockDim.x) {
    const int lf = i / Ko;
    const int c = i - lf * Ko;
    const long long f = m0 + lf;
    if (f >= m) continue;
    const int k = c0 + c;
    const float2* row = fir + lf * K;
    float re[kDirectSums], im[kDirectSums];
#pragma unroll
    for (int j = 0; j < kDirectSums; ++j) re[j] = im[j] = 0.0f;
    int n = 0;  // p * k mod K
    for (int p0 = 0; p0 < K; p0 += kDirectSums) {
#pragma unroll
      for (int j = 0; j < kDirectSums; ++j) {
        if (p0 + j < K) {
          const float2 x = row[p0 + j];
          const float2 w = twid[n];
          re[j] = fmaf(x.x, w.x, fmaf(-x.y, w.y, re[j]));
          im[j] = fmaf(x.x, w.y, fmaf(x.y, w.x, im[j]));
          n += k;
          if (n >= K) n -= K;
        }
      }
    }
#pragma unroll
    for (int s = kDirectSums / 2; s > 0; s /= 2) {
#pragma unroll
      for (int j = 0; j < s; ++j) {
        re[j] += re[j + s];
        im[j] += im[j + s];
      }
    }
    y[f * 2 * Ko + c] = re[0];
    y[f * 2 * Ko + Ko + c] = im[0];
  }
  if (blockIdx.x == 0)
    write_carry(reinterpret_cast<const uint8_t*>(iq), m, K, H, carry_in,
                carry_out);
}

template <int TM>
cudaError_t launch64(const uint16_t* iq, long long m, int c0, int Ko,
                     const float* carry_in, const float* taps,
                     const float2* tw, float* y, float* carry_out, int sms,
                     cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pfb64_kernel<TM>, 8 * TM, 0);
  if (err != cudaSuccess) return err;
  const long long tiles = (m + TM - 1) / TM;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  pfb64_kernel<TM><<<(unsigned)grid, 8 * TM, 0, stream>>>(
      iq, m, c0, Ko, carry_in, taps, tw, y, carry_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream`.  iq_u8: 2*m*K bytes, 2-byte aligned; carry_in
// and carry_out: distinct (2(R-1), K) f32; taps: (R, K) f32 branch filter
// G; tw: (K, 2) f32, exp(-2 pi i n / K) / 255, 8-byte aligned; y:
// (m, 2*Ko) f32 = columns [c0, c0 + Ko) of [Y_re | Y_im].  Returns 0 or the
// CUDA error of the launch.
int tsdr_pfb_channelize(const void* iq_u8, long long m, int K, int R, int c0,
                        int Ko, const float* carry_in, const float* taps,
                        const float* tw, float* y, float* carry_out,
                        void* stream) {
  if (m <= 0 || K <= 0 || K % 2 != 0 || R < 1 || Ko <= 0 || c0 < 0 ||
      c0 + Ko > K || ((uintptr_t)iq_u8 & 1) != 0 ||
      ((uintptr_t)tw & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uint16_t* iq = (const uint16_t*)iq_u8;
  const float2* tw2 = (const float2*)tw;
  cudaStream_t s = (cudaStream_t)stream;
  if (K == kFastK && R == kFastR) {
    int dev = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess) {
      return (int)err;
    }
    // 16-frame tiles where they give every SM two blocks, else 8
    if ((m + 15) / 16 >= 2LL * sms) {
      return (int)launch64<16>(iq, m, c0, Ko, carry_in, taps, tw2, y,
                               carry_out, sms, s);
    }
    return (int)launch64<8>(iq, m, c0, Ko, carry_in, taps, tw2, y,
                            carry_out, sms, s);
  }
  // direct path: tiles of up to 32 frames that fit the shared memory
  const size_t frame_bytes = 8 * (size_t)K;
  long long TM = (long long)((kDirectSmem - frame_bytes) / frame_bytes);
  if (TM > 32) TM = 32;
  if (TM < 1) {
    TM = (long long)((kMaxSmem - frame_bytes) / frame_bytes);
    if (TM < 1) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = frame_bytes * (size_t)(TM + 1);
  const long long grid = (m + TM - 1) / TM;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pfb_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pfb_direct_kernel<<<(unsigned)grid, kDirectThreads, smem, s>>>(
      iq, m, K, R, c0, Ko, (int)TM, carry_in, taps, tw2, y, carry_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
