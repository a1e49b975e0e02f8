// The halo record of a time shard, for Hopper (sm_90a).
//
// Not a TPU kernel: it stands for the XLA code of the JAX sharded chain
// that builds each shard's end-of-shard carry and the payload of its
// ppermute (tpu_sdr/parallel/wbfm_sharded_pallas.py `shard_fn` :137-149,
// and `resample_shard`'s halo, which JAX takes from the demodulated
// output).  Both depend only on the shard's last `tail` raw samples, so one
// launch builds them for every (shard, station) of a row on one device,
// before K1 runs, and one K4 launch ships them.
//
// Per (shard, station) the record (`record` floats) holds:
//   [0, 512)   the (4, 128) K1 carry at the end of the shard: rows 0/1 the
//              fs/4-rotated last L-1 samples in the x255 scale, rows 2/3
//              lane 127 the dot of the last FIR window with the reversed
//              design taps, / 255 (the JAX chain's formula);
//   [512, 512 + T - 1)  the shard's last T-1 discriminator outputs, from
//              its last T decimated samples (K1's effective taps) and the
//              6-term atan of K1, the resampler's halo;
//   the rest   zeros (the record is padded to 16 bytes).
// The tail starts at a local sample index 0 mod 4 (a shard is a whole
// number of 4-sample groups), so sample k rotates by k % 4.
//
// Grid (shards, stations), one block each: the tail's bytes become rotated
// floats in shared memory, the taps follow, each of 2T + 2 threads takes
// one f32 FMA dot (T decimated samples re and im, the two end-state dots),
// then the block writes the record.  At the chain's 2 KB a record the work
// is a few microseconds of launch: the kernel exists to fold the dozens of
// small tensor operations of the plain version into one launch a device.
// The pointers of the shards travel by value in the kernel's parameter
// struct (at most kMaxShards), as in K4's CopyTable.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 32;  // shard_halo.MAX_SHARDS
constexpr int kThreads = 128;
constexpr int kLanes = 128;     // fused_fm.LANES
constexpr int kRows = 4;        // fused_fm.STATE_ROWS

// 6-term fit of atan(t)/t on [0, 1] (fused_fm.ATAN6_COEFFS)
__device__ __forceinline__ float atan2_poly6(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float t = lo / (hi == 0.0f ? 1.0f : hi);
  const float s = t * t;
  float p = -1.3883453812e-02f;
  p = p * s + 5.8200158710e-02f;
  p = p * s + -1.2155903309e-01f;
  p = p * s + 1.9558953030e-01f;
  p = p * s + -3.3295015732e-01f;
  p = p * s + 9.9999125472e-01f;
  float r = p * t;
  if (ay > ax) r = 1.57079632679489662f - r;
  if (x < 0.0f) r = 3.14159265358979324f - r;
  if (y < 0.0f) r = -r;
  return (x == 0.0f && y == 0.0f) ? 0.0f : r;
}

struct TailTable {
  const unsigned char* tail[kMaxShards];  // station 0's tail of each shard
};

struct HaloArgs {
  long long row_bytes;  // bytes of one station's row of a shard
  const float* taps;    // K1's effective taps (L), for the decimated samples
  const float* end_taps;  // the design taps reversed (L), for the end state
  int tail, L, decim, T, record;
  float* out;           // (shards, stations, record)
};

__global__ void __launch_bounds__(kThreads)
shard_halo_kernel(const __grid_constant__ TailTable t, const HaloArgs a) {
  extern __shared__ float smem[];
  float* re = smem;            // tail
  float* im = re + a.tail;     // tail
  float* tp = im + a.tail;     // L
  float* etp = tp + a.L;       // L
  float* y = etp + a.L;        // 2T + 2: y_re, y_im, end_re, end_im
  const int shard = blockIdx.x, station = blockIdx.y;
  const unsigned char* src =
      t.tail[shard] + (long long)station * a.row_bytes;
  for (int k = threadIdx.x; k < a.tail; k += blockDim.x) {
    const float i = 2.0f * (float)src[2 * k] - 255.0f;
    const float q = 2.0f * (float)src[2 * k + 1] - 255.0f;
    float r, m;  // j^(k % 4) (i + jq)
    switch (k & 3) {
      case 0: r = i; m = q; break;
      case 1: r = -q; m = i; break;
      case 2: r = -i; m = -q; break;
      default: r = q; m = -i; break;
    }
    re[k] = r;
    im[k] = m;
  }
  for (int k = threadIdx.x; k < a.L; k += blockDim.x) {
    tp[k] = a.taps[k];
    etp[k] = a.end_taps[k];
  }
  __syncthreads();

  // dot w: w < 2T the decimated sample w % T (re, then im), whose window
  // starts at y0 + decim r; then the two end-state dots on the last window
  const int y0 = a.tail - a.decim * a.T - (a.L - 1);
  const int w_end = a.tail - a.decim - (a.L - 1);
  for (int w = threadIdx.x; w < 2 * a.T + 2; w += blockDim.x) {
    const bool end = w >= 2 * a.T;
    const int comp = end ? w - 2 * a.T : w / a.T;
    const float* x = (comp ? im : re) + (end ? w_end : y0 + a.decim * (w % a.T));
    const float* h = end ? etp : tp;
    float acc = 0.0f;
    for (int k = 0; k < a.L; ++k) acc = fmaf(x[k], h[k], acc);
    y[w] = end ? acc / 255.0f : acc;
  }
  __syncthreads();

  float* rec = a.out + ((long long)shard * gridDim.y + station) * a.record;
  const int hist0 = a.tail - (a.L - 1);
  const float inv_pi = 0.318309886183790672f;
  for (int idx = threadIdx.x; idx < a.record; idx += blockDim.x) {
    float v = 0.0f;
    if (idx < kRows * kLanes) {
      const int row = idx / kLanes, lane = idx % kLanes;
      if (row < 2) {
        if (lane < a.L - 1) v = (row ? im : re)[hist0 + lane];
      } else if (lane == kLanes - 1) {
        v = y[2 * a.T + row - 2];
      }
    } else if (idx < kRows * kLanes + a.T - 1) {
      // the discriminator: angle(y[i+1] conj(y[i])) / pi
      const int i = idx - kRows * kLanes;
      const float br = y[i], bi = y[a.T + i];
      const float cr = y[i + 1], ci = y[a.T + i + 1];
      v = atan2_poly6(ci * br - cr * bi, cr * br + ci * bi) * inv_pi;
    }
    rec[idx] = v;
  }
}

}  // namespace

extern "C" {

// The halo records of `n_shards` shards on `stream`'s device.  shards[e]:
// shard e's (stations, row_bytes) u8 I/Q, row-major; its tail is the last
// 2 * tail bytes of each station's row.  out: (n_shards, stations, record)
// f32.  Returns 0 or a CUDA error (cudaErrorInvalidValue for a table of more
// than kMaxShards shards or shapes the record cannot hold).
int tsdr_shard_halo(int n_shards, const void* const* shards, int stations,
                    long long row_bytes, int tail, const float* taps,
                    const float* end_taps, int L, int decim, int T,
                    int record, float* out, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || stations < 1 ||
      stations > 65535 || tail < 1 || tail % 4 || L < 1 || L - 1 > kLanes ||
      decim < 1 || T < 2 || tail - decim * T - (L - 1) < 0 ||
      row_bytes < 2LL * tail || record < kRows * kLanes + T - 1 ||
      taps == nullptr || end_taps == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  TailTable t;
  for (int e = 0; e < n_shards; ++e) {
    if (shards[e] == nullptr) return (int)cudaErrorInvalidValue;
    t.tail[e] = static_cast<const unsigned char*>(shards[e]) + row_bytes -
                2LL * tail;
  }
  HaloArgs a{row_bytes, taps, end_taps, tail, L, decim, T, record, out};
  const size_t smem = sizeof(float) * (2 * tail + 2 * L + 2 * T + 2);
  cudaError_t err = cudaFuncSetAttribute(
      shard_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  shard_halo_kernel<<<dim3((unsigned)n_shards, (unsigned)stations), kThreads,
                      smem, (cudaStream_t)stream>>>(t, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
