// K2 — 16/85 polyphase audio resampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_sdr/ops/pallas_fm.py `_resample_kernel`
// (:760, launched by `pallas_resample` :780), the twin of the frame-matmul
// resampler `fm.aligned_resample`.  With xe = [T-1 history | z] and frames
// of `down` discriminator samples, output s of frame r is
//
//   audio[r*up + s] = sum_t h_poly[p_s, t] * xe[r*down + (T-1) + o_s - t],
//   o_s = (s*down) / up,  p_s = (s*down) % up,
//
// frame-major, exactly the order of the TPU kernel and aligned_resample.
// The new history is xe's last T-1 samples.
//
// The TPU form multiplies (frames, down+T-1) by a mostly-zero (387, 64)
// matrix in three bf16 passes; here each thread computes one output as a
// T-term f32 dot, 48 FMA per 4 bytes written, reading 85/16 ≈ 5.3 input
// floats per output, so its floor is memory bandwidth.  A block stages its
// frames' input span and the (up, T) filter bank in shared memory; the
// bank's rows are padded to an odd stride so the 16 phases of a warp fall
// in different banks.  Measured on an H100 80GB HBM3 at its 700 W limit, a
// 25 MB block's z (8.4 MB) takes ~0.027 ms, ~11% of HBM bandwidth: the
// 48-deep dependent FMA chain per thread is the likely bound, and at the
// CLI's 262 KB reads only 16 blocks run (launch- and occupancy-bound).
// Fusing this stage into K1's output, so z never reaches device memory, is
// later work.

#include <cuda_runtime.h>

namespace {

// blockDim.x = up * frames per block; thread (f, s) computes frame r0+f,
// output s.
__global__ void fm_resample_kernel(const float* __restrict__ z, long long n_z,
                                   const float* __restrict__ hist,
                                   const float* __restrict__ h_poly, int up,
                                   int down, int T, float* __restrict__ audio,
                                   float* __restrict__ hist_out) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int frames_per_block = B / up;
  const int stride = T | 1;  // odd row stride: no bank conflicts across phases
  float* hp = smem;
  float* xs = hp + up * stride;
  const int span = frames_per_block * down + T - 1;

  const long long frames = n_z / down;
  const long long r0 = (long long)blockIdx.x * frames_per_block;

  for (int i = tid; i < up * T; i += B) {
    hp[(i / T) * stride + i % T] = h_poly[i];
  }
  for (int i = tid; i < span; i += B) {
    const long long e = r0 * down + i;  // index into xe
    float v = 0.0f;
    if (e < T - 1) {
      v = hist[e];
    } else if (e - (T - 1) < n_z) {
      v = z[e - (T - 1)];
    }
    xs[i] = v;
  }
  __syncthreads();

  const int f = tid / up;
  const int s = tid - f * up;
  const long long r = r0 + f;
  if (f < frames_per_block && r < frames) {
    const int o = (s * down) / up;
    const int p = (s * down) % up;
    const float* x = xs + f * down + (T - 1) + o;
    const float* h = hp + p * stride;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) acc = fmaf(h[t], x[-t], acc);
    audio[r * up + s] = acc;
  }

  if (blockIdx.x == gridDim.x - 1) {
    for (int i = tid; i < T - 1; i += B) {
      const long long e = n_z + i;
      hist_out[i] = e < T - 1 ? hist[e] : z[e - (T - 1)];
    }
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`.  z: n_z f32 (n_z % down == 0); hist and
// hist_out: distinct T-1 f32; h_poly: (up, T) f32; audio: n_z/down*up f32.
// Returns 0 or the CUDA error of the launch.
int tsdr_fm_resample(const float* z, long long n_z, const float* hist,
                     const float* h_poly, int up, int down, int T,
                     float* audio, float* hist_out, void* stream) {
  if (n_z <= 0 || up <= 0 || down <= 0 || T < 1 || n_z % down != 0 ||
      up > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const int frames_per_block = 256 / up;
  const int block = frames_per_block * up;
  const long long frames = n_z / down;
  const long long grid = (frames + frames_per_block - 1) / frames_per_block;
  const size_t smem =
      sizeof(float) * ((size_t)up * (T | 1) + frames_per_block * down + T - 1);
  if (smem > 48 * 1024 || grid > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  fm_resample_kernel<<<(unsigned)grid, block, smem, (cudaStream_t)stream>>>(
      z, n_z, hist, h_poly, up, down, T, audio, hist_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
