// K3 — fused PFB channelizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_sdr/ops/pallas_channelizer.py
// `_kernel` (:92, launched by `channelize_fused` :161):
//
//   u8 I/Q (one little-endian int16 per complex sample: I low, Q high)
//   -> x = 2u - 255 (the "x255" scale: exact 9-bit integers), frames X (m, K)
//   -> Yr = X_win_re @ M2, Yi = X_win_im @ M2 with the frame windows
//      X_win[m, t*K + p] = X[m - t, p], t < R, and M2 = [M_re | M_im] / 255
//      (R*K, 2*Ko), the branch filter and channel DFT in one matrix
//   -> Y_re = Yr[:, :Ko] - Yi[:, Ko:],  Y_im = Yr[:, Ko:] + Yi[:, :Ko],
//      written as one (m, 2*Ko) f32 array [Y_re | Y_im].
//
// M2 is the TPU kernel's split-bf16 pair summed in f32 once, so one f32
// FMA per weight reproduces its two bf16 matmuls (the x255 samples are
// exact in bf16 and in f32).  Ko <= K selects a column block of M_re and
// M_im (channel-parallel sharding); Ko must be a multiple of 4.
//
// Bound.  Per frame the kernel reads 2K bytes and writes 8*Ko, against
// 2 * 2*R*K*Ko FMA (147,456 at K = Ko = 64, R = 9): ~576 FLOP per byte, so
// it is compute-bound on the f32 CUDA cores (~0.86 ms per 25 MB block at
// the 67 TFLOP/s peak, ~37 us for the bytes).  This first form is a
// register-tiled direct product from shared memory: each thread holds
// 4 frames x 4 channels of Y_re and Y_im (32 accumulators) and per M2 row
// loads 8 samples and 2 float4 weights for 64 FMA.  Tensor cores
// (split-bf16 wgmma), TMA and the factored 9-tap FIR + 64-point DFT
// (8.4x fewer multiply-adds) are later work.
//
// Carry.  The TPU grid runs chunks in order and keeps the last R-1 frames
// in VMEM.  Here thread blocks run in parallel, so each block stages its
// own frames plus an (R-1)-frame history read straight from the input;
// only the call's first R-1 frames read the external carry.  The carry
// keeps the TPU layout: (2H, K) f32, H = R-1, the last H input frames in
// the x255 scale, re rows then im rows.  Nothing is recomputed for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFramesPerThread = 4;
constexpr int kColsPerThread = 4;   // and their partners Ko columns right
constexpr int kRowsPerStage = 32;   // M2 rows staged in shared memory at once
constexpr int kMaxThreads = 256;
constexpr int kMaxFrameGroups = 16;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void unpack(uint16_t v, float* re, float* im) {
  *re = 2.0f * (float)(v & 0xFF) - 255.0f;
  *im = 2.0f * (float)(v >> 8) - 255.0f;
}

// Thread (fg, cg) of FG x CG computes frames m0 + fg + i*FG (i < 4) and
// channels 4cg..4cg+3.  Shared memory: w [kRowsPerStage * 2Ko] a stage of
// M2 rows (first, so its float4 reads stay 16-byte aligned); xr/xi
// [(TM + H) * KP] the block's frames m0-H .. m0+TM-1, KP = K+1 words a
// frame so that the frame groups of a warp read distinct banks.
__global__ void pfb_channelize_kernel(const uint16_t* __restrict__ iq,
                                      long long m, int K, int R, int Ko,
                                      const float* __restrict__ carry_in,
                                      const float* __restrict__ m2,
                                      float* __restrict__ y,
                                      float* __restrict__ carry_out) {
  extern __shared__ float4 smem4[];
  const int H = R - 1;
  const int KP = K + 1;
  const int CG = Ko / kColsPerThread;
  const int FG = blockDim.x / CG;
  const int TM = FG * kFramesPerThread;
  const int N2 = 2 * Ko;
  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int fg = tid / CG;
  float* w = reinterpret_cast<float*>(smem4);
  float* xr = w + kRowsPerStage * N2;
  float* xi = xr + (TM + H) * KP;

  const long long m0 = (long long)blockIdx.x * TM;
  for (int i = tid; i < (TM + H) * K; i += blockDim.x) {
    const int lf = i / K;
    const int p = i - lf * K;
    const long long f = m0 - H + lf;
    float re = 0.0f, im = 0.0f;
    if (f >= 0 && f < m) {
      unpack(iq[f * K + p], &re, &im);
    } else if (f < 0) {  // the call's first H frames' history: the carry
      re = carry_in[(H + f) * K + p];
      im = carry_in[(2 * H + f) * K + p];
    }
    xr[lf * KP + p] = re;
    xi[lf * KP + p] = im;
  }

  float acc_re[kFramesPerThread][kColsPerThread] = {};
  float acc_im[kFramesPerThread][kColsPerThread] = {};
  const int RK = R * K;
  const int frame_step = FG * KP;
  for (int j0 = 0; j0 < RK; j0 += kRowsPerStage) {
    const int rows = min(kRowsPerStage, RK - j0);
    __syncthreads();  // frames staged / the previous stage consumed
    const float4* src = reinterpret_cast<const float4*>(m2 + (long long)j0 * N2);
    for (int i = tid; i < rows * N2 / 4; i += blockDim.x) smem4[i] = src[i];
    __syncthreads();
    int t = j0 / K;
    int p = j0 - t * K;
    for (int jj = 0; jj < rows; ++jj) {
      // row j = t*K + p of M2 multiplies frame (output frame - t), channel p
      const int base = (fg + H - t) * KP + p;
      float a_re[kFramesPerThread], a_im[kFramesPerThread];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        a_re[i] = xr[base + i * frame_step];
        a_im[i] = xi[base + i * frame_step];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(w + jj * N2 + 4 * cg);
      const float4 b1 =
          *reinterpret_cast<const float4*>(w + jj * N2 + Ko + 4 * cg);
      const float c0[kColsPerThread] = {b0.x, b0.y, b0.z, b0.w};  // M_re
      const float c1[kColsPerThread] = {b1.x, b1.y, b1.z, b1.w};  // M_im
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          acc_re[i][c] = fmaf(a_re[i], c0[c], acc_re[i][c]);
          acc_re[i][c] = fmaf(-a_im[i], c1[c], acc_re[i][c]);
          acc_im[i][c] = fmaf(a_re[i], c1[c], acc_im[i][c]);
          acc_im[i][c] = fmaf(a_im[i], c0[c], acc_im[i][c]);
        }
      }
      if (++p == K) {
        p = 0;
        ++t;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const long long f = m0 + fg + i * FG;
    if (f < m) {
      float* row = y + f * N2;
      *reinterpret_cast<float4*>(row + 4 * cg) =
          make_float4(acc_re[i][0], acc_re[i][1], acc_re[i][2], acc_re[i][3]);
      *reinterpret_cast<float4*>(row + Ko + 4 * cg) =
          make_float4(acc_im[i][0], acc_im[i][1], acc_im[i][2], acc_im[i][3]);
    }
  }

  if (blockIdx.x == 0) {  // new carry: frames [m, m+H) of [carry | input]
    for (int i = tid; i < H * K; i += blockDim.x) {
      const int h = i / K;
      const int p = i - h * K;
      const long long pos = m + h;
      float re, im;
      if (pos < H) {
        re = carry_in[pos * K + p];
        im = carry_in[(H + pos) * K + p];
      } else {
        unpack(iq[(pos - H) * K + p], &re, &im);
      }
      carry_out[h * K + p] = re;
      carry_out[(H + h) * K + p] = im;
    }
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream`.  iq_u8: 2*m*K bytes (2-byte aligned); carry_in
// and carry_out: distinct (2(R-1), K) f32; m2: (R*K, 2*Ko) f32, 16-byte
// aligned; y: (m, 2*Ko) f32.  Returns 0 or the CUDA error of the launch.
int tsdr_pfb_channelize(const void* iq_u8, long long m, int K, int R, int Ko,
                        const float* carry_in, const float* m2, float* y,
                        float* carry_out, void* stream) {
  if (m <= 0 || K <= 0 || R < 1 || Ko <= 0 || Ko > K ||
      Ko % kColsPerThread != 0 || Ko / kColsPerThread > kMaxThreads ||
      ((uintptr_t)m2 & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int CG = Ko / kColsPerThread;
  int FG = kMaxThreads / CG;
  if (FG > kMaxFrameGroups) FG = kMaxFrameGroups;
  const int threads = FG * CG;
  const int TM = FG * kFramesPerThread;
  const size_t smem =
      sizeof(float) * ((size_t)kRowsPerStage * 2 * Ko +
                       2 * (size_t)(TM + R - 1) * (K + 1));
  const long long grid = (m + TM - 1) / TM;
  if (smem > kMaxSmem || grid > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      pfb_channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pfb_channelize_kernel<<<(unsigned)grid, threads, smem,
                          (cudaStream_t)stream>>>(
      (const uint16_t*)iq_u8, m, K, R, Ko, carry_in, m2, y, carry_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
