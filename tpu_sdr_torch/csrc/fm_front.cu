// K1 — fused WBFM front end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_sdr/ops/pallas_fm.py `_kernel` (:177,
// launched by `_front_pallas` :617) in its broadcast-rotation form:
//
//   u8 I/Q (one little-endian int16 per complex sample: I low, Q high)
//   -> x = 2u - 255 (the "x255" scale: exact 9-bit integers)
//   -> fs/4 rotation, sample k times j**(k + phase)
//   -> 72-tap FIR decimating by 6: y[m] = sum_j w[j] x[6m - 71 + j]
//   -> discriminator z[m] = atan2(Im, Re)(y[m] conj(y[m-1])) / pi, with the
//      6-term minimax atan of the TPU kernel (_ATAN6_COEFFS).
//
// The taps w are the TPU kernel's split-bf16 weights summed in float32
// (W_hi + W_lo is exact in f32), so one f32 FMA per tap reproduces its
// filter.  Per decimated output the kernel reads 12 bytes and writes 4,
// against ~290 FLOP: on an H100 the HBM and f32-FMA floors are about equal
// (~10 us per 25 MB block), and the tensor cores are not needed.  This
// first form does direct FMA from shared memory.  Measured on an H100 80GB
// HBM3 at its 700 W limit, a 25 MB block takes ~0.11 ms, ~9% of either
// floor: the bound is neither, most likely shared-memory load issue (144
// loads per output, 2-way bank conflicts at the 6-word thread stride).
// Register-tiled windows or a banded tensor-core product are later work.
//
// Carries.  The TPU grid runs chunks in order and keeps the FIR history
// and the previous decimated sample in VMEM scratch.  Here thread blocks
// run in parallel, so each block stages its own input span plus a
// (L-1+decim)-sample halo read straight from the input (overlap-save) and
// recomputes the predecessor of its first output with one extra 72-tap
// dot.  Only block 0 reads the external carry, which keeps the TPU layout:
// a (4, 128) f32 array, rows 0/1 lanes [0, L-1) the rotated FIR history in
// the x255 scale (samples -(L-1)..-1), rows 2/3 the last 128 decimated
// samples (lane 127 is the discriminator's previous sample), other lanes
// passed through.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

// atan(t) ~= t * P(t^2) on [0, 1], 6-term equioscillating fit (9.9e-6 rad).
__device__ __forceinline__ float atan2_poly6(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float t = lo / (hi == 0.0f ? 1.0f : hi);
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
  if (y < 0.0f) r = -r;
  return (x == 0.0f && y == 0.0f) ? 0.0f : r;
}

// Sample k >= 0 of the block: unpack, centre to the x255 scale, rotate.
__device__ __forceinline__ void load_rotated(const uint16_t* __restrict__ iq,
                                             long long k, int phase,
                                             float* re, float* im) {
  const uint16_t v = iq[k];
  const float i = 2.0f * (float)(v & 0xFF) - 255.0f;
  const float q = 2.0f * (float)(v >> 8) - 255.0f;
  switch ((int)((k + phase) & 3)) {
    case 0: *re = i;  *im = q;  break;
    case 1: *re = -q; *im = i;  break;
    case 2: *re = -i; *im = -q; break;
    default: *re = q; *im = -i; break;
  }
}

// Shared memory: xr/xi [span] rotated input span, w [L] taps, yr/yi
// [blockDim] this block's decimated samples.  Smem index i holds sample
// k = m0*decim - H + i with H = L-1+decim; samples before the block come
// from the carry's FIR history (k in [-(L-1), 0)) or are unused (k < -(L-1),
// only block 0, whose first predecessor is the carried sample instead).
__global__ void fm_front_kernel(const uint16_t* __restrict__ iq, long long n,
                                int phase, const float* __restrict__ carry_in,
                                const float* __restrict__ taps, int L,
                                int decim, float* __restrict__ z,
                                float* __restrict__ carry_out) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int H = L - 1 + decim;
  const int span = B * decim + H;
  float* xr = smem;
  float* xi = xr + span;
  float* w = xi + span;
  float* yr = w + L;
  float* yi = yr + B;

  const long long M = n / decim;
  const long long m0 = (long long)blockIdx.x * B;
  const long long k0 = m0 * decim - H;

  for (int i = tid; i < span; i += B) {
    const long long k = k0 + i;
    float re = 0.0f, im = 0.0f;
    if (k >= 0 && k < n) {
      load_rotated(iq, k, phase, &re, &im);
    } else if (k < 0 && k >= -(long long)(L - 1)) {
      re = carry_in[0 * kLanes + (L - 1) + k];
      im = carry_in[1 * kLanes + (L - 1) + k];
    }
    xr[i] = re;
    xi[i] = im;
  }
  for (int j = tid; j < L; j += B) w[j] = taps[j];
  __syncthreads();

  // y[m] over samples [m*decim - (L-1), m*decim] = smem [tid*decim + decim, +L)
  const long long m = m0 + tid;
  const float* win_re = xr + tid * decim + decim;
  const float* win_im = xi + tid * decim + decim;
  float y_re = 0.0f, y_im = 0.0f;
  for (int j = 0; j < L; ++j) {
    y_re = fmaf(w[j], win_re[j], y_re);
    y_im = fmaf(w[j], win_im[j], y_im);
  }
  yr[tid] = y_re;
  yi[tid] = y_im;
  __syncthreads();

  if (m < M) {
    float b_re, b_im;
    if (tid > 0) {
      b_re = yr[tid - 1];
      b_im = yi[tid - 1];
    } else if (m0 == 0) {
      b_re = carry_in[2 * kLanes + kLanes - 1];
      b_im = carry_in[3 * kLanes + kLanes - 1];
    } else {  // predecessor from the halo: samples [m0*decim - H, +L)
      b_re = 0.0f;
      b_im = 0.0f;
      for (int j = 0; j < L; ++j) {
        b_re = fmaf(w[j], xr[j], b_re);
        b_im = fmaf(w[j], xi[j], b_im);
      }
    }
    const float c_re = y_re * b_re + y_im * b_im;
    const float c_im = y_im * b_re - y_re * b_im;
    z[m] = atan2_poly6(c_im, c_re) * 0.31830988618379067f;

    const long long lane = m - (M - kLanes);  // last 128 samples -> rows 2/3
    if (lane >= 0) {
      carry_out[2 * kLanes + lane] = y_re;
      carry_out[3 * kLanes + lane] = y_im;
    }
  }

  if (blockIdx.x == 0) {
    for (int l = tid; l < kLanes; l += B) {
      // rows 2/3 lanes left of the call's first sample (calls under 128
      // outputs): the old row, shifted by M
      if (l < kLanes - M) {
        carry_out[2 * kLanes + l] = carry_in[2 * kLanes + l + M];
        carry_out[3 * kLanes + l] = carry_in[3 * kLanes + l + M];
      }
      // rows 0/1: xext[n + l] of xext = [history (L-1) | block (n)]
      float re = carry_in[0 * kLanes + l], im = carry_in[1 * kLanes + l];
      if (l < L - 1) {
        const long long pos = n + l;
        if (pos < L - 1) {
          re = carry_in[0 * kLanes + pos];
          im = carry_in[1 * kLanes + pos];
        } else {
          load_rotated(iq, pos - (L - 1), phase, &re, &im);
        }
      }
      carry_out[0 * kLanes + l] = re;
      carry_out[1 * kLanes + l] = im;
    }
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream`.  iq_u8: 2n bytes (2-byte aligned); carry_in and
// carry_out: distinct (4, 128) f32; taps: L f32; z: n/decim f32.
// Returns 0 or the CUDA error of the launch.
int tsdr_fm_front(const void* iq_u8, long long n, int phase,
                  const float* carry_in, const float* taps, int num_taps,
                  int decim, float* z, float* carry_out, void* stream) {
  if (n <= 0 || decim <= 0 || n % decim != 0 || num_taps < 1 ||
      num_taps - 1 > kLanes || phase < 0 || phase > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const int block = 256;
  const long long M = n / decim;
  const long long grid = (M + block - 1) / block;
  const int H = num_taps - 1 + decim;
  const size_t smem =
      sizeof(float) * (2 * (size_t)(block * decim + H) + num_taps + 2 * block);
  if (smem > 48 * 1024 || grid > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  fm_front_kernel<<<(unsigned)grid, block, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)iq_u8, n, phase, carry_in, taps, num_taps, decim, z,
      carry_out);
  return (int)cudaGetLastError();
}

const char* tsdr_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
