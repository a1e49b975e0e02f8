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
// Bound.  A 25 MB block's z (2,088,960 f32, 8.4 MB) in and 1.6 MB of audio
// out: 2.96 us at 3.35 TB/s against 0.56 us of f32 FMA, so the work is
// getting bytes in flight.  The first port's form (one output a thread, a
// 48-deep dependent FMA chain with two shared-memory loads an FMA, 1,536
// short blocks each re-staging the bank) took 0.027 ms.
//
// Design (default 16/85, T = 48; other shapes run the same structure with
// runtime bounds).  Blocks are persistent: each stages the bank once into
// shared memory and walks tiles of 128 frames, the next tile's input span
// in flight by cp.async 16-byte copies (two buffers) while the current one
// is computed.  Four threads share a frame, each owning 4 consecutive
// phases: 4 independent accumulators over the part of the frame's window
// those phases reach (~64 samples), read from shared memory once (a warp's
// lanes are 32 frames, 85 floats apart: no bank conflicts), and the bank
// read as float4 broadcasts (a warp's phases are uniform) from rows laid
// out so that four consecutive samples meet four consecutive taps (every
// row reversed, offset by o_s mod 4, zero-padded).  Each thread writes one
// float4 of the frame-major output; 16 warps a block keep the SM busy.
//
// A 25 MB block is 192 tiles, one wave of blocks: each block takes one
// tile, so the walk and the second buffer engage only on longer inputs.
// Measured (PERF.md; chip_variants.py): making blocks walk 2 to 4 tiles of
// this block (fewer blocks, or 32-frame tiles) is no faster or slower, and
// so was a form whose warps each waited only for their own 32 frames' part
// of the span.  A device-to-device copy of the same 9.9 MB, and K2 with
// its arithmetic taken out, each take most of K2's time as a lone launch:
// what bounds it is the memory system at this size (one wave, ~3 us of
// bytes) and a launch's fixed cost, not its arithmetic.  Fusing K2 into K1's epilogue (z never leaving the
// SM) removes its launch and its reads.
//
// Stations.  One launch runs a batch of stations (JAX vmaps the resampler
// over them): blockIdx.y is the station, whose z, history, audio and new
// history rows sit at strides of their own (the sharded chain's histories
// are slices of its halo records); a station's blocks split one wave of
// the card with the others, and block x = 0 of each writes that station's
// history.  One station runs a form of the kernel that takes its rows
// where the arguments put them: the per-station offsets cost a lone
// launch of one station ~20% (chip_variants.py's fm_resample/batch_form).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUp = 16, kDown = 85, kTaps = 48;   // the fast form
constexpr int kRow = 60;            // padded bank row: u in [-4, 56)
constexpr int kWindow = 128;        // samples a frame reads, rounded to 4

struct ResampleArgs {
  const float* z;
  long long z_stride;         // floats from one station's z row to the next
  long long n_z;              // z samples a station
  const float* hist;
  long long hist_stride;
  const float* h_poly;
  float* audio;
  long long audio_stride;
  float* hist_out;
  long long hist_out_stride;
  long long frames;
  int up, down, T;
  int tile;        // frames a tile (fast form: a quarter of the threads)
  int span;        // floats staged a tile, a multiple of 4
  int bank;        // floats of the bank in shared memory
};

// One station's part of a launch (blockIdx.y): its rows, at strides of
// their own, and the audio row's alignment.
struct Row {
  const float* z;
  const float* hist;
  float* audio;
  float* hist_out;
  bool out16;      // audio is 16-byte aligned
};

__host__ __device__ constexpr int o_of(int s) { return (s * kDown) / kUp; }
__host__ __device__ constexpr int p_of(int s) { return (s * kDown) % kUp; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ float xe_at(const ResampleArgs& a, const Row& row,
                                      long long e) {
  if (e < 0) return 0.0f;
  if (e < a.T - 1) return row.hist[e];
  const long long k = e - (a.T - 1);
  return k < a.n_z ? row.z[k] : 0.0f;
}

// Element offset of tile `t`'s first staged float: its xe index is
// r0*down - shift, chosen so that z's global address is 16-byte aligned
// at every multiple of 4 in shared memory.
__device__ __forceinline__ int tile_shift(const ResampleArgs& a, const Row& row,
                                          long long t) {
  const long long e0 = t * a.tile * a.down;
  const long long word = ((long long)((uintptr_t)row.z >> 2)) + e0 - (a.T - 1);
  return (int)(word & 3);
}

// Stage tile t's span into buf: 16-byte cp.async where the four floats
// are all of z, else one by one (the history, the stream's end).
__device__ void issue(const ResampleArgs& a, const Row& row, long long t,
                      float* buf) {
  const int shift = tile_shift(a, row, t);
  const long long e0 = t * a.tile * a.down - shift;
  for (int j = 4 * threadIdx.x; j < a.span; j += 4 * blockDim.x) {
    const long long k = e0 + j - (a.T - 1);  // z index of buf[j]
    if (k >= 0 && k + 4 <= a.n_z) {
      cp_async16(buf + j, row.z + k);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) buf[j + q] = xe_at(a, row, e0 + j + q);
    }
  }
}

// Outputs 4Q..4Q+3 of the frame whose window starts at x: the window's
// samples i meet bank columns u = i - o_s, four at a time; blocks no
// output of the quad reaches are dropped at compile time.
template <int Q>
__device__ __forceinline__ float4 frame_quad(const float* x,
                                             const float* bank) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kWindow; i += 4) {
    if (i + 3 >= o_of(4 * Q) && i < o_of(4 * Q + 3) + kTaps) {
      const float x0 = x[i], x1 = x[i + 1], x2 = x[i + 2], x3 = x[i + 3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = 4 * Q + q;
        const int u0 = i - o_of(s);  // x[i + j] meets u = u0 + j
        if (u0 + 3 >= 0 && u0 < kTaps) {
          const float4 w = *reinterpret_cast<const float4*>(
              bank + s * kRow + u0 + 4 + (o_of(s) & 3));
          acc[q] = fmaf(w.x, x0, acc[q]);
          acc[q] = fmaf(w.y, x1, acc[q]);
          acc[q] = fmaf(w.z, x2, acc[q]);
          acc[q] = fmaf(w.w, x3, acc[q]);
        }
      }
    }
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// Fast form: 4 threads a frame (warp w computes outputs 4(w%4)..+3 of 32
// frames); generic form: a thread a frame.  BATCH: blockIdx.y is the
// station, its rows at their strides; else one station's rows.
template <bool FAST, bool BATCH>
__global__ void __launch_bounds__(512, 2)
fm_resample_kernel(const __grid_constant__ ResampleArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* bank = smem;
  float* bufs = smem + a.bank;  // two tiles of a.span floats
  const int tid = threadIdx.x;
  const long long st = BATCH ? blockIdx.y : 0;
  Row row;
  row.z = a.z + st * a.z_stride;
  row.hist = a.hist + st * a.hist_stride;
  row.audio = a.audio + st * a.audio_stride;
  row.hist_out = a.hist_out + st * a.hist_out_stride;
  row.out16 = ((uintptr_t)row.audio % 16) == 0;
  const long long tiles = (a.frames + a.tile - 1) / a.tile;
  long long t = blockIdx.x;
  if (t < tiles) issue(a, row, t, bufs);
  asm volatile("cp.async.commit_group;\n" ::);

  // the bank, once: fast form rows g_s[u] = h[p_s][47 - u] at column
  // u + 4 + (o_s & 3), zero elsewhere; generic form h_poly as it is
  if constexpr (FAST) {
    for (int i = tid; i < kUp * kRow; i += blockDim.x) {
      const int s = i / kRow, v = i % kRow;
      const int u = v - 4 - (o_of(s) & 3);
      bank[i] = (u >= 0 && u < kTaps) ? a.h_poly[p_of(s) * kTaps + kTaps - 1 - u]
                                      : 0.0f;
    }
  } else {
    for (int i = tid; i < a.up * a.T; i += blockDim.x) bank[i] = a.h_poly[i];
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < a.T - 1; i += blockDim.x) {
      const long long e = a.n_z + i;
      row.hist_out[i] = e < a.T - 1 ? row.hist[e] : row.z[e - (a.T - 1)];
    }
  }

  const int f = FAST ? (tid >> 7 << 5) | (tid & 31) : tid;  // frame of tile
  const int quad = (tid >> 5) & 3;
  int cur = 0;
  for (; t < tiles; t += gridDim.x, cur ^= 1) {
    if (t + gridDim.x < tiles) {
      issue(a, row, t + gridDim.x, bufs + (cur ^ 1) * a.span);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    const long long r = t * a.tile + f;
    if (f < a.tile && r < a.frames) {
      const float* x = bufs + cur * a.span + tile_shift(a, row, t) + f * a.down;
      if constexpr (FAST) {
        float4 v;
        switch (quad) {
          case 0: v = frame_quad<0>(x, bank); break;
          case 1: v = frame_quad<1>(x, bank); break;
          case 2: v = frame_quad<2>(x, bank); break;
          default: v = frame_quad<3>(x, bank); break;
        }
        float* out = row.audio + r * kUp + 4 * quad;
        if (row.out16) {
          *reinterpret_cast<float4*>(out) = v;
        } else {
          out[0] = v.x;
          out[1] = v.y;
          out[2] = v.z;
          out[3] = v.w;
        }
      } else {
        for (int s = 0; s < a.up; ++s) {
          const int o = (int)(((long long)s * a.down) / a.up);
          const int p = (int)(((long long)s * a.down) % a.up);
          const float* h = bank + p * a.T;
          const float* xs = x + (a.T - 1) + o;
          float acc = 0.0f;
          for (int k = 0; k < a.T; ++k) acc = fmaf(h[k], xs[-k], acc);
          row.audio[r * a.up + s] = acc;
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <bool FAST, bool BATCH>
int launch(const ResampleArgs& a, int stations, size_t smem,
           cudaStream_t stream) {
  auto kernel = fm_resample_kernel<FAST, BATCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = FAST ? 4 * a.tile : (a.tile + 31) / 32 * 32;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess) {
    return (int)err;
  }
  const long long tiles = (a.frames + a.tile - 1) / a.tile;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // one wave over the whole launch: the stations share it
  grid = (grid + stations - 1) / stations;
  if (grid > tiles) grid = tiles;
  kernel<<<dim3((unsigned)grid, (unsigned)stations), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K2 on `stream` over `stations` rows: station s reads n_z f32
// (n_z % down == 0) at z + s*z_stride and T-1 at hist + s*hist_stride, and
// writes n_z/down*up f32 at audio + s*audio_stride and T-1 at hist_out +
// s*hist_out_stride (hist_out rows distinct from the hist rows); h_poly:
// (up, T) f32.  Returns 0 or the CUDA error of the launch.
int tsdr_fm_resample_batch(const float* z, long long z_stride, int stations,
                           long long n_z, const float* hist,
                           long long hist_stride, const float* h_poly, int up,
                           int down, int T, float* audio,
                           long long audio_stride, float* hist_out,
                           long long hist_out_stride, void* stream) {
  if (n_z <= 0 || up <= 0 || down <= 0 || T < 1 || n_z % down != 0 ||
      stations < 1 || stations > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  ResampleArgs a;
  a.z = z;
  a.z_stride = z_stride;
  a.n_z = n_z;
  a.hist = hist;
  a.hist_stride = hist_stride;
  a.h_poly = h_poly;
  a.audio = audio;
  a.audio_stride = audio_stride;
  a.hist_out = hist_out;
  a.hist_out_stride = hist_out_stride;
  a.frames = n_z / down;
  a.up = up;
  a.down = down;
  a.T = T;
  const bool fast = up == kUp && down == kDown && T == kTaps;
  a.bank = fast ? kUp * kRow : (up * T + 3) / 4 * 4;
  const size_t kBudget = 200 * 1024;
  for (int tile = 128; tile >= 1; tile >>= 1) {
    // the window of the tile's last frame, the shift, 4-float rounding
    const long long span = ((long long)tile * down + (fast ? kWindow : T - 1 + down) + 3 + 3) / 4 * 4;
    const size_t smem = sizeof(float) * ((size_t)a.bank + 2 * (size_t)span);
    if (smem > kBudget) continue;
    a.tile = tile;
    a.span = (int)span;
    cudaStream_t s = (cudaStream_t)stream;
    if (stations > 1) {
      return fast ? launch<true, true>(a, stations, smem, s)
                  : launch<false, true>(a, stations, smem, s);
    }
    return fast ? launch<true, false>(a, stations, smem, s)
                : launch<false, false>(a, stations, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches K2 on one station: the batch entry with one row.  z: n_z f32
// (n_z % down == 0, 4-byte aligned); hist and hist_out: distinct T-1 f32;
// audio: n_z/down*up f32.
int tsdr_fm_resample(const float* z, long long n_z, const float* hist,
                     const float* h_poly, int up, int down, int T,
                     float* audio, float* hist_out, void* stream) {
  return tsdr_fm_resample_batch(z, 0, 1, n_z, hist, 0, h_poly, up, down, T,
                                audio, 0, hist_out, 0, stream);
}

}  // extern "C"
