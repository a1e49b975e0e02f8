// K4 and K5 — shard-to-shard copies for Hopper (sm_90a).
//
// K4 replaces the Pallas TPU kernel tpu_sdr/parallel/pallas_halo.py
// `_halo_kernel` (:42, launched by `_pull_left_halo_remote_dma` :85 via
// `pull_left_halo_pallas` :108): the non-circular neighbour halo.  Along one
// row of shards, shard i receives the last `halo` bytes of shard i-1, and
// shard 0 receives the row's left edge (or zeros).  The last shard sends
// nothing.
//
// K5 replaces `_ring_kernel` (:145, launched by `ring_shift_pallas` :165):
// the circular shift.  Shard i's whole buffer lands on shard (i+1) % n; on
// a one-shard row that is a copy of the buffer to itself (out of place).
//
// The TPU kernels are remote DMAs over ICI with send and receive
// semaphores.  Here one process drives every device, so a copy kernel
// launched on the receiving device's stream reads each source through its
// pointer: in the same device's memory, or in a peer's over NVLink by
// unified addressing once `tsdr_enable_peer` has opened the pair.  CUDA
// events on the per-device streams (set by the Python wrapper) take the
// place of the semaphores: the receiving stream waits for an event recorded
// after the source was written, and the source's stream waits for the copy
// before it reuses the memory.
//
// One launch serves every receiving shard on one device: blockIdx.y picks
// the shard, and the source and destination pointers travel by value in
// the kernel's parameter struct (at most kMaxShards entries), so no pointer
// table is copied to the device per call.  The copy counts bytes, so any
// dtype works, with 16-byte vectors where both sides are 16-byte aligned
// (4-byte words, else bytes, otherwise); the result is bit-equal to a
// tensor copy.  A copy is bound by memory bandwidth at large payloads and
// by launch latency at the chain's 2 KB a station: this first form does
// nothing about the latter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 32;  // cuda_halo.MAX_SHARDS
constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 512;

struct CopyTable {
  const unsigned char* src[kMaxShards];  // null: fill with zeros
  unsigned char* dst[kMaxShards];
  long long nbytes;                      // the same for every entry
};

template <typename V>
__device__ __forceinline__ void copy_span(const unsigned char* __restrict__ src,
                                          unsigned char* __restrict__ dst,
                                          long long nbytes, long long i0,
                                          long long stride) {
  const long long nv = nbytes / (long long)sizeof(V);
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (long long i = i0; i < nv; i += stride) d[i] = s[i];
  for (long long i = nv * (long long)sizeof(V) + i0; i < nbytes; i += stride) {
    dst[i] = src[i];
  }
}

template <typename V>
__device__ __forceinline__ void zero_span(unsigned char* __restrict__ dst,
                                          long long nbytes, long long i0,
                                          long long stride) {
  const long long nv = nbytes / (long long)sizeof(V);
  V* d = reinterpret_cast<V*>(dst);
  const V z{};
  for (long long i = i0; i < nv; i += stride) d[i] = z;
  for (long long i = nv * (long long)sizeof(V) + i0; i < nbytes; i += stride) {
    dst[i] = 0;
  }
}

// grid (blocks_x, entries): block row y copies entry y, grid-striding over
// its bytes.
__global__ void shard_copy_kernel(const __grid_constant__ CopyTable t) {
  const int e = blockIdx.y;
  const unsigned char* src = t.src[e];
  unsigned char* dst = t.dst[e];
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if (src == nullptr) {
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      zero_span<uint4>(dst, t.nbytes, i0, stride);
    } else {
      zero_span<unsigned char>(dst, t.nbytes, i0, stride);
    }
  } else if ((align & 15) == 0) {
    copy_span<uint4>(src, dst, t.nbytes, i0, stride);
  } else if ((align & 3) == 0) {
    copy_span<uint32_t>(src, dst, t.nbytes, i0, stride);
  } else {
    copy_span<unsigned char>(src, dst, t.nbytes, i0, stride);
  }
}

int launch(const CopyTable& t, int entries, void* stream) {
  const long long per_block = (long long)kThreads * 16;
  long long bx = (t.nbytes + per_block - 1) / per_block;
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  shard_copy_kernel<<<dim3((unsigned)bx, (unsigned)entries), kThreads, 0,
                      (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4 on `stream`, for the receiving shards `receivers[0..n_recv)` of a row
// of `n_shards`, all on the stream's device.  x[i]: shard i's buffer of
// x_bytes[i] bytes; out[i]: shard i's halo_bytes-byte result (only the
// receivers' entries are read).  Receiver r > 0 gets the last halo_bytes of
// x[r-1]; receiver 0 gets left_edge (halo_bytes) or zeros when it is null.
// Returns 0 or a CUDA error.
int tsdr_halo_pull(int n_shards, const void* const* x, const long long* x_bytes,
                   long long halo_bytes, const void* left_edge,
                   void* const* out, const int* receivers, int n_recv,
                   void* stream) {
  if (n_shards < 1 || n_recv < 1 || n_recv > kMaxShards || halo_bytes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  CopyTable t;
  t.nbytes = halo_bytes;
  for (int e = 0; e < n_recv; ++e) {
    const int r = receivers[e];
    if (r < 0 || r >= n_shards || out[r] == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    if (r == 0) {
      t.src[e] = static_cast<const unsigned char*>(left_edge);
    } else {
      if (x[r - 1] == nullptr || x_bytes[r - 1] < halo_bytes) {
        return (int)cudaErrorInvalidValue;
      }
      t.src[e] = static_cast<const unsigned char*>(x[r - 1]) +
                 (x_bytes[r - 1] - halo_bytes);
    }
    t.dst[e] = static_cast<unsigned char*>(out[r]);
  }
  return launch(t, n_recv, stream);
}

// K5 on `stream`: receiver r of `receivers[0..n_recv)` gets all nbytes of
// x[(r - 1 + n_shards) % n_shards] in out[r].  Returns 0 or a CUDA error.
int tsdr_ring_shift(int n_shards, const void* const* x, long long nbytes,
                    void* const* out, const int* receivers, int n_recv,
                    void* stream) {
  if (n_shards < 1 || n_recv < 1 || n_recv > kMaxShards || nbytes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  CopyTable t;
  t.nbytes = nbytes;
  for (int e = 0; e < n_recv; ++e) {
    const int r = receivers[e];
    if (r < 0 || r >= n_shards || out[r] == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    const int s = (r - 1 + n_shards) % n_shards;
    if (x[s] == nullptr) return (int)cudaErrorInvalidValue;
    t.src[e] = static_cast<const unsigned char*>(x[s]);
    t.dst[e] = static_cast<unsigned char*>(out[r]);
  }
  return launch(t, n_recv, stream);
}

// Lets device `dev` read device `peer`'s memory.  Returns 0 when the pair
// is open (or dev == peer), cudaErrorPeerAccessUnsupported when the two
// cannot reach each other, or the CUDA error of a call (an unknown device).
// A failed call's error is cleared from the runtime, so that a later
// launch's cudaGetLastError does not report it.  The calling thread's
// current device is left as it was.
int tsdr_enable_peer(int dev, int peer) {
  if (dev == peer) return 0;
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e == cudaSuccess && !can) e = cudaErrorPeerAccessUnsupported;
  int prev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&prev);
  if (e == cudaSuccess) {
    e = cudaSetDevice(dev);
    if (e == cudaSuccess) {
      e = cudaDeviceEnablePeerAccess(peer, 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) e = cudaSuccess;
      const cudaError_t back = cudaSetDevice(prev);
      if (e == cudaSuccess) e = back;
    }
  }
  cudaGetLastError();  // clear what a failed (non-sticky) call recorded
  return (int)e;
}

}  // extern "C"
