// tpusdr_io — native host-side runtime of the PyTorch/CUDA port
// (tpu_sdr_torch): the port's own copy of csrc/tpusdr_io.cpp, with the same
// C ABI.  It is host C++ (g++, no nvcc) and no GPU kernel.
//
// The reference implements its entire sample-acquisition runtime in native
// code (Rust): a blocking reader thread feeding a bounded channel
// (examples/simple_fm.rs:55-132) and an rtl_tcp server with a bounded
// 500-block queue (examples/rtl_tcp.rs:24,365).  This module is the port's
// native equivalent: a fixed-block ring buffer with backpressure + drop
// accounting, a file/socket reader pump thread, and the hot byte-path
// conversions (u8 I/Q -> planar f32 with fs/4 rotation, f32 -> s16 PCM,
// test-pattern continuity checking) that sit on the host side of the
// host->GPU boundary.  tsdr_ring_pop writes into a caller's buffer, so a
// consumer can pop straight into pinned (page-locked) host memory.
//
// Exposed as a plain C ABI for ctypes.  Built with TSDR_PYTHON (where the
// interpreter's headers are found), the same library is also the CPython
// module `_tpusdr_io`, whose f32_to_s16 takes a buffer-protocol object.

#ifdef TSDR_PYTHON
#define PY_SSIZE_T_CLEAN
#include <Python.h>  // first, as the C API asks
#endif

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>

#include <poll.h>
#include <unistd.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Fixed-block ring buffer (bounded queue semantics of rtl_tcp.rs:365)
// ---------------------------------------------------------------------------

// The slots in [tail, tail + count) are filled; the rest are free.  A block
// is copied into or out of its slot with `mu` released (a 25 MB block's
// memcpy must not stall the other side): the producer writes only the free
// slot at `head`, the consumer reads only the filled slot at `tail`, and
// each publishes its slot under `mu` once the copy is done.  Consumers take
// turns on `pop_mu`.  A ring with a pump has one producer, its pump.
struct Ring {
    uint8_t* arena = nullptr;
    size_t block_bytes = 0;
    size_t capacity = 0;  // blocks
    size_t head = 0;      // next write slot
    size_t tail = 0;      // next read slot
    size_t count = 0;     // filled blocks
    uint64_t dropped = 0;
    bool eof = false;
    std::mutex mu;
    std::timed_mutex pop_mu;          // one consumer copies out at a time
    std::condition_variable cv_push;  // signalled when a slot frees up
    std::condition_variable cv_pop;   // signalled when a block (or EOF) arrives
};

struct Pump {
    Ring* ring = nullptr;
    int fd = -1;
    bool loop_file = false;
    bool block_on_full = false;
    std::atomic<bool> stop{false};
    std::thread thread;
    uint64_t blocks_read = 0;
};

// Read one whole block from the pump's fd into dst: true, or false at the
// end of the stream (EOF without loop replay, an error, or a stop).
bool read_block(Pump* p, uint8_t* dst, size_t n) {
    size_t got = 0;
    while (got < n) {
        ssize_t k = ::read(p->fd, dst + got, n - got);
        if (k > 0) {
            got += static_cast<size_t>(k);
        } else if (k == 0) {
            if (p->loop_file && ::lseek(p->fd, 0, SEEK_SET) == 0) continue;
            return false;  // EOF / unseekable: end of stream
        } else {
            if (errno == EINTR) continue;
            if (errno != EAGAIN && errno != EWOULDBLOCK) return false;
            // Non-blocking fd (e.g. a Python socket with a timeout set):
            // wait for readability instead of treating the stall as EOF.
            struct pollfd pfd{p->fd, POLLIN, 0};
            ::poll(&pfd, 1, 100);
        }
        if (p->stop.load(std::memory_order_relaxed)) return false;
    }
    return true;
}

// The pump reads straight into the free slot at `head` (no bounce buffer,
// no copy under the lock).  With `block_on_full` it waits for a free slot
// before it reads; a live source finding the ring full reads into
// `overrun` and drops that block if the ring is still full (drop-newest,
// like the reference feeder counts lost samples rather than stalling the
// radio).
void pump_main(Pump* p) {
    Ring* r = p->ring;
    const size_t n = r->block_bytes;
    uint8_t* overrun = new uint8_t[n];
    while (!p->stop.load(std::memory_order_relaxed)) {
        uint8_t* dst;
        {
            std::unique_lock<std::mutex> lk(r->mu);
            if (p->block_on_full) {
                r->cv_push.wait(lk, [&] {
                    return r->count < r->capacity ||
                           p->stop.load(std::memory_order_relaxed);
                });
                if (p->stop.load(std::memory_order_relaxed)) break;
            }
            dst = r->count < r->capacity ? r->arena + r->head * n : overrun;
        }
        if (!read_block(p, dst, n)) break;
        {
            std::lock_guard<std::mutex> lk(r->mu);
            if (dst == overrun) {
                if (r->count == r->capacity) {
                    r->dropped++;
                    continue;
                }
                std::memcpy(r->arena + r->head * n, overrun, n);  // room came
            }
            r->head = (r->head + 1) % r->capacity;
            r->count++;
            p->blocks_read++;
        }
        r->cv_pop.notify_one();
    }
    delete[] overrun;
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->eof = true;
    }
    r->cv_pop.notify_all();
}

}  // namespace

extern "C" {

// -- ring ------------------------------------------------------------------

Ring* tsdr_ring_create(size_t block_bytes, size_t capacity) {
    if (block_bytes == 0 || capacity == 0) return nullptr;
    Ring* r = new Ring();
    r->arena = new uint8_t[block_bytes * capacity];
    r->block_bytes = block_bytes;
    r->capacity = capacity;
    return r;
}

void tsdr_ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->arena;
    delete r;
}

// 0 = stored, -1 = dropped (full), non-blocking.
int tsdr_ring_push(Ring* r, const uint8_t* src) {
    {
        std::lock_guard<std::mutex> lk(r->mu);
        if (r->count == r->capacity) {
            r->dropped++;
            return -1;
        }
        std::memcpy(r->arena + r->head * r->block_bytes, src, r->block_bytes);
        r->head = (r->head + 1) % r->capacity;
        r->count++;
    }
    r->cv_pop.notify_one();
    return 0;
}

// 1 = got block, 0 = timed out, -1 = EOF (and drained).  The block is
// copied into dst with the ring's lock released; its slot stays filled
// (so no producer writes it) until the copy is done.
int tsdr_ring_pop(Ring* r, uint8_t* dst, int timeout_ms) {
    using ms = std::chrono::milliseconds;
    std::unique_lock<std::timed_mutex> turn(r->pop_mu, std::defer_lock);
    if (timeout_ms < 0) {
        turn.lock();
    } else if (!turn.try_lock_for(ms(timeout_ms))) {
        return 0;
    }
    size_t slot;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        auto ready = [&] { return r->count > 0 || r->eof; };
        if (timeout_ms < 0) {
            r->cv_pop.wait(lk, ready);
        } else if (!r->cv_pop.wait_for(lk, ms(timeout_ms), ready)) {
            return 0;
        }
        if (r->count == 0) return -1;  // eof && drained
        slot = r->tail;
    }
    std::memcpy(dst, r->arena + slot * r->block_bytes, r->block_bytes);
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->tail = (r->tail + 1) % r->capacity;
        r->count--;
    }
    r->cv_push.notify_one();
    return 1;
}

size_t tsdr_ring_count(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->count;
}

uint64_t tsdr_ring_dropped(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->dropped;
}

void tsdr_ring_set_eof(Ring* r) {
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->eof = true;
    }
    r->cv_pop.notify_all();
}

int tsdr_ring_eof(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->eof ? 1 : 0;
}

// -- pump ------------------------------------------------------------------

// Spawn a reader thread pulling fixed blocks from `fd` into the ring.
// `loop_file`: rewind at EOF (file replay). `block_on_full`: apply
// backpressure instead of dropping.
Pump* tsdr_pump_start(Ring* r, int fd, int loop_file, int block_on_full) {
    Pump* p = new Pump();
    p->ring = r;
    p->fd = fd;
    p->loop_file = loop_file != 0;
    p->block_on_full = block_on_full != 0;
    p->thread = std::thread(pump_main, p);
    return p;
}

void tsdr_pump_stop(Pump* p) {
    if (!p) return;
    p->stop.store(true);
    p->ring->cv_push.notify_all();
    if (p->thread.joinable()) p->thread.join();
    delete p;
}

uint64_t tsdr_pump_blocks(Pump* p) { return p->blocks_read; }

// -- hot byte-path conversions ----------------------------------------------

// u8 interleaved I/Q -> planar centered/scaled f32 with fs/4 rotation
// (multiply sample k by j**(k+phase)).  Host-side twin of the float chain's
// u8 unpack + rotate_fs4 (reference rotate_90 incl. its NEON path,
// simple_fm.rs:276-334).
void tsdr_u8_iq_to_planar_f32(const uint8_t* iq, size_t n_pairs, int phase,
                              float scale, float* re, float* im) {
    const float off = 127.5f * scale;
    for (size_t k = 0; k < n_pairs; k++) {
        float i = static_cast<float>(iq[2 * k]) * scale - off;
        float q = static_cast<float>(iq[2 * k + 1]) * scale - off;
        switch ((k + static_cast<size_t>(phase)) & 3) {
            case 0: re[k] = i;  im[k] = q;  break;
            case 1: re[k] = -q; im[k] = i;  break;
            case 2: re[k] = -i; im[k] = -q; break;
            default: re[k] = q; im[k] = -i; break;
        }
    }
}

// fs/4 rotation as a pure byte map: multiply sample k by j**(k+phase)
// without leaving u8 space — negation of a centered sample (x = 2u - 255)
// is the byte complement 255 - u, so rotation only swaps/complements the
// I/Q bytes (the reference's own host-thread placement of this op,
// simple_fm.rs:276-334).  The per-period pattern is fixed once `phase` is
// known, so each case is a straight-line 8-byte map the compiler
// auto-vectorizes.  The Python wrapper takes whole 4-sample periods only
// (n_pairs % 4 == 0); the ragged tail loop below is never reached from it.
void tsdr_rotate_fs4_u8(const uint8_t* iq, uint8_t* out, size_t n_pairs,
                        int phase) {
    size_t k = 0;
#define TSDR_ROT0(s, d) { (d)[0] = (s)[0];       (d)[1] = (s)[1]; }
#define TSDR_ROT1(s, d) { (d)[0] = 255 - (s)[1]; (d)[1] = (s)[0]; }
#define TSDR_ROT2(s, d) { (d)[0] = 255 - (s)[0]; (d)[1] = 255 - (s)[1]; }
#define TSDR_ROT3(s, d) { (d)[0] = (s)[1];       (d)[1] = 255 - (s)[0]; }
#define TSDR_ROT_LOOP(A, B, C, D)                                         \
    for (; k + 4 <= n_pairs; k += 4) {                                    \
        const uint8_t* s = iq + 2 * k;                                    \
        uint8_t* d = out + 2 * k;                                         \
        TSDR_ROT##A(s, d) TSDR_ROT##B(s + 2, d + 2)                       \
        TSDR_ROT##C(s + 4, d + 4) TSDR_ROT##D(s + 6, d + 6)               \
    }
    switch (phase & 3) {
        case 0: TSDR_ROT_LOOP(0, 1, 2, 3) break;
        case 1: TSDR_ROT_LOOP(1, 2, 3, 0) break;
        case 2: TSDR_ROT_LOOP(2, 3, 0, 1) break;
        default: TSDR_ROT_LOOP(3, 0, 1, 2) break;
    }
    for (; k < n_pairs; k++) {  // ragged tail (blocks are 0 mod 4 anyway)
        const uint8_t* s = iq + 2 * k;
        uint8_t* d = out + 2 * k;
        switch ((k + static_cast<size_t>(phase)) & 3) {
            case 0: TSDR_ROT0(s, d) break;
            case 1: TSDR_ROT1(s, d) break;
            case 2: TSDR_ROT2(s, d) break;
            default: TSDR_ROT3(s, d) break;
        }
    }
#undef TSDR_ROT0
#undef TSDR_ROT1
#undef TSDR_ROT2
#undef TSDR_ROT3
#undef TSDR_ROT_LOOP
}

// f32 audio [-1,1] -> s16 PCM with clamping (ref output(),
// simple_fm.rs:430-438 emits s16-LE): scaled, clamped to [-32768, 32767],
// truncated toward zero.  With SSE2 (the x86-64 baseline) 8 samples a step
// take a min, a max, cvttps2dq and a saturating pack, which the scalar
// loop's two ifs and int16_t cast do not compile to; NaN is masked to 0,
// what the scalar cast gives on x86.  The same bits on both loops.
void tsdr_f32_to_s16(const float* x, size_t n, float scale, int16_t* out) {
    size_t k = 0;
#if defined(__SSE2__)
    const __m128 s = _mm_set1_ps(scale);
    const __m128 hi = _mm_set1_ps(32767.f), lo = _mm_set1_ps(-32768.f);
    for (; k + 8 <= n; k += 8) {
        __m128 a = _mm_mul_ps(_mm_loadu_ps(x + k), s);
        __m128 b = _mm_mul_ps(_mm_loadu_ps(x + k + 4), s);
        a = _mm_and_ps(_mm_max_ps(_mm_min_ps(a, hi), lo), _mm_cmpord_ps(a, a));
        b = _mm_and_ps(_mm_max_ps(_mm_min_ps(b, hi), lo), _mm_cmpord_ps(b, b));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + k),
                         _mm_packs_epi32(_mm_cvttps_epi32(a),
                                         _mm_cvttps_epi32(b)));
    }
#endif
    for (; k < n; k++) {
        float v = x[k] * scale;
        if (v > 32767.f) v = 32767.f;
        if (v < -32768.f) v = -32768.f;
        out[k] = static_cast<int16_t>(v);
    }
}

// RTL2832U test-pattern continuity check: the chip emits an incrementing
// 8-bit counter in test mode (ref rtl_test.rs reads it; this version also
// verifies continuity, which the reference's rtl_test does not).  Returns
// the number of discontinuities; `*last` carries the counter across blocks
// (pass -1 on the first block).
uint64_t tsdr_count_pattern_breaks(const uint8_t* buf, size_t n, int* last) {
    uint64_t breaks = 0;
    int prev = *last;
    for (size_t k = 0; k < n; k++) {
        if (prev >= 0 && buf[k] != static_cast<uint8_t>(prev + 1)) breaks++;
        prev = buf[k];
    }
    *last = prev;
    return breaks;
}

// rtl_tcp 5-byte command framing: parse [cmd u8 | param u32 be] records
// from `buf`; returns the number of complete commands written to cmds/params
// (ref command_loop, rtl_tcp.rs:633-689).
size_t tsdr_parse_tcp_commands(const uint8_t* buf, size_t n, uint8_t* cmds,
                               uint32_t* params, size_t max_cmds) {
    size_t count = 0;
    for (size_t off = 0; off + 5 <= n && count < max_cmds; off += 5) {
        cmds[count] = buf[off];
        params[count] = (static_cast<uint32_t>(buf[off + 1]) << 24) |
                        (static_cast<uint32_t>(buf[off + 2]) << 16) |
                        (static_cast<uint32_t>(buf[off + 3]) << 8) |
                        static_cast<uint32_t>(buf[off + 4]);
        count++;
    }
    return count;
}

}  // extern "C"

#ifdef TSDR_PYTHON
// ---------------------------------------------------------------------------
// CPython entry: f32_to_s16(x, scale) with no ctypes in the call
// ---------------------------------------------------------------------------

// x's buffer is read in place when it is C-contiguous float32; the result is
// a fresh numpy int16 array of x's size.  When x offers no such buffer the
// entry returns None, and the caller copies x first.  The GIL is kept: the
// loop takes about a microsecond at the callers' sizes, less than giving the
// GIL away and taking it back can cost.
namespace {

PyObject* g_np_empty = nullptr;  // numpy.empty, numpy.int16
PyObject* g_np_int16 = nullptr;
unsigned long long g_s16_converted = 0, g_s16_refused = 0;

PyObject* py_f32_to_s16(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "f32_to_s16(x, scale)");
        return nullptr;
    }
    const double scale = PyFloat_AsDouble(args[1]);
    if (scale == -1.0 && PyErr_Occurred()) return nullptr;
    Py_buffer in;
    if (PyObject_GetBuffer(args[0], &in, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT)) {
        PyErr_Clear();
        g_s16_refused++;
        Py_RETURN_NONE;
    }
    if (in.itemsize != 4 || in.format == nullptr ||
        std::strcmp(in.format, "f") != 0) {
        PyBuffer_Release(&in);
        g_s16_refused++;
        Py_RETURN_NONE;
    }
    const Py_ssize_t n = in.len / 4;
    PyObject* size = PyLong_FromSsize_t(n);
    PyObject* call[2] = {size, g_np_int16};
    PyObject* out = size ? PyObject_Vectorcall(g_np_empty, call, 2, nullptr)
                         : nullptr;
    Py_XDECREF(size);
    Py_buffer ob;
    if (out && PyObject_GetBuffer(out, &ob,
                                  PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) == 0) {
        tsdr_f32_to_s16(static_cast<const float*>(in.buf),
                        static_cast<size_t>(n), static_cast<float>(scale),
                        static_cast<int16_t*>(ob.buf));
        PyBuffer_Release(&ob);
        g_s16_converted++;
    } else {
        Py_CLEAR(out);
    }
    PyBuffer_Release(&in);
    return out;
}

PyObject* py_s16_counts(PyObject*, PyObject*) {
    return Py_BuildValue("KK", g_s16_converted, g_s16_refused);
}

PyMethodDef kMethods[] = {
    {"f32_to_s16",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)(void)>(py_f32_to_s16)),
     METH_FASTCALL,
     "f32_to_s16(x, scale) -> int16 array, or None if x is not a "
     "C-contiguous float32 buffer"},
    {"s16_counts", py_s16_counts, METH_NOARGS,
     "(calls converted, calls refused) since the library was loaded"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_tpusdr_io", nullptr, -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__tpusdr_io(void) {
    if (g_np_empty == nullptr) {
        PyObject* np = PyImport_ImportModule("numpy");
        if (np == nullptr) return nullptr;
        g_np_empty = PyObject_GetAttrString(np, "empty");
        g_np_int16 = PyObject_GetAttrString(np, "int16");
        Py_DECREF(np);
        if (g_np_empty == nullptr || g_np_int16 == nullptr) {
            Py_CLEAR(g_np_empty);
            Py_CLEAR(g_np_int16);
            return nullptr;
        }
    }
    return PyModule_Create(&kModule);
}
#endif  // TSDR_PYTHON
