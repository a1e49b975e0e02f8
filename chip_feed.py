#!/usr/bin/env python3
"""Where the port's host-to-device feed spends its time, a block at a time,
on one NVIDIA GPU.  A diagnostic run by hand, never needed by
``chip_smoke.py``:

    python3 chip_feed.py

It writes a file of 40 blocks of 262,144 bytes (the CLIs' read) and
times, on the host clock, the median over 7 runs of a block through:
the native ring alone (``pop_into`` a numpy buffer), ``blocks()`` alone,
``blocks()`` then a pageable ``.to`` (with and without a consumer that
waits for each block), and ``device_blocks`` (with and without the wait).
Then one instrumented copy of ``BlockFeeder.device_blocks``' loop (the
same calls in the same order, no lookahead) splits a block's time among
its calls.  Every line names the card and its power limit.  It exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

BLOCKS, READ, REPS = 40, 262_144, 7


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_feed: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_sdr_torch import native
    from tpu_sdr_torch.stream import feeder as FD

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if not native.available():
        raise RuntimeError("chip_feed: the native runtime did not build")
    dev = torch.device("cuda", 0)
    data = np.random.default_rng(0).integers(0, 256, BLOCKS * READ, np.uint8)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "feed.u8")
        data.tofile(path)

        def feeder():
            fd = FD.BlockFeeder(FD.FileSource(path), block_bytes=READ).start()
            if not fd.is_native:
                raise RuntimeError("chip_feed: the feeder is not native")
            return fd

        def pop_only():
            fd = feeder()
            buf = np.empty(READ, np.uint8)
            while fd._ring.pop_into(buf.ctypes.data, 30_000):
                pass
            fd.stop()

        def loop(blocks_of, wait: bool):
            def run():
                fd = feeder()
                for _ in blocks_of(fd):
                    if wait:
                        torch.cuda.current_stream().synchronize()
                fd.stop()
            return run

        def pageable(fd):
            return (torch.from_numpy(b).to(dev) for b in fd.blocks())

        def on_card(fd):
            return fd.device_blocks(dev)

        def blocks(fd):
            return fd.blocks()

        def us_a_block(fn) -> float:
            fn()
            times = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / BLOCKS * 1e6)
            return statistics.median(times)

        for name, fn in (("ring pop_into alone", pop_only),
                         ("blocks() alone", loop(blocks, False)),
                         ("blocks() + pageable .to", loop(pageable, False)),
                         ("blocks() + pageable .to, waited", loop(pageable, True)),
                         ("device_blocks", loop(on_card, False)),
                         ("device_blocks, waited", loop(on_card, True))):
            print(f"{name}: {us_a_block(fn):.1f} us a block of {READ} bytes "
                  f"({smi})", flush=True)

        # device_blocks' calls, one by one (no lookahead: each block is
        # popped, copied and handed over before the next)
        acc: dict[str, float] = {}

        def instrumented():
            fd = feeder()
            slots = [torch.empty(READ, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
            copied = [torch.cuda.Event() for _ in slots]
            side = torch.cuda.Stream(dev)
            consumer = torch.cuda.current_stream(dev)
            k = 0
            while True:
                marks = [time.perf_counter()]
                copied[k].synchronize()
                marks.append(time.perf_counter())
                if not fd._ring.pop_into(slots[k].data_ptr(), 30_000):
                    break
                marks.append(time.perf_counter())
                with torch.cuda.stream(side):
                    marks.append(time.perf_counter())
                    blk = torch.empty(READ, dtype=torch.uint8, device=dev)
                    marks.append(time.perf_counter())
                    blk.copy_(slots[k], non_blocking=True)
                    marks.append(time.perf_counter())
                    copied[k].record(side)
                    marks.append(time.perf_counter())
                consumer.wait_event(copied[k])
                marks.append(time.perf_counter())
                blk.record_stream(consumer)
                marks.append(time.perf_counter())
                consumer.synchronize()
                marks.append(time.perf_counter())
                for name, a, b in zip(
                        ("slot event sync", "pop_into", "enter side stream",
                         "torch.empty", "copy_", "event record",
                         "wait_event", "record_stream", "consumer sync"),
                        marks, marks[1:]):
                    acc[name] = acc.get(name, 0.0) + (b - a)
                k ^= 1
            fd.stop()

        instrumented()
        acc.clear()
        for _ in range(REPS):
            instrumented()
        split = ", ".join(f"{name} {v / REPS / BLOCKS * 1e6:.1f}"
                          for name, v in acc.items())
        print(f"device_blocks' calls, us a block: {split} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
