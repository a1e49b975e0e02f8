"""What the host and the card were doing around the measured window, for
the record line a run prints before its result: the process's CPU
seconds, involuntary context switches, page faults and garbage
collections, the machine's steal ticks, and at each end of the window the
card's SM clock and power and the host's speed on two fixed tasks (a
Python loop and a memory copy)."""

from __future__ import annotations

import gc
import resource
import subprocess
import time

import numpy as np


def steal_ticks() -> int | None:
    """Ticks stolen from this machine's CPUs by the hypervisor
    (``/proc/stat``'s eighth ``cpu`` field), None where it is not read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8])
    except (OSError, IndexError, ValueError):
        return None


def card() -> str:
    """The card's SM clock, power draw and power limit, as nvidia-smi reads
    them, or why they were not read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else f"not read (rc {out.returncode})"


def host_speed() -> dict:
    """ms for a fixed loop of Python arithmetic, and GB/s of one core
    copying 16 MiB, each the best of three."""
    loops, copies = [], []
    src = np.ones(1 << 24, np.uint8)
    dst = np.empty_like(src)
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for k in range(200_000):
            x += k
        loops.append(time.perf_counter() - t)
        t = time.perf_counter()
        np.copyto(dst, src)
        copies.append(time.perf_counter() - t)
    return {"python_ms": min(loops) * 1e3, "copy_gb_s": src.nbytes / min(copies) / 1e9}


class Window:
    """Readings at the start and the end of the measured window."""

    def start(self) -> None:
        self.card0 = card()
        self.speed0 = host_speed()
        self.steal0 = steal_ticks()
        self.gc0 = [g["collections"] for g in gc.get_stats()]
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.ru1 = resource.getrusage(resource.RUSAGE_SELF)
        self.gc1 = [g["collections"] for g in gc.get_stats()]
        self.steal1 = steal_ticks()
        self.speed1 = host_speed()
        self.card1 = card()

    def record(self) -> dict:
        wall = self.t1 - self.t0
        cpu = (self.ru1.ru_utime - self.ru0.ru_utime
               + self.ru1.ru_stime - self.ru0.ru_stime)
        return {"cpu_over_wall": cpu / wall,
                "involuntary_switches": self.ru1.ru_nivcsw - self.ru0.ru_nivcsw,
                "page_faults": self.ru1.ru_minflt - self.ru0.ru_minflt,
                "steal_ticks": (None if self.steal0 is None or self.steal1 is None
                                else self.steal1 - self.steal0),
                "gc_collections": [b - a for a, b in zip(self.gc0, self.gc1)],
                "host_start": self.speed0, "host_end": self.speed1,
                "card_start": self.card0, "card_end": self.card1}
