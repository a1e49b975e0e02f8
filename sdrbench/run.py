"""Run one cell of ``BENCHMARK.json`` once, on one card:

    python3 -m sdrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up builds the ring of reads from the
seed on the card, builds the program and warms every graph key the cell
uses; the window then drives closed-loop reads, one client, for
``--seconds``.  ``--trace 1`` adds a traced stretch of reads after the
window and reports the cell's per-layer metrics instead of its end-to-end
ones.  After the window the program is freed and the plain reference
checks the reads sampled from the window (and in RDS cells every group
decoded): ``correct``.  Earlier lines on standard error give the set-up's
split, the work signature, the window's twentieths and what the host and
the card did; its last lines, each number compared beside its limit.  The
last line on standard output is the result.

``--control tf32`` puts the reference computed at TF32 in the program's
place for the check, which has to fail it (the control of the limits).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
import time

_CLOCK_AT_IMPORT = time.perf_counter()
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_sdr"}


def _process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = _CLOCK_AT_IMPORT - _process_age()


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _twentieths(t0: float, ends: list, lat: list) -> list:
    span = (ends[-1] - t0) / 20
    sums, counts = [0.0] * 20, [0] * 20
    for e, v in zip(ends, lat):
        k = min(19, int((e - t0) / span))
        sums[k] += v
        counts[k] += 1
    return [s / c * 1e3 if c else None for s, c in zip(sums, counts)]


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: str = ".", device: str = "cuda", control: str | None = None,
        log=sys.stderr) -> tuple[dict, list]:
    """One run; returns (the result line's object, the numbers compared)."""
    from sdrbench import capture, manifest

    def say(msg):
        print(msg, file=log, flush=True)

    split = {"start_s": _CLOCK_AT_IMPORT - PROCESS_START}
    mark = _CLOCK_AT_IMPORT

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        split[name] = now - mark
        mark = now

    cell = manifest.cell(workload, root)
    import numpy as np
    import torch

    lap("import_torch_s")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise NoCard(f"{workload} needs {cell.chips} CUDA device(s); "
                     f"torch.cuda.is_available() is "
                     f"{torch.cuda.is_available()}, device_count() "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if cuda:
        torch.cuda.init()
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    lap("cuda_init_s")
    rx_mod = manifest.load_module(cell.receiver_path(),
                                  f"sdrbench_receiver_{cell.config['receiver']}")
    import tpu_sdr_torch.native as native

    lap("import_program_s")
    if cuda:
        from tpu_sdr_torch import kernels

        kernels.load()
    native.load()
    lap("build_s")
    plan = capture.plan(cell.config, cell.traffic, seed)
    ring_dev = capture.synthesize(plan, dev)
    ring = ring_dev.cpu().numpy()
    del ring_dev
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    lap("capture_s")
    rx = rx_mod.Receiver(cell.config, cell.traffic, dev)
    lap("program_s")
    rb, R = plan.read_bytes, plan.ring_reads
    views = [ring[k * rb:(k + 1) * rb] for k in range(R)]
    warm = int(cell.traffic["warmup_reads"])
    for k in range(warm):
        rx.read(views[k % R])
    if cuda:
        torch.cuda.synchronize(dev)
    lap("warmup_s")
    setup_s = time.perf_counter() - PROCESS_START
    say(f"set-up split: {json.dumps(split)}")
    sig = capture.signature(plan, rx.graph_keys())
    say(f"work signature: {json.dumps(sig, sort_keys=True)}")
    if cuda:
        say(f"card: {kind}, power limit and clocks at each end of the window below")

    from sdrbench import hostinfo, trace as tr

    spans = tr.Spans({}) if trace else tr.NO_SPANS
    n_keep = int(cell.traffic["compare_reads"])
    pick = random.Random(f"{seed} compare")
    slots: list = []
    lat, ends = [], []
    i = warm
    host = hostinfo.Window()
    gc.collect()
    host.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        with spans("feed"):
            buf = views[i % R]
        pcm = rx.read(buf, spans)
        t1 = time.perf_counter()
        spans.close_read()
        lat.append(t1 - t0)
        ends.append(t1)
        j = i - warm
        if j < n_keep:
            slots.append((i, pcm))
        else:
            r = pick.randrange(j + 1)
            if r < n_keep:
                slots[r] = (i, pcm)
        i += 1
        if t1 >= deadline:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = ends[-1]
    host.stop()
    attempted = i - warm
    kept = dict(slots)
    kept[i - 1] = pcm             # and always the window's last read
    window_s = t_end - t_start
    tw = _twentieths(t_start, ends, lat)
    say("window twentieths, ms a read: "
        + " ".join("-" if v is None else f"{v:.4f}" for v in tw))
    say(f"window: {attempted} reads (reads {warm}..{i - 1}) in {window_s:.3f} s; "
        f"host and card: {json.dumps(host.record())}")

    rec = None
    if trace:
        state = {"i": i}

        def read_once(spans):
            with spans("feed"):
                buf = views[state["i"] % R]
            rx.read(buf, spans)
            state["i"] += 1

        n_trace = int(cell.traffic["trace_reads"])
        rec = tr.take(read_once, n_trace, cell, dev)
        rec.spans, rec.read_s = spans.sink, window_s / attempted
        i = state["i"]
        say(f"trace: {rec.reads} reads in {rec.wall_s:.4f} s, whole; host "
            f"calls {sum(rec.host_calls.values())}, device records "
            f"{len(rec.ops)}")

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    groups = [list(g) for g in rx.groups] if hasattr(rx, "groups") else []
    rx.close()
    del rx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings, checks = rx_mod.check(cell.config, plan, ring, kept, groups, i,
                                    device=dev, control=control)
    say(f"compared: {len(kept)} reads' audio in "
        f"{time.perf_counter() - t_check:.3f} s; readings "
        f"{json.dumps(readings)}")

    samples = attempted * plan.read_samples
    if trace:
        metrics = {}
        for m in cell.per_layer:
            reader = manifest.load_module(cell.metric_path(m["name"]),
                                          f"sdrbench_metric_{m['name']}")
            v = reader.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"throughput": samples / window_s / 1e6,
                  "read_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device_rec}
    if rec is not None and rec.busy_s is not None:
        device_rec["busy_s"] = rec.busy_s
        device_rec["window_s"] = rec.wall_s
        result["breakdown"] = tr.breakdown(rec)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    try:
        result, checks = run(args.workload, args.seed, args.seconds,
                             bool(args.trace), root=os.getcwd(),
                             control=args.control)
    except NoCard as e:
        print(f"sdrbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"sdrbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
