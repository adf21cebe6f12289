#!/usr/bin/env python3
"""Per-span readings of a benchmark cell's proves on one CUDA device.

    python3 scripts/span_profile.py --workload NAME --seed N
                                    [--window-proves K] [--overhead]

Runs the cell as ``benchmark/run.py --trace 1`` does (its configuration,
traffic, warm-up proves and collector, whose phases also open the
benchmark's ``phase:`` ranges), then ``run.PROFILED_PROVES`` proves
under ``torch.profiler`` and K proves with a collector.  From the
profile: the benchmark's own ``read_profile`` and, over every
``span:<name>`` range of the program (``stark_tpu_torch/utils/
metrics.py``), the device seconds of the work launched inside it
(:func:`read_spans`) and the device idle inside it (the same union of
device operations as ``read_profile``); from the K proves, each span's
host wall summed a prove.  Prints one JSON line: those readings, the
per-layer quantities they give (ms a proof) and the checks that the
spans and the benchmark's phases share the profiler's clock.  ``--overhead`` adds the
host cost of a span in a loop of 10^5 with nothing recording, under an
explicit collector and under a running profiler.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from benchmark import run as bench  # noqa: E402
from benchmark.generator import Traffic, load_mix  # noqa: E402
from stark_tpu_torch.utils import metrics  # noqa: E402

PREFIX = "span:"
TOP = ("trace-lde", "trace-commit", "composition", "fri-commit", "queries")


def read_spans(prof) -> dict:
    """Device seconds and device idle seconds by span name, summed over
    every ``span:`` range of the profile; the device seconds whose
    launch no span holds; and the device-side copies of those ranges
    that ``read_profile``'s filter would count as device operations.

    A device operation counts in every span whose range holds the host
    call that launched it: the CUDA runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) that carries the operation's correlation
    id.  The range's own ``device_time_total`` would miss the program's
    kernels: the profiler links a kernel to a range only through a
    torch op, and K1-K5 are launched through ``ctypes``, outside any."""
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("phase:")]
    merged = bench._merge([(e.time_range.start, e.time_range.end)
                           for e in dev])
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cu")}
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
              for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(PREFIX)]
    device_s, idle_s, outside = {}, {}, 0.0
    for s, t, name in ranges:
        device_s.setdefault(name, 0.0)
        idle_s[name] = idle_s.get(name, 0.0) + (
            (t - s) - bench._covered(merged, s, t)) / 1e6
    for e in dev:
        dur = (e.time_range.end - e.time_range.start) / 1e6
        at = launched.get(e.id)
        names = [] if at is None else [n for s, t, n in ranges
                                       if s <= at <= t]
        for n in names:
            device_s[n] += dur
        if not names:
            outside += dur
    leaked = sorted({e.name for e in dev if e.name.startswith(PREFIX)})
    return {"span_device_s": device_s, "span_idle_s": idle_s,
            "device_s_outside_spans": outside,
            "span_ranges_as_device_ops": leaked}


def span_walls(mc) -> dict:
    """Host seconds of each span name in one prove's collector, summed
    (a prove's folds to one entry)."""
    out: dict = {}
    for s in mc.spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_s - s.start_s)
    return out


def overhead(n: int = 100_000) -> dict:
    """Host microseconds a span: a bare loop's cost taken off."""

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with metrics.span("fold"):
                pass
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n):
        pass
    bare = time.perf_counter() - t0
    out = {"off_us": 1e6 * (loop() - bare) / n}
    with metrics.proving(metrics.MetricsCollector()):
        out["collector_us"] = 1e6 * (loop() - bare) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        out["profiler_us"] = 1e6 * (loop() - bare) / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window-proves", type=int, default=10)
    ap.add_argument("--overhead", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec_all = bench.load_bench()
    cell = bench.find(spec_all["workloads"], args.workload, "workload")
    spec = bench.load_config(spec_all, cell)
    traffic = Traffic(load_mix(cell["traffic"]), spec, args.seed)
    run = bench.program(spec, "cuda")
    traffic.make_pool()
    for i in range(traffic.warmup):
        run(traffic.statement(i), bench.collector())
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    proves = bench.PROFILED_PROVES
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(proves):
            run(traffic.statement(traffic.warmup + k), bench.collector())
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    info = bench.read_profile(prof)
    info.update(read_spans(prof))

    walls: dict = {}
    first = traffic.warmup + proves
    t0 = time.perf_counter()
    for k in range(args.window_proves):
        mc = bench.collector()
        run(traffic.statement(first + k), mc)
        for name, s in span_walls(mc).items():
            walls.setdefault(name, []).append(s)
    window_s = time.perf_counter() - t0

    dev_s, idle_s = info["span_device_s"], info["span_idle_s"]
    phase_idle = dict(info["idle_gaps"])
    kernel_total = sum(info["kernel_s"].values())
    top_dev = sum(dev_s.get(n, 0.0) for n in TOP)
    top_idle = sum(idle_s.get(n, 0.0) for n in TOP)
    phase_idle_top = sum(phase_idle.get(n, 0.0) for n in TOP)

    def mean_ms(name):
        w = walls.get(name)
        return 1e3 * sum(w) / len(w) if w else None

    out = {
        "workload": cell["name"], "seed": args.seed,
        "card": bench.card_info("cuda"),
        "profiled_proves": proves, "traced_window_s": window,
        "busy_s": info["busy_s"], "device_events": info["device_events"],
        "device_idle": 100.0 * (1.0 - info["busy_s"] / window),
        "span_device_s": dev_s, "span_idle_s": idle_s,
        "phase_idle_s": phase_idle, "kernel_s_total": kernel_total,
        "span_ranges_as_device_ops": info["span_ranges_as_device_ops"],
        "span_wall_ms": {n: mean_ms(n) for n in sorted(walls)},
        "window_proves": args.window_proves,
        "window_proofs_per_s": args.window_proves / window_s,
        "readings_ms": {
            "host_trace_ms": mean_ms("host-trace"),
            "lde_ntt_ms": 1e3 * (dev_s.get("intt", 0.0)
                                 + dev_s.get("coset-ntt", 0.0)) / proves,
            "fri_fold_ms": 1e3 * dev_s.get("fold", 0.0) / proves,
            "fri_idle_ms": 1e3 * idle_s.get("fri-commit", 0.0) / proves,
            "host_replay_ms": mean_ms("host-replay"),
            "fri_idle_split_ms": {
                n: 1e3 * idle_s.get(n, 0.0) / proves
                for n in ("fold", "layer-tree", "fri-draw")},
        },
        "checks": {
            "top_idle_s": top_idle, "phase_idle_s": phase_idle_top,
            "top_device_s": top_dev, "kernel_s": kernel_total,
            "device_s_outside_spans": info["device_s_outside_spans"],
        },
    }
    if args.overhead:
        out["span_overhead_us"] = overhead()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
