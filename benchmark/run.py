"""The benchmark of stark_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell names a configuration (``benchmark/configs/<name>.json``: the
statement's AIR, found in ``benchmark/airs/``, the field and the sizes)
and a traffic mix (``benchmark/traffic/<name>.json``, read by
``generator.py``).  One client proves statement after statement (a
closed loop), on one card, or, where the configuration states
``"shards": S``, over a mesh of S shards, shard i on card
i * chips // S of the cell's cards (one process):

* set-up: the imports, the CUDA context, the program's kernels (built
  into ``build/`` under the checkout on a checkout's first run), the
  mix's inputs, and the warm-up proves, which build the AIR's context
  tables; ``setup_s`` runs from the process start to the first timed
  prove;
* the window: proves until ``--seconds`` have passed (the last one
  started runs to its end); each prove's wall is the host clock around
  ``stark_tpu_torch.stark.prove``, which ends in its one device-to-host
  copy and the host replay;
* with ``--trace 1``, the first proves of the window run under
  ``torch.profiler`` and every prove passes a collector whose phases end
  in a device synchronise, so the per-layer metrics read synced phase
  walls, kernel device times and the device's idle share;
* the check: once the window has closed and its peak memory is read
  (each card's; the fullest card's is the result's), a proof drawn from
  the seed is compared message by message with the plain reference's
  proof of the same statement (``reference/``, on the cell's first
  card), and every proof of a statement with the first one of it.

Each metric is a reader ``benchmark/metrics/<name>.py`` over the run
record (a split metric ``<name>.<group>`` is read by ``<name>.py``).
The last line of standard output is the result, a JSON object; the
numbers compared and their limits end standard error and the result.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[:1] != [ROOT]:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import airs, guard  # noqa: E402
from benchmark.generator import Traffic, load_mix  # noqa: E402

# proves of a traced run's window under torch.profiler
PROFILED_PROVES = 3


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, cell: dict) -> dict:
    entry = find(bench["configs"], cell["config"], "configuration")
    with open(os.path.join(ROOT, entry["file"])) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list[dict]:
    """The metrics this cell reports in this mode: the end-to-end ones
    untraced, each where its ``workloads`` (if any) names the cell; the
    per-layer ones traced, each where its ``workloads`` names the cell
    or, without that key, where the cell reports the end-to-end metric
    it ``moves``."""

    def names(m, e2e):
        if "workloads" in m:
            return cell["name"] in m["workloads"]
        return e2e is None or m["moves"] in e2e

    e2e = {m["name"] for m in bench["end_to_end"] if names(m, None)}
    if not traced:
        return [m for m in bench["end_to_end"] if names(m, None)]
    return [m for m in bench["per_layer"] if names(m, e2e)]


def shard_devices(spec: dict, cell: dict, device, devices=None):
    """The device of each shard where the configuration states
    ``shards`` (None where it does not): `devices` as given (tests:
    logical shards on one device), else shard i on card
    i * chips // shards.  A cell with fewer cards than shards is
    refused."""
    shards = spec.get("shards")
    if shards is None:
        if devices is not None:
            raise ValueError("devices are given a shard each, and the "
                             "configuration states no shards")
        return None
    if shards < 1 or shards & (shards - 1):
        raise SystemExit(f"{cell['config']}: shards must be a power of "
                         f"two, not {shards}")
    if devices is not None:
        if len(devices) != shards:
            raise ValueError(f"{len(devices)} devices for {shards} shards")
        return [torch.device(d) for d in devices]
    if cell["chips"] < shards:
        raise SystemExit(f"{cell['name']}: {shards} shards on "
                         f"{cell['chips']} card(s); a cell runs a shard a "
                         "card at most")
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * shards
    return [torch.device("cuda", i * cell["chips"] // shards)
            for i in range(shards)]


def cards_of(devices) -> list:
    """The distinct CUDA devices among `devices`, in their order (empty
    off the card)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            if d not in out:
                out.append(d)
    return out


def program(spec: dict, device, devices=None):
    """The system under test: a function proving one statement with
    ``stark_tpu_torch.stark.prove`` (a finished trace's storage words,
    or the witness, whose trace the program makes), with the program's
    AIR class that ``benchmark/airs/<air>.py`` names; over a mesh of
    ``make_mesh(devices=devices)`` where `devices` (one a shard) are
    given."""
    import stark_tpu_torch.stark as stark
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.dist.mesh import make_mesh

    cfg = ProverConfig(modulus=spec["modulus"], generator=spec["generator"],
                       log2_trace=spec["log2_trace"], blowup=spec["blowup"],
                       num_queries=spec["num_queries"],
                       coset_offset=spec["coset_offset"])
    cls_name, keyword = airs.load(spec["air"]).PROGRAM_AIR
    cls = getattr(stark, cls_name)
    mesh = None if devices is None else make_mesh(devices=devices)

    def run(st, metrics=None):
        if st.words is not None:
            pr = stark.prove(cfg, air=cls(), trace=st.words, device=device,
                             metrics=metrics, mesh=mesh)
        else:
            pr = stark.prove(cfg, air=cls(**{keyword: st.witness}),
                             device=device, metrics=metrics, mesh=mesh)
        return list(pr.proof), dict(pr.publics)

    return run


def collector():
    """A MetricsCollector whose phases (each ending in a device
    synchronise inside ``prove``) also open a ``torch.profiler`` range
    named ``phase:<name>``."""
    import contextlib

    from stark_tpu_torch.utils.metrics import MetricsCollector

    class Phases(MetricsCollector):
        @contextlib.contextmanager
        def phase(self, name: str, **extra):
            with torch.profiler.record_function(f"phase:{name}"):
                with super().phase(name, **extra):
                    yield

    return Phases()


def digest(messages: list, publics: dict) -> str:
    h = hashlib.sha256(json.dumps(publics, sort_keys=True).encode())
    for m in messages:
        h.update(len(m).to_bytes(4, "big") + m)
    return h.hexdigest()


def _smi(fields: str, device) -> list[str]:
    """One nvidia-smi query of the card torch calls `device`, named by its
    UUID (nvidia-smi's indices follow the PCI bus, not
    CUDA_VISIBLE_DEVICES): its values, in order."""
    uuid = torch.cuda.get_device_properties(device).uuid
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
         "-i", f"GPU-{uuid}"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().split(", ")


def card_info(*devices) -> dict:
    """The first card's name, multiprocessors, maximum SM clock and power
    limit, and with several cards each card's under ``cards``; empty off
    the card."""
    cards = cards_of(devices)
    infos = []
    for d in cards:
        name, clock, limit = _smi("name,clocks.max.sm,power.limit", d)
        infos.append({"name": name,
                      "sm_clock_max_mhz": float(clock.split()[0]),
                      "power_limit_w": float(limit.split()[0]),
                      "sms": torch.cuda.get_device_properties(
                          d).multi_processor_count})
    if len(infos) > 1:
        return dict(infos[0], cards=infos)
    return infos[0] if infos else {}


def card_state(*devices) -> str:
    """Each card's SM clock, temperature and power draw now, for the
    diagnostics on standard error; empty off the card."""
    return "; ".join(", ".join(_smi("clocks.sm,temperature.gpu,power.draw",
                                    d))
                     for d in cards_of(devices))


def card_peaks(cards) -> tuple:
    """The peak allocated bytes since the last reset: the fullest card's,
    and each card's (0 and none off the card)."""
    peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
    return max(peaks, default=0), peaks


def _merge(spans: list) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged: list, s: float, e: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)


def read_profile(prof, cards=None) -> dict:
    """Device busy time, kernel device time by name, the top device
    operations and the idle time during each host phase, from a
    torch.profiler run (seconds).  Each card (`cards`, device indices;
    default those with events) has its own timeline: ``busy_s`` is the
    mean over the cards of each card's busy union (each listed in
    ``busy_s_per_device``) and a phase's idle the mean of the cards';
    kernel time is summed over the cards."""
    from torch.autograd import DeviceType

    events = prof.events()
    # device operations: kernels, copies and sets, not the ranges that
    # record_function marks on the device's timeline
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("phase:")]
    spans: dict = {}
    for e in dev:
        spans.setdefault(e.device_index, []).append(
            (e.time_range.start, e.time_range.end))
    merged = [_merge(spans.get(i, [])) for i in cards or sorted(spans)
              or [None]]
    kernels: dict = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    idle: dict = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("phase:"):
            s, t = e.time_range.start, e.time_range.end
            name = e.name[len("phase:"):]
            idle[name] = idle.get(name, 0.0) + sum(
                (t - s) - _covered(m, s, t) for m in merged) / len(merged
                                                                  ) / 1e6
    busy = [sum(b - a for a, b in m) / 1e6 for m in merged]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(busy) / len(busy), "busy_s_per_device": busy,
            "kernel_s": kernels, "device_ops": [list(kv) for kv in top],
            "idle_gaps": [list(kv) for kv in gaps], "device_events": len(dev)}


def sync(cards) -> None:
    """Wait for the work queued on each card."""
    for d in cards:
        torch.cuda.synchronize(d)


def profile_proves(run, traffic, cards) -> dict:
    """PROFILED_PROVES proves of the traffic's next statements under
    torch.profiler (host and device activity on `cards`), before the
    window: the profile's summary (``read_profile``) with the traced
    window's host seconds.  The window then starts again from the first
    statement after set-up."""
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cards else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(PROFILED_PROVES):
            run(traffic.statement(traffic.warmup + k), collector())
        sync(cards)
        window = time.perf_counter() - t0
    info = read_profile(prof, [d.index for d in cards])
    info["traced_window_s"] = window
    info["proves"] = PROFILED_PROVES
    return info


def check(spec: dict, traffic: Traffic, kept: dict, records: list,
          seed: int, device) -> dict:
    """The numbers that decide `correct`, each with its limit: the
    sampled proof against the reference's proof of its statement
    (differing messages, a missing or extra one, differing publics; the
    reference on `device`), and, where statements repeat (a trace pool), the proofs that differ
    from the first proof of their statement."""
    from benchmark.reference import stark as ref

    ok = [r for r in records if r["digest"] is not None]
    checks = {}
    if traffic.kind == "trace":  # a statement repeats only in a pool
        first: dict = {}
        repeat = 0
        for r in ok:
            if first.setdefault(r["key"], r["digest"]) != r["digest"]:
                repeat += 1
        checks["repeat_mismatch"] = {"value": repeat, "limit": 0}
    if not ok:
        return checks
    sample = ok[random.Random(f"sample/{seed}").randrange(len(ok))]
    messages, publics = kept[sample["key"]]
    rspec = ref.Spec.from_config(spec)
    st = traffic.statement(sample["index"])
    if st.words is not None:
        cols = ref.columns_from_words(
            rspec, torch.from_numpy(st.words.astype("int64")))
    else:
        cols = ref.plain_trace(rspec, st.witness)
    t0 = time.perf_counter()
    want, want_pub = ref.prove(rspec, cols, device)
    bad = sum(a != b for a, b in zip(messages, want))
    bad += abs(len(messages) - len(want))
    bad += sum(publics.get(k) != v for k, v in want_pub.items())
    checks["ref_mismatch"] = {"value": bad, "limit": 0}
    print(f"reference: proof {sample['index']} (statement {sample['key']}), "
          f"{len(want)} messages, {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    return checks


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device="cuda", spec_override=None,
             prove_fn=None, warmup=None, devices=None) -> dict:
    """One run of `cell`: set-up, the window, the check; returns the
    result object.  `spec_override` (tests: a smaller trace, shards),
    `prove_fn` (the control, a broken program), `warmup` (the warm-up
    proves) and `devices` (tests: a device a shard, such as logical
    shards on one device) replace parts of the cell."""
    spec = dict(load_config(bench, cell), **(spec_override or {}))
    shards = shard_devices(spec, cell, device, devices)
    cards = cards_of(shards or [device])
    traffic = Traffic(load_mix(cell["traffic"]), spec, seed)
    if warmup is not None:
        traffic.warmup = warmup
    run = (prove_fn or program)(spec, device, shards)

    t_in = time.perf_counter()
    traffic.make_pool()
    t_warm = time.perf_counter()
    for i in range(traffic.warmup):
        run(traffic.statement(i), collector() if traced else None)
    sync(cards)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - T0
    print(f"set-up {setup_s:.3f} s: to the inputs {t_in - T0:.3f}, inputs "
          f"{t_warm - t_in:.3f}, {traffic.warmup} warm-up proves "
          f"{T0 + setup_s - t_warm:.3f}", file=sys.stderr)

    records, kept, phases = [], {}, {}
    prof_info = profile_proves(run, traffic, cards) if traced else None
    before = card_state(*cards)
    i, attempted, failed = traffic.warmup, 0, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        st = traffic.statement(i)
        mc = collector() if traced else None
        attempted += 1
        t0 = time.perf_counter()
        try:
            messages, publics = run(st, mc)
        except Exception:  # a failed prove is counted, and the run goes on
            traceback.print_exc()
            failed += 1
            messages = None
        wall = time.perf_counter() - t0
        rec = {"index": i, "key": st.key, "wall_s": wall, "digest": None,
               "end_s": t0 + wall - t_start}
        if messages is not None:
            rec["digest"] = digest(messages, publics)
            kept.setdefault(st.key, (messages, publics))
            for ph in (mc.phases if traced else ()):
                phases.setdefault(ph.name, []).append(ph.wall_s)
        records.append(rec)
        i += 1
    window_s = time.perf_counter() - t_start
    print(f"window {window_s:.3f} s: {attempted} proves, {failed} failed; "
          f"card before {before!r}, after {card_state(*cards)!r}",
          file=sys.stderr)
    # proofs/s in each quarter of the window, by when each proof ended:
    # where the spread of runs lies (within a run, or between them)
    quarter = window_s / 4
    ends = [min(3, int(r["end_s"] // quarter)) for r in records
            if r["digest"] is not None]
    print("window quarters proofs/s: " + " ".join(
        f"{ends.count(q) / quarter:.4f}" for q in range(4)), file=sys.stderr)
    walls = sorted(1e3 * r["wall_s"] for r in records)
    if len(walls) >= 4:
        q = statistics.quantiles(walls, n=4)
        print(f"prove walls ms: min {walls[0]:.3f} quartiles {q[0]:.3f} "
              f"{q[1]:.3f} {q[2]:.3f} max {walls[-1]:.3f}", file=sys.stderr)
    peak, peaks = card_peaks(cards)
    card = card_info(*cards)

    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    checks = check(spec, traffic, kept, records, seed,
                   cards[0] if cards else device)
    done = [r for r in records if r["digest"] is not None]
    record = {"spec": spec, "setup_s": setup_s, "window_s": window_s,
              "proofs": len(done), "walls_s": [r["wall_s"] for r in done],
              "peak_bytes": peak, "phases": phases, "profile": prof_info,
              "card": card}
    metrics = {}
    for m in cell_metrics(bench, cell, traced):
        # a quantity split between groups of cells (`q.witness`) is read
        # by its quantity's reader, benchmark/metrics/q.py
        reader = m["name"].split(".", 1)[0]
        value = importlib.import_module(f"benchmark.metrics.{reader}"
                                        ).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (attempted > 0 and failed == 0 and "ref_mismatch" in checks
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if cards else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
           "count": max(1, len(cards)), "memory_peak_bytes": peak,
           "memory_peak_bytes_per_device": peaks, **card}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and prof_info is not None:
        dev["busy_s"] = prof_info["busy_s"]
        dev["busy_s_per_device"] = prof_info["busy_s_per_device"]
        dev["window_s"] = prof_info["traced_window_s"]
        result["breakdown"] = {"device_ops": prof_info["device_ops"],
                               "idle_gaps": prof_info["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
