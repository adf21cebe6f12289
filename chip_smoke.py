#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stark_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from ``stark_tpu_torch/csrc``, holds each
kernel against its plain torch version on the card at the prover's
shapes (exact equality), proves the two golden vectors byte-identical to
``tests/vectors/golden_proofs.json``, then proves the Fibonacci-square
statement at 2^20 rows (blowup 4, 16 queries) twice: the two transcripts
must agree, the port's host verifier must accept the proof and reject it
with one byte flipped, and every kernel of the path must have launched.

``--profile`` then adds where a warm 2^20 prove spends its time: a
phase split synced after each phase, five warm walls, and one prove under
``torch.profiler`` (device busy time, the kernels' shares; the full table
goes to ``chiprun_out/profile_prove.txt``).

Needs one CUDA device; exits non-zero without one.  Imports nothing of
JAX.  The last line of standard output is the result object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

P = 3 * 2**30 + 1
SEED = 20261016
REPS = 5
# the slice's shapes: trace INTT 2^20, LDE 2^22 (+ two small NTT sizes);
# trees over the 2^22-point LDE; the prove at 2^20 rows, blowup 4
NTT_LOGS = (2, 9, 20, 22)
TREE_LOG = 22
PROVE = dict(log2_trace=20, blowup=4, num_queries=16)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the uint32 values the int32 tensors hold."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def rand_u32(rs, shape, bound, device) -> torch.Tensor:
    vals = rs.randint(0, bound, size=shape, dtype=np.int64)
    return torch.from_numpy(vals.astype(np.uint32).view(np.int32)).to(device)


class Results:
    """Per-kernel comparison records for the kernels line."""

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def check(self, kernel: str, what: str, got, want, ms=None,
              plain_ms=None) -> None:
        err = max_abs_err(got, want)
        timing = "" if ms is None else f"; kernel {ms:.4f} ms, plain " \
                                       f"{plain_ms:.4f} ms"
        log(f"{kernel} {what}: max_abs_err {err} (tolerance 0){timing}")
        if err != 0:
            raise AssertionError(f"{kernel} {what}: kernel != plain version")
        row = self.rows[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if ms is not None:
            row["ms"], row["plain_ms"] = ms, plain_ms


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    return name


def phase_build() -> None:
    from stark_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(os.path.basename(p) for p in paths.values())})")


def phase_kernels(res: Results, dev) -> None:
    """Every kernel against its plain version at the slice's shapes."""
    from stark_tpu_torch.channel.device_channel import absorb_stream
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.hash.cuda_chain import (FIRST_ROW, sha_chain,
                                                 sha_chain_plain)
    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_nodes
    from stark_tpu_torch.hash.sha256 import sha256_pairs, sha256_u64_leaves
    from stark_tpu_torch.merkle.tree import build_tree, level_offsets
    from stark_tpu_torch.ntt.cuda_ntt import ntt_plain, ntt_two_step
    from stark_tpu_torch.stark.prover import query_plan

    rs = np.random.RandomState(SEED)
    # K1: trace INTT (2^20), LDE (2^22), and two small sizes
    for log_n in NTT_LOGS:
        x = rand_u32(rs, 1 << log_n, P, dev)
        for inverse in (False, True):
            got = ntt_two_step(x, P, inverse)
            want = ntt_plain(x, P, inverse)
            timed = log_n == NTT_LOGS[-1] and not inverse  # LDE shape
            ms = cuda_ms(lambda: ntt_two_step(x, P, inverse)) if timed else None
            pms = cuda_ms(lambda: ntt_plain(x, P, inverse)) if timed else None
            res.check("K1", f"{'intt' if inverse else 'ntt'} n=2^{log_n}",
                      got, want, ms, pms)

    # K3: the LDE's 2^22 leaves
    n = 1 << TREE_LOG
    vals = rand_u32(rs, n, P, dev)
    res.check("K3", f"leaves n=2^{TREE_LOG}",
              sha_leaves(vals), sha256_u64_leaves(vals),
              cuda_ms(lambda: sha_leaves(vals)),
              cuda_ms(lambda: sha256_u64_leaves(vals)))

    # K4: the 2^21-node level above those leaves, then a whole tree
    kids = rand_u32(rs, (n, 8), 1 << 32, dev)
    res.check("K4", f"nodes m=2^{TREE_LOG - 1}",
              sha_nodes(kids), sha256_pairs(kids),
              cuda_ms(lambda: sha_nodes(kids)),
              cuda_ms(lambda: sha256_pairs(kids)))
    tree = build_tree(vals)
    plain = torch.empty_like(tree)
    offs = level_offsets(n)
    plain[:n] = sha256_u64_leaves(vals)
    for (oc, sc), (op, sp) in zip(offs, offs[1:]):
        plain[op:op + sp] = sha256_pairs(plain[oc:oc + sc])
    res.check("K4", f"full tree n=2^{TREE_LOG} (K3 + {TREE_LOG} K4 levels)",
              tree, plain)

    # K5: the streams the prove sends it, with seeded openings.  First
    # the fresh channel's first absorb on its own (3 blocks, FIRST_ROW
    # layout); then one chain of a later absorb, one query of the 2^20
    # configuration (built by the prover's own query plan) and a
    # reset-only row
    root = rand_u32(rs, 8, 1 << 32, dev)
    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    s0, f0 = absorb_stream(root, initial=True)
    res.check("K5", f"first absorb ({s0.shape[0]} blocks)",
              sha_chain(s0, f0, zero), sha_chain_plain(s0, f0, zero))
    plan = query_plan(ProverConfig(**PROVE))
    nv, nd = len(plan._val_rows), len(plan._dig_rows)
    sq, fq = plan.stream(rand_u32(rs, nv, P, dev),
                         rand_u32(rs, (nd, 8), 1 << 32, dev))
    s1, f1 = absorb_stream(root, initial=False)
    reset = torch.tensor([[FIRST_ROW, 1]], dtype=torch.int32, device=dev)
    stream = torch.cat([s1, sq, rand_u32(rs, (1, 16), 1 << 32, dev)])
    fl = torch.cat([f1, fq, reset])
    chain = rand_u32(rs, 8, 1 << 32, dev)
    res.check("K5", f"absorb + 2^{PROVE['log2_trace']} query + reset row "
              f"({stream.shape[0]} blocks)",
              sha_chain(stream, fl, chain),
              sha_chain_plain(stream, fl, chain),
              cuda_ms(lambda: sha_chain(stream, fl, chain)),
              cuda_ms(lambda: sha_chain_plain(stream, fl, chain)))


def phase_golden(dev) -> None:
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import StarkProof, prove

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "vectors", "golden_proofs.json")
    with open(path) as fh:
        vectors = json.load(fh)
    cases = {
        "fib_gf97_2e2": (ProverConfig(modulus=97, generator=5, log2_trace=2,
                                      blowup=4, num_queries=2), 3),
        "fib_stark101_2e6": (ProverConfig(log2_trace=6, blowup=8,
                                          num_queries=4), 3141592),
    }
    for name, (cfg, a1) in cases.items():
        got = prove(cfg, a1=a1, device=dev).proof
        want = StarkProof.deserialize(json.dumps(vectors[name]).encode()).proof
        if got != want:
            raise AssertionError(f"golden vector {name}: transcript differs")
        log(f"golden {name}: {len(got)} messages, byte-identical")


def counters() -> dict:
    from stark_tpu_torch.hash.cuda_chain import sha_chain
    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_nodes
    from stark_tpu_torch.ntt.cuda_ntt import ntt_two_step

    return {"K1": ntt_two_step, "K3": sha_leaves, "K4": sha_nodes,
            "K5": sha_chain}


def phase_prove(res: Results, dev) -> None:
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import (StarkProof, StarkVerificationError,
                                       prove, verify)

    cfg = ProverConfig(**PROVE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    cold = prove(cfg, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    warm = prove(cfg, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"prove {PROVE}: cold {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s, peak device memory {peak / 2**20:.1f} MiB, "
        f"{len(cold.proof)} messages, {cold.size_bytes()} bytes")
    log(f"launches during the cold prove: {launches}")
    if cold.proof != warm.proof:
        raise AssertionError("2^20 prove is not deterministic")
    blob = cold.serialize()
    if not verify(StarkProof.deserialize(blob), expected_config=cfg):
        raise AssertionError("verifier rejected the 2^20 proof")
    tampered = StarkProof.deserialize(blob)
    k = len(tampered.proof) // 2
    msg = bytearray(tampered.proof[k])
    msg[0] ^= 1
    tampered.proof[k] = bytes(msg)
    try:
        verify(tampered)
    except StarkVerificationError as e:
        log(f"tampered proof (message {k}) rejected: {str(e)[:80]}")
    else:
        raise AssertionError("verifier accepted a tampered proof")
    log("2^20 proof deterministic and accepted by the host verifier")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched in the prove")
        res.rows[name]["launches"] = count


def phase_split(cfg, dev) -> dict:
    """One prove's steps as ``prove()`` runs them, with the wall of each
    in ms (``torch.cuda.synchronize()`` after each step)."""
    from stark_tpu_torch.channel.channel import Channel
    from stark_tpu_torch.channel.device_channel import DeviceFS, absorb_value
    from stark_tpu_torch.fields.fp import upload_u32
    from stark_tpu_torch.fri.commit import fri_commit
    from stark_tpu_torch.merkle.tree import MerkleTree
    from stark_tpu_torch.ntt.ntt import coset_evaluate
    from stark_tpu_torch.stark.air import FibonacciSquareAIR
    from stark_tpu_torch.stark.prover import get_air_context, query_plan
    from stark_tpu_torch.stark.trace import trace_polynomial

    out = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = round((now - t) * 1e3, 3)
        t = now

    air, p, h = FibonacciSquareAIR(), cfg.modulus, cfg.offset
    plan = query_plan(cfg)
    host = air.host_trace(cfg)
    mark("host trace")
    trace = upload_u32(host, dev)
    mark("upload")
    coeffs = trace_polynomial(trace, p)
    mark("trace INTT (K1) + correction")
    lde = coset_evaluate(coeffs, p, cfg.eval_domain_size, h)
    mark("scale-pad + LDE NTT (K1)")
    tree = MerkleTree(lde)
    mark("trace tree (K3+K4)")
    fs = DeviceFS(p, Channel(p).state, device=dev)
    fs.absorb_root(tree.root_digest)
    alphas = tuple(fs.draw() for _ in range(air.num_alphas))
    mark("FS absorb + draws (K5)")
    cp = get_air_context(air, cfg, dev).compose(
        lde, alphas, air.publics_from_host(host))
    mark("composition")
    fri = fri_commit(cp, p, h, fs, num_folds=len(plan.fri_lengths) - 1)
    mark("FRI commit")
    last = fri.fri_layers[-1]
    fs.state = absorb_value(fs.state, torch.zeros_like(last[0]), last[0])
    dev_out = plan.run_device(fs.state, lde, tree.buffer, fri.values,
                              fri.digests)
    mark("query phase (K5 per query)")
    torch.cat([x.reshape(-1).to(torch.int32)
               for x in (*fs.payloads(), last, *dev_out)]).cpu()
    mark("fetch")
    return out


def busy_us(events) -> float:
    """Length of the union of the events' time intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def phase_profile(dev) -> None:
    """Where a warm 2^20 prove spends its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import prove

    cfg = ProverConfig(**PROVE)
    prove(cfg, device=dev)
    for _ in range(3):
        split = phase_split(cfg, dev)
    log(f"phase split ms (synced after each, third of 3 runs): "
        f"{json.dumps(split)}; sum {sum(split.values()):.3f}")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove(cfg, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    log(f"warm prove walls ms: {[round(w, 3) for w in walls]}; "
        f"median {wall:.3f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove(cfg, device=dev)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not gpu:
        raise AssertionError("torch.profiler saw no device events")
    busy = busy_us(gpu) / 1e3
    ka = prof.key_averages()
    dev_sum = sum(e.self_device_time_total for e in ka
                  if e.device_type == DeviceType.CUDA) / 1e3
    all_sum = sum(e.self_device_time_total for e in ka) / 1e3
    log(f"profiled prove: wall {prof_wall:.3f} ms; {len(gpu)} device "
        f"events; device busy {busy:.3f} ms (union of device event "
        f"intervals), sum of device rows {dev_sum:.3f} ms, sum of all rows "
        f"{all_sum:.3f} ms (host-op rows repeat their kernels' time); idle "
        f"share of the median warm wall {1 - busy / wall:.4f}")
    rows = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    for e in rows[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
            f"{e.key[:90]}")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_prove.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_device_time_total", row_limit=60,
                          max_name_column_width=90))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a warm 2^20 prove")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs one CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import stark_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda:0")
    kind = phase_device()
    phase_build()
    res = Results()
    src = {"K1": ("stark_tpu_torch/csrc/ntt.cu",
                  "stark_tpu/ntt/pallas_ntt.py:188"),
           "K3": ("stark_tpu_torch/csrc/sha256_tree.cu",
                  "stark_tpu/hash/pallas_sha.py:100"),
           "K4": ("stark_tpu_torch/csrc/sha256_tree.cu",
                  "stark_tpu/hash/pallas_sha.py:124"),
           "K5": ("stark_tpu_torch/csrc/sha_chain.cu",
                  "stark_tpu/hash/pallas_chain.py:80")}
    for name, (source, replaces) in src.items():
        res.rows[name] = {"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": 0,
                          "max_abs_err": 0, "ms": None, "plain_ms": None}
    phase_kernels(res, dev)
    phase_golden(dev)
    phase_prove(res, dev)
    if args.profile:
        phase_profile(dev)
    print(json.dumps({"kernels": list(res.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
