"""The port's multi-process prove (``stark_tpu_torch/dist/multihost.py``,
the process mesh of ``dist/mesh.py``) on the CPU under gloo: two real
processes over localhost, each with two logical CPU shards, a global
mesh of four.  One spawn of the pair runs every check of both ranks
(this file run as a script is the worker) and prints each rank's
results; the tests read them:

* the four-step NTT, INTT and coset evaluation and the sharded tree at
  2^10 points equal the single-device transforms and tree on both ranks
  (each rank's own blocks, and the blocks all-gathered);
* full proves of every statement of ``tests/vectors/mesh_digests.json``
  (blowup 4, 2 queries at 2^4 rows) give the JAX package's mesh digest
  for 4 shards and its single-device digest on both ranks, through
  ``multihost_prove(check_agreement=True)``; a per-phase prove and a
  ``prove_resumable`` stopped and resumed on the process mesh too;
* ``check_transcript_agreement`` passes on equal transcripts and raises
  on both ranks when rank 1's is corrupted;
* the bytes each rank's ``Mesh.stats`` counts, summed over the ranks,
  equal ``dist.comm``'s model for the process layout, and, on a mesh of
  one shard a rank, the scaling report's.

Then, in this process: K5's query form cut at the query boundary (its
plain version) equals the one-launch plain version on a one-process
mesh, and on two ranks' halves of the sources summed; and the
one-process glue of ``tests/test_utils_cli.py`` (``TestMultihostGlue``):
no process group, ``multihost_prove`` equal to ``prove``."""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from stark_tpu_torch.config import ProverConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GL = dict(modulus=2**64 - 2**32 + 1, generator=7)
KW = dict(log2_trace=4, blowup=4, num_queries=2)
LOG_N = 10
P = 3 * 2**30 + 1
SEED = 20261017
SPAWN_TIMEOUT = 240


def _statements():
    from stark_tpu_torch.stark import FibMulAIR, MimcAIR
    from stark_tpu_torch.stark.air import FibonacciSquareAIR
    from stark_tpu_torch.stark.families import FAMILIES

    return {
        "fib-sq": ({}, FibonacciSquareAIR(a1=3141592)),
        "mimc3": ({}, MimcAIR(x0=271828, k=777)),
        "fibmul": ({}, FibMulAIR(a0=1, b0=2718281)),
        "fib-sq-GL": (GL, FibonacciSquareAIR(a1=3141592)),
        "tribmul": ({}, FAMILIES["tribmul"][0]()),
    }


def _digest(messages) -> str:
    return hashlib.sha256(b"".join(messages)).hexdigest()


def _seeded(shape, seed, bound=P):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, bound, size=shape, dtype=np.int64)
                            .astype(np.uint32).view(np.int32))


# -- the worker: one rank of the pair ----------------------------------------
def _worker(rank: int, port: int) -> dict:
    from stark_tpu_torch.channel.channel import Channel
    from stark_tpu_torch.dist import (dist_coset_evaluate, dist_intt,
                                      dist_merkle_tree, dist_ntt,
                                      distributed_initialize, global_mesh,
                                      make_mesh, multihost_prove,
                                      process_info)
    from stark_tpu_torch.dist.multihost import check_transcript_agreement
    from stark_tpu_torch.fields.fp import Fp
    from stark_tpu_torch.merkle.tree import MerkleTree
    from stark_tpu_torch.ntt.ntt import coset_evaluate, intt, ntt
    from stark_tpu_torch.stark import (ProverCheckpoint, prove,
                                       prove_resumable)
    from stark_tpu_torch.stark import prover as tprover
    from stark_tpu_torch.stark.prover import query_plan

    torch.set_num_threads(2)
    distributed_initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    out = {"rank": rank, "process_info": list(process_info())}
    mesh = make_mesh(devices=["cpu"] * 2, backend="gloo")
    out["mesh"] = {"size": mesh.size, "local": list(mesh.local),
                   "ranks": list(mesh.ranks),
                   "global_mesh_ranks": list(global_mesh(
                       devices=["cpu"] * 2).ranks)}

    # the dist layer at 2^10 points against the single-device results
    checks = {}
    x = _seeded((1 << LOG_N,), SEED)
    k = x.numel() // mesh.size
    for name, fn, want in (("ntt", dist_ntt, ntt(x, P)),
                           ("intt", dist_intt, intt(x, P))):
        got = fn(x, P, mesh)
        checks[f"{name} own blocks"] = all(
            torch.equal(got.blocks[i], want[i * k:(i + 1) * k])
            for i in mesh.local) and [i for i, b in enumerate(got.blocks)
                                      if b is not None] == list(mesh.local)
        checks[f"{name} joined"] = torch.equal(got.join(), want)
    cols = torch.stack([x[:256], x[256:512]])
    checks["coset_evaluate two columns"] = torch.equal(
        dist_coset_evaluate(cols, P, 1 << LOG_N, 7, mesh).join(),
        coset_evaluate(cols, P, 1 << LOG_N, 7))
    tree = dist_merkle_tree(x, mesh)
    single = MerkleTree(x)
    checks["tree root"] = tree.root() == single.root()
    sub = single.levels
    checks["tree own subtrees"] = all(
        torch.equal(tree.subtrees[i].levels[0], sub[0][i * k:(i + 1) * k])
        for i in mesh.local)
    out["checks"] = checks

    # full proves of the pinned statements, with each prove's copies
    proves = {}
    for name, (field, air) in _statements().items():
        cfg = ProverConfig(**KW, **field)
        pr = multihost_prove(cfg, air=air, devices=["cpu"] * 2,
                             check_agreement=True)
        mesh.reset_stats()
        again = prove(cfg, air=air, mesh=mesh)
        plan = query_plan(cfg, air, shards=mesh.size).pack("cpu")
        proves[name] = {
            "digest": _digest(pr.proof), "again": _digest(again.proof),
            "path": tprover.LAST_PROVE_PATH, "publics": pr.publics,
            "stats": {k: b for k, (_, b) in mesh.stats.items()},
            "num_folds": air.num_folds(cfg),
            "halo": max(air.shifts) * cfg.blowup,
            "columns": air.num_columns,
            "elem": 4 * Fp.get(cfg.modulus).width,
            "query_words": plan.num_values + 8 * (
                int(plan.slots.shape[0]) - plan.num_values)}
    out["proves"] = proves

    # one shard a rank, the layout the scaling report models
    one = make_mesh(devices=["cpu"], backend="gloo")
    prove(ProverConfig(**KW), mesh=one)
    out["one_shard_stats"] = {k: b for k, (_, b) in one.stats.items()}

    # the per-phase path and a resumed prove on the process mesh
    cfg = ProverConfig(**KW)
    ch = Channel(cfg.modulus)
    ch.phase_accurate = True
    pr = prove(cfg, mesh=mesh, channel=ch)
    out["per_phase"] = [_digest(pr.proof), tprover.LAST_PROVE_PATH]
    ckpt = prove_resumable(cfg, stop_after="composition", mesh=mesh)
    resumed = prove_resumable(
        cfg, resume=ProverCheckpoint.deserialize(ckpt.serialize()),
        mesh=mesh)
    out["resumed"] = [ckpt.phase, _digest(resumed.proof)]

    # transcript agreement: equal, then rank 1 corrupted
    check_transcript_agreement(pr.proof)
    bad = list(pr.proof)
    if rank == 1:
        bad[0] = bytes([bad[0][0] ^ 1]) + bad[0][1:]
    try:
        check_transcript_agreement(bad)
        out["corrupted_detected"] = False
    except RuntimeError as e:
        out["corrupted_detected"] = "divergence" in str(e)
    return out


def _main() -> None:
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    res = _worker(rank, port)
    print("RESULT " + json.dumps(res), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


# -- the tests ---------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks():
    """Both ranks' results, from one spawn of the pair."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    results = []
    for pr, (stdout, stderr) in zip(procs, outs):
        assert pr.returncode == 0, stderr[-4000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert line, stdout + stderr[-4000:]
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


@pytest.fixture(scope="module")
def vectors():
    with open(os.path.join(ROOT, "tests", "vectors",
                           "mesh_digests.json")) as fh:
        vec = json.load(fh)
    assert vec["config"] == KW
    return vec["statements"]


def test_group_and_global_mesh(ranks):
    for r, res in enumerate(ranks):
        assert res["process_info"] == [r, 2]
        assert res["mesh"] == {"size": 4, "local": [2 * r, 2 * r + 1],
                               "ranks": [0, 0, 1, 1],
                               "global_mesh_ranks": [0, 0, 1, 1]}


@pytest.mark.parametrize("check", [
    "ntt own blocks", "ntt joined", "intt own blocks", "intt joined",
    "coset_evaluate two columns", "tree root", "tree own subtrees"])
def test_dist_layer_equals_single_device(ranks, check):
    for res in ranks:
        assert res["checks"][check], (res["rank"], check)


@pytest.mark.parametrize("name", ["fib-sq", "mimc3", "fibmul", "fib-sq-GL",
                                  "tribmul"])
def test_multihost_prove_equals_jax_digests(ranks, vectors, name):
    want = vectors[name]
    for res in ranks:
        got = res["proves"][name]
        assert got["digest"] == got["again"] == want["single"] \
            == want["mesh"]["4"]
        assert got["path"] == "single-fetch-mesh"
        assert got["publics"] == want["publics"]


def test_per_phase_and_resume_on_the_process_mesh(ranks, vectors):
    want = vectors["fib-sq"]["single"]
    for res in ranks:
        assert res["per_phase"] == [want, "per-phase-mesh"]
        assert res["resumed"] == ["composition", want]


def test_transcript_agreement_detects_a_corrupted_rank(ranks):
    assert [res["corrupted_detected"] for res in ranks] == [True, True]


@pytest.mark.parametrize("name", ["fib-sq", "fibmul", "fib-sq-GL",
                                  "tribmul"])
def test_summed_stats_equal_the_model(ranks, name):
    from stark_tpu_torch.dist.comm import prove_collectives, stats_bytes

    got = {}
    for res in ranks:
        for kind, b in res["proves"][name]["stats"].items():
            got[kind] = got.get(kind, 0) + b
    pv = ranks[0]["proves"][name]
    model = stats_bytes(prove_collectives(
        KW["log2_trace"], KW["blowup"], 4, pv["num_folds"], pv["halo"],
        pv["columns"], pv["elem"], ranks=2, query_words=pv["query_words"],
        num_queries=KW["num_queries"]))
    assert got == model
    assert "scatter" not in got and got["query"] > 0


def test_scaling_report_counts_what_the_ranks_send(ranks):
    """The scaling report's bytes for two cards, one process each, are
    what two one-shard ranks' ``Mesh.stats`` sum to over a fib-sq prove
    (the query all-reduces, which the report leaves out, aside)."""
    from stark_tpu_torch.dist.comm import scaling_report

    got = {}
    for res in ranks:
        for kind, b in res["one_shard_stats"].items():
            got[kind] = got.get(kind, 0) + b
    row = scaling_report(KW["log2_trace"], KW["blowup"],
                         device_counts=(2,))["rows"][0]
    assert row["wire_bytes_by_kind"] == {k: b for k, b in got.items()
                                         if k != "query"}
    assert got["query"] > 0 and got["ntt"] > 0


def _mesh_sources(cfg, air, mesh, seed):
    """Seeded query sources laid out as a mesh prove lays them out."""
    from stark_tpu_torch.dist import dist_merkle_tree, sharded
    from stark_tpu_torch.dist.comm import sharded_layers
    from stark_tpu_torch.merkle.tree import MerkleTree

    M = cfg.eval_domain_size
    lde = _seeded((M,), seed, 2**32)
    lengths = [M >> k for k in range(air.num_folds(cfg) + 1)]
    ls = sharded(mesh, lde)
    fv, fd = [], []
    for j, (ln, sh) in enumerate(zip(lengths, sharded_layers(
            M, mesh.size, len(lengths) - 1))):
        v = _seeded((ln,), seed + 1 + j, 2**32)
        vs = sharded(mesh, v) if sh else None
        fv += list(vs.blocks) if sh else [v]
        fd += (dist_merkle_tree(vs, mesh) if sh else MerkleTree(v)).entries
    return (list(ls.blocks), dist_merkle_tree(ls, mesh).entries, fv, fd)


def test_cut_query_form_equals_the_one_launch_form():
    """The cut form's plain version on a one-process mesh equals the
    one-launch plain version; so do two ranks of a process mesh run in
    lockstep (two threads whose all-reduce sums their query words), each
    reading only its half of the block entries and the replicated ones
    on rank 0 alone."""
    import threading

    from stark_tpu_torch.channel import device_query as dq
    from stark_tpu_torch.dist import make_mesh
    from stark_tpu_torch.stark.air import FibonacciSquareAIR
    from stark_tpu_torch.stark.prover import query_plan

    cfg = ProverConfig(log2_trace=4, blowup=4, num_queries=3)
    tb = query_plan(cfg, FibonacciSquareAIR(), shards=4).pack("cpu")
    srcs = _mesh_sources(cfg, FibonacciSquareAIR(),
                         make_mesh(devices=["cpu"] * 4), SEED + 50)
    chain = _seeded((8,), SEED + 60, 2**32)
    want = dq.query_chain_plain(chain, *srcs, tb)
    got = dq.query_chain_cut(chain, *srcs, tb)
    assert dq.query_chain_cut.launches == 0  # the CPU runs the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    # each block entry's rank: the four blocks (or subtrees) of a source
    # run in shard order, two a rank
    owner, run = [], 0
    for rep in tb.replicated:
        owner.append(None if rep else run // 2)
        run = 0 if rep else (run + 1) % 4
    assert owner.count(None) < len(owner)
    barrier, rows = threading.Barrier(2), [None, None]

    class Rank:
        process = True

        def __init__(self, rank):
            self.rank = rank

        def all_reduce_(self, t, kind):
            rows[self.rank] = t.clone()
            barrier.wait(timeout=60)
            total = rows[0] + rows[1]
            barrier.wait(timeout=60)
            t.copy_(total)

    results = [None, None]

    def run_rank(rank):
        it = iter(t if o is None or o == rank else None
                  for t, o in zip(dq.source_entries(tb, srcs), owner))
        parts = [[next(it) for _ in sizes] for sizes in tb.entries]
        results[rank] = dq.query_chain_cut_plain(chain.clone(), *parts, tb,
                                                 mesh=Rank(rank))

    threads = [threading.Thread(target=run_rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for res in results:
        for g, w in zip(res, want):
            assert torch.equal(g, w)


def test_write_scaling_report_takes_its_path(tmp_path):
    """The projection over 1, 2 and 4 cards (one process a card) on the
    H100's data-sheet rates, written where the caller says; one card
    sends nothing and is the efficiency's reference."""
    from stark_tpu_torch.dist.comm import (HBM_GBPS, NVLINK_GBPS,
                                           write_scaling_report)

    path = tmp_path / "scaling.json"
    rep = write_scaling_report(str(path), log2_trace=10, blowup=4,
                               device_counts=(1, 2, 4))
    assert json.loads(path.read_text()) == rep
    assert (rep["hbm_gbps"], rep["link_gbps"]) == (HBM_GBPS, NVLINK_GBPS)
    rows = rep["rows"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert rows[0]["wire_bytes"] == 0 and rows[0]["efficiency"] == 1.0
    assert all(r["wire_bytes"] == sum(r["wire_bytes_by_kind"].values()) > 0
               for r in rows[1:])


def test_single_process_initialize_is_a_noop():
    from stark_tpu_torch.dist import distributed_initialize, process_info

    distributed_initialize(num_processes=1)
    import torch.distributed as dist

    assert not dist.is_initialized()
    idx, cnt = process_info()
    assert idx == 0 and cnt >= 1


def test_multihost_prove_single_process():
    from stark_tpu_torch.dist import multihost_prove
    from stark_tpu_torch.stark import prove, verify

    cfg = ProverConfig(log2_trace=6, blowup=4, num_queries=2)
    pr = multihost_prove(cfg, backend="cpu")
    assert pr.proof == prove(cfg, device="cpu").proof
    assert verify(pr)


def test_rank_device_without_a_card_raises(monkeypatch):
    """A process mesh's default card needs a visible CUDA device: without
    one it is a clear ValueError, whatever LOCAL_RANK says."""
    from stark_tpu_torch.dist.mesh import rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for local in (None, "1"):
        if local is None:
            monkeypatch.delenv("LOCAL_RANK", raising=False)
        else:
            monkeypatch.setenv("LOCAL_RANK", local)
        with pytest.raises(ValueError, match="no CUDA device"):
            rank_device()


if __name__ == "__main__":
    _main()
