"""Top-level STARK prover (counterpart of ``stark_tpu/stark/prover.py``),
generic over the AIR (``stark/air.py``: Fibonacci-square, MiMC³, the
two-column FibMul; the declarative AirSpecs) and over the field: a u32
prime, or the Goldilocks prime 2^64 - 2^32 + 1, whose values are (hi, lo)
limb planes, whose NTTs are torch ops (``ntt/ntt.py``) and whose trees
take K3's 64-bit mode.

    host trace -> trace polynomial (INTT, K1/K2) -> coset LDE (NTT,
    K1/K2; a C-column trace as one batched transform each) -> trace
    Merkle tree (K3, its row form for C > 1, and K4; pruned and, from
    2^27 leaves, chunked) -> device Fiat-Shamir absorb + alpha draws (K5)
    -> composition -> FRI fold + per-layer tree + absorb -> device query
    phase (one launch of K5's query form, row openings of C values, the
    pruned levels' siblings recomputed in it) -> ONE device->host copy ->
    host transcript replay -> StarkProof

That is the single-fetch path: everything after the trace upload stays on
the device with a device-resident Fiat-Shamir state; the host replays the
canonical transcript from a single ``.cpu()`` of the packed outputs and
checks that every device-derived challenge equals the host derivation,
so the proof bytes are identical to the JAX package's.

The per-phase path gives the same bytes with the transcript on the host
channel at each phase boundary: a phase-accurate channel (checkpoint /
resume's ``ReplayChannel``), ``STARK_TPU_TORCH_HOST_QUERIES`` or
``STARK_TPU_TORCH_PHASE_SYNC``, or a configuration the device query plan
does not take, as the JAX package's gate decides.  Its trees are stored
whole; the trace commit and the FRI commit each end in one fetch and a
replay, and the queries run on the device plan (one fetch) or, when it
does not take the configuration or under ``STARK_TPU_TORCH_HOST_QUERIES``,
as one BatchGather a query.

With `mesh` (a ``dist.mesh.Mesh``) the same two paths run sharded: the
LDE through the four-step ``dist_coset_evaluate``, the trees through
``dist_merkle_tree``, the composition shard by shard with a halo
(``dist/compose.py``), the FRI commit folding as
``dist.comm.fri_fold_schedule`` says, and, in one process, the query
phase as one launch of K5's query form reading every shard from the
first, where the Fiat-Shamir state lives; the single-fetch path still
ends in one fetch.  The transcript is byte-identical to the
single-device prove's.

Over a process mesh (``dist/multihost.py``) every rank runs this same
prove, as the JAX package's rank-0-transcript convention has it: the
host trace and its INTT whole, its own blocks of everything sharded,
each exchange a collective of the process group, and its own Fiat-Shamir
state on its first shard, which absorbs the same replicated roots and so
draws the same challenges.  The query phase is K5's query form cut at
the query boundary (``channel/device_query.py`` ``query_chain_cut``);
each rank ends in its one fetch and replay, with a ``StarkProof`` on
every rank.  The per-phase path runs there too on the device query
plan; the per-query BatchGather loop, which reads every shard, does not.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from stark_tpu_torch.channel import compress as _compress
from stark_tpu_torch.channel import device_query as _dq
from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.channel.device_channel import DeviceFS, absorb_value
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.dist.compose import compose_sharded
from stark_tpu_torch.dist.merkle import dist_merkle_tree
from stark_tpu_torch.dist.ntt import dist_coset_evaluate
from stark_tpu_torch.fields.fp import Fp, upload_u32
from stark_tpu_torch.fri.commit import (collect_query_arrays, emit_plan,
                                        finish_deferred, fri_commit,
                                        host_queries, open_layout,
                                        plan_fri_query)
from stark_tpu_torch.merkle.tree import MerkleTree, prune_depths
from stark_tpu_torch.ntt.ntt import coset_evaluate
from stark_tpu_torch.stark.air import FibonacciSquareAIR
from stark_tpu_torch.stark.trace import trace_polynomial
from stark_tpu_torch.utils import metrics as _metrics
from stark_tpu_torch.utils.debug import maybe_assert_canonical
from stark_tpu_torch.utils.gather import BatchGather, fetch_packed

# which pipeline the last prove() took: "single-fetch" or "per-phase",
# with "-mesh" after it for a sharded prove
LAST_PROVE_PATH: str | None = None


@dataclasses.dataclass
class StarkProof:
    """A complete proof: the transcript plus the public statement.

    `a0` / `a_last` are the first two publics of the AIR (the first and
    last trace values of Fibonacci-square, named a0 / a_last; input /
    output for every other AIR); AIRs with more statement data put it in
    `extra_publics`."""

    proof: list[bytes]
    a0: int
    a_last: int
    config: ProverConfig
    air_name: str = "fibonacci-square"
    extra_publics: dict | None = None

    @property
    def publics(self) -> dict:
        if self.air_name == FibonacciSquareAIR.name:
            base = {"a0": self.a0, "a_last": self.a_last}
        else:
            base = {"input": self.a0, "output": self.a_last}
        if self.extra_publics:
            base.update(self.extra_publics)
        return base

    def size_bytes(self) -> int:
        return sum(len(m) for m in self.proof)

    def compressed_size_bytes(self) -> int:
        """Transcript size under the node-dedup compression of the STP1
        container (``channel/compress.py``)."""
        return _compress.compressed_size(self.proof)

    def _header(self) -> dict:
        return {
            "config": {
                "modulus": self.config.modulus,
                "generator": self.config.generator,
                "log2_trace": self.config.log2_trace,
                "blowup": self.config.blowup,
                "num_queries": self.config.num_queries,
            },
            "air": self.air_name,
            "a0": self.a0,
            "a_last": self.a_last,
            "extra_publics": self.extra_publics,
        }

    def serialize(self, compress: bool = False) -> bytes:
        """JSON (default) or, with `compress=True`, the binary container
        `"STP1" varint(header_len) header_json compressed_transcript`
        (``channel/compress.py``), both in the JAX package's format."""
        if compress:
            header = json.dumps(self._header()).encode()
            return (b"STP1" + _compress._varint(len(header)) + header
                    + _compress.compress_messages(self.proof))
        obj = self._header()
        obj["proof"] = [m.hex() for m in self.proof]
        return json.dumps(obj).encode()

    @classmethod
    def deserialize(cls, data: bytes) -> "StarkProof":
        if data[:4] == b"STP1":
            hlen, pos = _compress._read_varint(data, 4)
            obj = json.loads(data[pos:pos + hlen].decode())
            messages = _compress.decompress_messages(data[pos + hlen:])
        else:
            obj = json.loads(data.decode())
            messages = [bytes.fromhex(m) for m in obj["proof"]]
        c = obj["config"]
        return cls(
            proof=messages,
            a0=obj["a0"],
            a_last=obj["a_last"],
            config=ProverConfig(
                modulus=c["modulus"], generator=c["generator"],
                log2_trace=c["log2_trace"], blowup=c["blowup"],
                num_queries=c["num_queries"]),
            air_name=obj.get("air", "fibonacci-square"),
            extra_publics=obj.get("extra_publics"),
        )


_CTX_CACHE: dict = {}


def get_air_context(air, cfg: ProverConfig, device, block=None):
    """Per-(AIR, config, device, block) context cache (the inverse tables;
    MiMC's round key and an AirSpec's structure are part of its context;
    `block` the (start, size) lanes of a mesh shard's tables)."""
    key = (air.name, getattr(air, "k", None),
           getattr(air, "context_key", None), cfg, str(device), block)
    ctx = _CTX_CACHE.get(key)
    if ctx is None:
        ctx = _CTX_CACHE[key] = air.context(cfg, device, block)
    return ctx


def _compose(air, cfg, f_evals, alphas, publics, device, mesh):
    """The composition on one device, or over the mesh shard by shard."""
    if mesh is None:
        return get_air_context(air, cfg, device).compose(f_evals, alphas,
                                                         publics)
    return compose_sharded(
        air, cfg, f_evals, alphas, publics,
        lambda block, dev: get_air_context(air, cfg, dev, block))


def _trace_tree(f_evals, air, wide: bool, mesh, prune: int = 0):
    """The trace commitment: a row-leaf tree for C > 1 columns; sharded
    over the mesh (never pruned) or on one device."""
    if mesh is not None:
        return dist_merkle_tree(f_evals, mesh, columns=air.num_columns > 1,
                                wide=wide)
    tree = MerkleTree.from_columns if air.num_columns > 1 else MerkleTree
    return tree(f_evals, wide=wide, prune=prune)


def query_plan(cfg: ProverConfig, air=None, pruned: bool = True,
               shards: int = 1) -> _dq.DeviceQueryPlan:
    """The device query plan of `air`'s prove of `cfg` (Fibonacci-square
    by default), built once per (configuration, trace offsets, fold
    count, column count, field width, tree prune depths, shards); pruned
    as ``merkle.tree.prune_depths`` says at the time of the call, or not
    at all with `pruned` false (the per-phase path's whole trees) or
    over a mesh of `shards` > 1 (whose trees are never pruned).  Raises
    ValueError for a configuration the plan does not take."""
    air = air or FibonacciSquareAIR()
    M, num_folds = cfg.eval_domain_size, air.num_folds(cfg)
    pruned = pruned and shards == 1
    offsets = tuple(s * cfg.blowup for s in air.shifts)
    fri_lengths = tuple(M >> k for k in range(num_folds + 1))
    (trace_prune,) = prune_depths((M,), pruned)
    return _dq.get_plan(M - max(offsets), cfg.num_queries, offsets, M,
                        fri_lengths, air.num_columns,
                        Fp.get(cfg.modulus).width, trace_prune,
                        prune_depths(fri_lengths, pruned), shards)


def prove(cfg: ProverConfig, a1: int = 3141592, *, air=None,
          device=None, metrics=None, channel: Channel | None = None,
          trace=None, strict: bool = True, mesh=None) -> StarkProof:
    """Prove a statement of `air` on `device` (default: Fibonacci-square
    with secret a_1): the card by default, where the kernels run; a CPU
    device runs their plain versions.

    `mesh`: prove sharded over a ``dist.mesh.Mesh`` (its devices; the
    trace and the Fiat-Shamir state on this process's first, which
    `device`, if given, must be; on a process mesh every rank calls
    this alike); the transcript is the single-device prove's.  The
    config's ``mesh_shape`` is not read (as in the JAX package).

    `channel`: the host transcript to continue (default a fresh one); a
    channel with ``phase_accurate`` set keeps the prove on the per-phase
    path.  `trace`: the AIR's trace as storage words (numpy or a tensor;
    (T,) / (C, T) u32, limb planes for Goldilocks), default
    ``air.host_trace(cfg)``.  `strict`: refuse a final FRI layer that is
    not constant (False emits the doomed transcript; testing only).

    Every prove records its phase walls (``trace-lde``, ``trace-commit``,
    ``composition``, ``fri-commit``, ``queries``) and the ``proves`` and
    ``proof_bytes`` counters: in ``utils.metrics.GLOBAL`` without
    synchronising the device, or in `metrics`, a MetricsCollector, with
    each phase ending in ``torch.cuda.synchronize()`` on a CUDA device.

    With ``STARK_TPU_TORCH_DEBUG`` set, the trace, the LDE, the
    composition and the FRI layers must hold canonical values
    (``utils/debug.py``; AssertionError otherwise)."""
    if mesh is not None:
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != mesh.first.type or (
                want.index is not None and want.index != mesh.first.index)):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.first}")
        device = mesh.first
        if cfg.eval_domain_size < 2 * mesh.size:
            raise ValueError(f"an LDE of {cfg.eval_domain_size} points "
                             f"does not shard over {mesh.size} shards")
    # a mesh of one shard is the single-device prove on its device
    tag = "" if mesh is None else "-mesh"
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    device = torch.device("cuda" if device is None else device)
    if air is None:
        air = FibonacciSquareAIR(a1=a1)
    air.validate(cfg)
    p, M, h = cfg.modulus, cfg.eval_domain_size, cfg.offset
    mx = metrics if metrics is not None else _metrics.GLOBAL
    devices = mesh.local_devices if mesh is not None else {device}

    def sync():
        if metrics is not None:
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    # -- trace + LDE: one upload of the host trace -------------------------
    # (T,), or (C, T) for C columns; (2, T) / (C, 2, T) for Goldilocks
    with mx.phase("trace-lde", n=M):
        trace_host = air.host_trace(cfg) if trace is None else (
            trace.cpu().numpy() if torch.is_tensor(trace) else trace)
        publics = air.publics_from_host(cfg, trace_host)
        trace_dev = upload_u32(trace_host, device)
        maybe_assert_canonical(trace_dev, p, "trace")
        coeffs = trace_polynomial(trace_dev, p)
        f_evals = (coset_evaluate(coeffs, p, M, h) if mesh is None
                   else dist_coset_evaluate(coeffs, p, M, h, mesh))
        maybe_assert_canonical(f_evals, p, "trace-LDE (post-NTT)")
        sync()

    # the JAX gate (stark_tpu/stark/prover.py:234-240): phase-accurate
    # channels need the transcript at each phase boundary
    width = Fp.get(p).width
    offsets = tuple(s * cfg.blowup for s in air.shifts)
    fri_lengths = tuple(M >> k for k in range(air.num_folds(cfg) + 1))
    rng = M - max(offsets)
    if channel is None:
        channel = Channel(p)
    single_fetch = (
        not getattr(channel, "phase_accurate", False)
        and not host_queries()
        and not os.environ.get("STARK_TPU_TORCH_PHASE_SYNC")
        and _dq.supported(rng, M, fri_lengths, air.num_columns, width))
    shards = 1 if mesh is None else mesh.size
    if single_fetch:
        return _prove_single_fetch(cfg, air, channel, f_evals, publics,
                                   query_plan(cfg, air, shards=shards), mx,
                                   sync, strict, device, mesh, tag)
    return _prove_per_phase(cfg, air, channel, f_evals, publics, offsets,
                            fri_lengths, mx, sync, strict, device, mesh, tag)


def _prove_single_fetch(cfg, air, channel, f_evals, publics, plan, mx,
                        sync, strict, device, mesh, tag) -> StarkProof:
    global LAST_PROVE_PATH
    LAST_PROVE_PATH = "single-fetch" + tag
    p, h = cfg.modulus, cfg.offset
    wide = Fp.get(p).width == 2
    num_folds = len(plan.fri_lengths) - 1

    with mx.phase("trace-commit", leaves=cfg.eval_domain_size):
        # pruned storage: each tree stores only its levels of at most
        # 2^PRUNE_KEEP_LOG nodes (merkle/tree.py), and the query phase
        # recomputes their siblings.  The dropped levels' scratch lives
        # for its phase only (the FRI trees share theirs), so the
        # composition, which sets the prove's peak, runs without it
        trace_tree = _trace_tree(f_evals, air, wide, mesh, plan.trace_prune)
        fs = DeviceFS(p, channel.state, device=device)
        fs.mark("trace-commit")
        fs.absorb_root(trace_tree.root_digest)
        alphas = tuple(fs.draw() for _ in range(air.num_alphas))
        sync()

    fs.mark("composition")
    with mx.phase("composition"):
        cp = _compose(air, cfg, f_evals, alphas, publics, device, mesh)
        maybe_assert_canonical(cp, p, "composition poly")
        sync()
    with mx.phase("fri-commit", folds=num_folds):
        fri = fri_commit(cp, p, h, channel, num_folds=num_folds, fs=fs,
                         defer=True, mesh=mesh)
        maybe_assert_canonical(fri.fri_layers, p, "FRI layers (post-fold)")
        sync()

    with mx.phase("queries", num_queries=cfg.num_queries):
        # the canonical transcript sends the final FRI constant before the
        # query draws: advance the device state over that send too
        last = fri.final_layer
        fs.state = absorb_value(fs.state, *final_words(last, wide))

        dev = plan.run_device(
            fs.state, f_evals,
            trace_tree.buffer if mesh is None else trace_tree.entries,
            fri.values, fri.digests)

        # THE one device->host copy: every payload, packed into one buffer
        n_pay = len(fs.payloads())
        fetched = fetch_packed([*fs.payloads(), last, *dev])
        payload_h, (last_h, final_h, idxs_h, vals_h, digs_h) = (
            fetched[:n_pay], fetched[n_pay:])

        fs.replay_fetched(channel, payload_h)
        fri.final_value = finish_deferred(p, last_h, channel, strict)
        channel.mark_phase("queries")
        plan.replay(channel, final_h, idxs_h, vals_h, digs_h)
    return _finish_proof(cfg, air, channel, publics, mx)


def _prove_per_phase(cfg, air, channel, f_evals, publics, offsets,
                     fri_lengths, mx, sync, strict, device, mesh,
                     tag) -> StarkProof:
    """The prove after the LDE with the host transcript complete at each
    phase boundary (stark_tpu/stark/prover.py:257-365): whole trees, one
    fetch and replay at the end of the trace commit and of the FRI
    commit, then the query phase on the device plan or the BatchGather
    loop."""
    global LAST_PROVE_PATH
    LAST_PROVE_PATH = "per-phase" + tag
    p, M, h = cfg.modulus, cfg.eval_domain_size, cfg.offset
    width = Fp.get(p).width
    ncols = air.num_columns
    num_folds = len(fri_lengths) - 1

    channel.mark_phase("trace-commit")
    with mx.phase("trace-commit", leaves=M):
        trace_tree = _trace_tree(f_evals, air, width == 2, mesh)
        fs = DeviceFS(p, channel.state, device=device)
        fs.absorb_root(trace_tree.root_digest)
        alphas = tuple(fs.draw() for _ in range(air.num_alphas))
        fs.finalize(channel)
        sync()

    channel.mark_phase("composition")
    with mx.phase("composition"):
        cp = _compose(air, cfg, f_evals, alphas, publics, device, mesh)
        maybe_assert_canonical(cp, p, "composition poly")
        sync()
    with mx.phase("fri-commit", folds=num_folds):
        fri = fri_commit(cp, p, h, channel, num_folds=num_folds,
                         strict=strict, mesh=mesh)
        maybe_assert_canonical(fri.fri_layers, p, "FRI layers (post-fold)")
        sync()

    channel.mark_phase("queries")
    with mx.phase("queries", num_queries=cfg.num_queries):
        rng = M - max(offsets)
        if not host_queries() and _dq.supported(rng, M, fri_lengths, ncols,
                                                width):
            shards = 1 if mesh is None else mesh.size
            query_plan(cfg, air, pruned=False, shards=shards).run(
                channel, f_evals,
                trace_tree.buffer if mesh is None else trace_tree.entries,
                fri.values, fri.digests, device=device)
        else:
            if mesh is not None and mesh.process:
                raise ValueError(
                    "the per-query BatchGather loop reads every shard: a "
                    "process mesh takes the device query plan only (unset "
                    "STARK_TPU_TORCH_HOST_QUERIES)")
            # one gather-row tensor a trace column (a Goldilocks column
            # as (M, 2) limb pairs); a "vrow" entry sends the row message
            # of all C values
            cols = (tuple(open_layout(f_evals[c]) for c in range(ncols))
                    if ncols > 1 else (open_layout(f_evals),))
            arrays, slots, open_layers = collect_query_arrays(
                fri.fri_layers, fri.fri_merkles,
                extra_arrays=(*cols, trace_tree.buffer))
            tslot = slots[id(trace_tree.buffer)]
            for _ in range(cfg.num_queries):
                idx = channel.receive_random_int(0, rng - 1, True)
                bg = BatchGather(arrays, mesh=mesh)
                plan = []
                for off in offsets:
                    plan.append(("vrow", [bg.want(slots[id(c)], idx + off)
                                          for c in cols]))
                    plan.append(("p", [bg.want(tslot, row) for row in
                                       trace_tree.path_rows(idx + off)]))
                plan += plan_fri_query(bg, slots, idx, open_layers,
                                       fri.fri_merkles)
                bg.run()
                emit_plan(plan, bg, channel)
        sync()
    return _finish_proof(cfg, air, channel, publics, mx)


def final_words(last: torch.Tensor, wide: bool):
    """(hi, lo) device words of the last FRI layer's first value, the
    constant the transcript sends (the high word 0 in a u32 field)."""
    if wide:
        return last[0, 0], last[1, 0]
    return torch.zeros_like(last[0]), last[0]


def _finish_proof(cfg, air, channel, publics, mx) -> StarkProof:
    """The proof of `publics` (the JAX rule: the first two publics are
    a0 / a_last, the rest go to extra_publics)."""
    mx.count("proves")
    mx.count("proof_bytes", sum(len(m) for m in channel.proof))
    pub_vals = list(publics.values())
    extra = {k: v for k, v in publics.items()
             if k not in ("a0", "a_last", "input", "output")}
    return StarkProof(proof=[bytes(m) for m in channel.proof],
                      a0=pub_vals[0], a_last=pub_vals[1], config=cfg,
                      air_name=air.name, extra_publics=extra or None)
