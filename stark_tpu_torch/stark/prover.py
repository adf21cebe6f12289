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

The mega path (``_prove_mega``, the JAX package's single-dispatch
prove and its default on its chip) takes a single-fetch prove of at most
2^20 LDE points on a card (``_use_mega``, the JAX gate, and its four
``STARK_TPU_TORCH_*MEGA*`` variables): everything after the LDE, as the
single-fetch path runs it, is captured once per (AIR, configuration,
placement) as one CUDA graph over static buffers (:class:`MegaProgram`,
cached on the AIR's context) and replayed on every later prove, after
the channel state, the LDE and the publics are refilled; then the same
one copy and host replay.  Its phases are ``prove-device`` and
``fetch-replay``.  On the CPU it runs only when forced, eagerly, over
the same buffers.

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

import contextlib
import dataclasses
import json
import os
import threading
import time
import warnings

import torch

from stark_tpu_torch.channel import compress as _compress
from stark_tpu_torch.channel import device_query as _dq
from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.channel.device_channel import (DeviceFS, absorb_value,
                                                    state_words)
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.dist.compose import compose_sharded
from stark_tpu_torch.dist.merkle import dist_merkle_tree
from stark_tpu_torch.dist.ntt import dist_coset_evaluate
from stark_tpu_torch.fields.fp import Fp, upload_u32
from stark_tpu_torch.fri.commit import (_inv_domain, collect_query_arrays,
                                        emit_plan, finish_deferred,
                                        fri_commit, host_queries,
                                        layer_layout, open_layout,
                                        plan_fri_query)
from stark_tpu_torch.merkle.tree import (MerkleTree, prune_depths,
                                         tree_scratch)
from stark_tpu_torch.ntt.ntt import coset_evaluate
from stark_tpu_torch.stark.air import FibonacciSquareAIR
from stark_tpu_torch.stark.trace import trace_polynomial
from stark_tpu_torch.utils import metrics as _metrics
from stark_tpu_torch.utils.metrics import span
from stark_tpu_torch.utils.debug import maybe_assert_canonical
from stark_tpu_torch.utils.gather import (BatchGather, fetch_packed,
                                          pack_words, unpack_words)

# which pipeline the last prove() took: "mega", "single-fetch" or
# "per-phase", with "-mesh" after the last two for a sharded prove
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
    `block` the (start, size) lanes of a mesh shard's tables).  A
    context also holds its mega programs (``_mega_fns``), so clearing
    the cache frees their graphs."""
    key = (air.name, getattr(air, "k", None),
           getattr(air, "context_key", None), cfg, str(device), block)
    ctx = _CTX_CACHE.get(key)
    if ctx is None:
        ctx = _CTX_CACHE[key] = air.context(cfg, device, block)
    return ctx


def _compose(air, cfg, f_evals, alphas, publics, device, mesh):
    """The composition on one device (its publics in one upload), or over
    the mesh shard by shard."""
    if mesh is None:
        ctx = get_air_context(air, cfg, device)
        return ctx.compose(f_evals, alphas, ctx.compose_args(publics))
    return compose_sharded(
        air, cfg, f_evals, alphas, publics,
        lambda block, dev: get_air_context(air, cfg, dev, block))


def _trace_tree(f_evals, columns: int, wide: bool, mesh, prune: int = 0,
                out=None, scratch=None):
    """The trace commitment of a `columns`-column LDE: a row-leaf tree for
    C > 1 columns; sharded over the mesh (never pruned) or on one device
    (into `out` and with `scratch` when given)."""
    if mesh is not None:
        return dist_merkle_tree(f_evals, mesh, columns=columns > 1,
                                wide=wide)
    tree = MerkleTree.from_columns if columns > 1 else MerkleTree
    return tree(f_evals, out, wide=wide, prune=prune, scratch=scratch)


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
    ``composition``, ``fri-commit``, ``queries``; a mega prove
    ``trace-lde``, ``prove-device``, ``fetch-replay``) and the ``proves`` and
    ``proof_bytes`` counters: in ``utils.metrics.GLOBAL`` without
    synchronising the device, or in `metrics`, a MetricsCollector, with
    each phase ending in ``torch.cuda.synchronize()`` on a CUDA device.
    `metrics` also receives the prove's spans (``utils/metrics.py``):
    the phases, ``host-trace``, ``intt`` and ``coset-ntt`` in
    ``trace-lde``, a ``fri-draw``, ``fold`` and ``layer-tree`` a fold
    in ``fri-commit``, and ``host-replay``; none synchronises.  While a
    ``torch.profiler`` records, every span is also a ``span:<name>``
    range on the profiler's clock.

    With ``STARK_TPU_TORCH_DEBUG`` set, the trace, the LDE, the
    composition and the FRI layers must hold canonical values
    (``utils/debug.py``; AssertionError otherwise; a mega prove checks
    the trace and the LDE only, as the JAX package's).

    On a CUDA device a single-fetch prove of at most 2^20 LDE points
    takes the mega path (module docstring; ``STARK_TPU_TORCH_NO_MEGA``
    keeps it off, ``STARK_TPU_TORCH_MEGA_MAX`` moves the limit,
    ``STARK_TPU_TORCH_WIDE_MEGA`` lets Goldilocks in,
    ``STARK_TPU_TORCH_FORCE_MEGA`` takes it on the CPU too)."""
    mesh_arg = mesh
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
    with _metrics.proving(metrics) as mx:
        p, M, h = cfg.modulus, cfg.eval_domain_size, cfg.offset
        devices = mesh.local_devices if mesh is not None else {device}

        def sync():
            if metrics is not None:
                for d in devices:
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)

        # -- trace + LDE: one upload of the host trace ---------------------
        # (T,), or (C, T) for C columns; (2, T) / (C, 2, T) for Goldilocks
        with mx.phase("trace-lde", n=M):
            with span("host-trace"):
                trace_host = air.host_trace(cfg) if trace is None else (
                    trace.cpu().numpy() if torch.is_tensor(trace) else trace)
                publics = air.publics_from_host(cfg, trace_host)
            trace_dev = upload_u32(trace_host, device)
            maybe_assert_canonical(trace_dev, p, "trace")
            with span("intt"):
                coeffs = trace_polynomial(trace_dev, p)
            with span("coset-ntt"):
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
            plan = query_plan(cfg, air, shards=shards)
            # the JAX gate (stark_tpu/stark/prover.py:241-248): everything
            # after the LDE as one captured program, or the multi-launch
            # path
            if _use_mega(M, mesh_arg, metrics is not None, f_evals, width):
                return _prove_mega(cfg, air, channel, f_evals, publics, plan,
                                   mx, strict, device)
            return _prove_single_fetch(cfg, air, channel, f_evals, publics,
                                       plan, mx, sync, strict, device, mesh,
                                       tag)
        return _prove_per_phase(cfg, air, channel, f_evals, publics,
                                offsets, fri_lengths, mx, sync, strict,
                                device, mesh, tag)


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
        trace_tree = _trace_tree(f_evals, air.num_columns, wide, mesh,
                                 plan.trace_prune)
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

        with span("host-replay"):
            fs.replay_fetched(channel, payload_h)
            fri.final_value = finish_deferred(p, last_h, channel, strict)
            channel.mark_phase("queries")
            plan.replay(channel, final_h, idxs_h, vals_h, digs_h)
    return _finish_proof(cfg, air, channel, publics, mx)


# The single-dispatch ("mega") prove (stark_tpu/stark/prover.py:381-629):
# everything after the LDE (the trace commit, the alpha draws, the
# composition, every fold with its layer tree and absorb, the final-
# constant absorb and the query phase) as ONE program per (AIR,
# configuration, placement).  The JAX package traces it into one XLA
# program; here it is captured once as a CUDA graph over static buffers
# and replayed on every later prove, so a warm prove issues the LDE, the
# refill of the graph's inputs, one replay and one packed copy.  Only
# worth it where the host's launches hold the card back: above
# _MEGA_MAX_DOMAIN the kernels' own time dominates.
_MEGA_MAX_DOMAIN = 1 << 20
# proves by the mega path: graphs captured, replays, and (on the CPU)
# eager runs of the same program
MEGA_STATS = {"captures": 0, "replays": 0, "eager": 0}
_MEGA_LOCK = threading.Lock()


def _count(what: str) -> None:
    with _MEGA_LOCK:
        MEGA_STATS[what] += 1


def _use_mega(M: int, mesh, precise: bool, values=None,
              width: int = 1) -> bool:
    """The JAX gate (stark_tpu/stark/prover.py:395-428): never with a
    mesh, precise metrics or ``STARK_TPU_TORCH_NO_MEGA``, nor above
    ``STARK_TPU_TORCH_MEGA_MAX`` points (default 2^20); always under
    ``STARK_TPU_TORCH_FORCE_MEGA``; a 64-bit field only under
    ``STARK_TPU_TORCH_WIDE_MEGA``; otherwise exactly when the LDE lies on
    a CUDA device (the JAX ``platform == "tpu"``; with no values, when
    the card is there)."""
    if mesh is not None or precise or os.environ.get(
            "STARK_TPU_TORCH_NO_MEGA"):
        return False
    if M > int(os.environ.get("STARK_TPU_TORCH_MEGA_MAX",
                              str(_MEGA_MAX_DOMAIN))):
        return False
    if os.environ.get("STARK_TPU_TORCH_FORCE_MEGA"):
        return True
    if width != 1 and not os.environ.get("STARK_TPU_TORCH_WIDE_MEGA"):
        return False
    if values is None:
        return torch.cuda.is_available()
    return bool(values.is_cuda)


def mega_log_kinds(num_alphas: int, num_folds: int) -> list[str]:
    """The Fiat-Shamir log of the region, in the JAX package's order
    (stark_tpu/stark/prover.py:491-493)."""
    return (["mark:trace-commit", "root"] + ["draw"] * num_alphas
            + ["mark:composition", "mark:fri-commit", "root"]
            + ["draw", "root"] * num_folds)


def _mega_setup(cfg, air, plan, f_evals) -> dict:
    """Everything static of the mega program, made before any capture:
    the query plan's packed tables, each tree's prune depth, the static
    buffers' shapes, the folds' inverse domains (held here, since the
    graph reads the cached tensors), the Fiat-Shamir log template and
    the structure key (what shapes the captured launches beyond the AIR
    context's own key: the prune depths and the tree build's sizes, all
    read at call time)."""
    from stark_tpu_torch.merkle import tree as mt

    p, M = cfg.modulus, cfg.eval_domain_size
    width = Fp.get(p).width
    dev = f_evals.device
    num_folds = len(plan.fri_lengths) - 1
    plan.pack(dev)
    # the folds' 1 / x tables, as fri/commit.py's _commit asks for them
    inv_doms, size, off = [], M, int(cfg.offset) % p
    for _ in range(num_folds):
        inv_doms.append(_inv_domain(p, size, off, str(dev)))
        size //= 2
        off = off * off % p
    _, vtotal, dtotal = layer_layout(plan.fri_lengths, width, plan.fri_prune)
    trees = ((M, plan.trace_prune), *zip(plan.fri_lengths, plan.fri_prune))
    return dict(
        plan=plan, inv_doms=inv_doms, num_folds=num_folds,
        lde_shape=tuple(f_evals.shape),
        trace_rows=mt.tree_rows(M >> plan.trace_prune),
        fri_words=vtotal, fri_rows=dtotal, trees=trees,
        log_kinds=mega_log_kinds(air.num_alphas, num_folds),
        struct_key=(plan.trace_prune, tuple(plan.fri_prune), mt.SUBTREE_LOG,
                    mt.SUBTREE_LEVELS, mt.TAIL_LOG, mt.CHUNK_LOG,
                    mt.CHUNK_MIN_LOG))


@contextlib.contextmanager
def _sync_debug(mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block (without
    its warning that the mode is a prototype)."""
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            torch.cuda.set_sync_debug_mode(before)


class MegaProgram:
    """The post-LDE prove of one (AIR, configuration, placement) over
    static buffers: the inputs (the channel state, the LDE, the
    composition's publics), which each prove refills, and the trees' and
    FRI layers' buffers, whose addresses K5's query form reads from a
    source table built once.  Its region returns one packed int32 buffer:
    the Fiat-Shamir payloads, the last FRI layer, and the query phase's
    final state, indices, values and digests.

    On a CUDA device the first :meth:`launch` runs the region on a side
    stream to build the kernels and fill every cache, runs it again under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising op in
    the region raises there, named), then captures it with
    ``torch.cuda.graph`` into a private pool kept with the program; every
    launch then refills the inputs and replays the graph.  A capture or
    replay that fails raises.  On the CPU the same region runs eagerly on
    the same buffers.  :attr:`lock` keeps two threads from sharing the
    buffers: hold it from :meth:`launch` through :meth:`fetch`."""

    def __init__(self, cfg, air, ctx, setup: dict, initial: bool):
        self.cfg, self.ctx, self.setup = cfg, ctx, setup
        self.initial = initial
        self.num_alphas = air.num_alphas
        self.num_columns = air.num_columns
        self.lock = threading.Lock()
        plan, dev = setup["plan"], ctx.device
        f = Fp.get(cfg.modulus)

        def words(shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        self.state = words(8)
        self.lde = words(setup["lde_shape"])
        self.pubs = f.array([0] * len(ctx.compose_publics), dev)
        self.args = ctx.public_views(self.pubs)
        self.trace_buf = words((setup["trace_rows"], 8))
        self.fri_values = words(setup["fri_words"])
        self.fri_digests = words((setup["fri_rows"], 8))
        self.scratch = tree_scratch(setup["trees"], dev)
        self.ptrs = plan.source_table(self.lde, self.trace_buf,
                                      self.fri_values, self.fri_digests)
        pin = dev.type == "cuda"
        self.state_host = torch.zeros(8, dtype=torch.int32, pin_memory=pin)
        self.pubs_host = torch.zeros(self.pubs.shape, dtype=torch.int64,
                                     pin_memory=pin)
        self.graph = None
        self.out = self.fs = self.shapes = None
        self.pool_bytes = 0
        self.first_s = None  # the first launch's wall (capture included)

    def _region(self):
        """The whole post-LDE prove on the static buffers, no fetch:
        (packed words, the DeviceFS whose log they hold, the shapes of
        the packed tensors)."""
        cfg, plan = self.cfg, self.setup["plan"]
        p = cfg.modulus
        wide = Fp.get(p).width == 2
        fs = DeviceFS(p, device=self.lde.device,
                      state=None if self.initial else self.state)
        fs.mark("trace-commit")
        trace_tree = _trace_tree(self.lde, self.num_columns, wide, None,
                                 plan.trace_prune, self.trace_buf,
                                 self.scratch)
        fs.absorb_root(trace_tree.root_digest)
        alphas = tuple(fs.draw() for _ in range(self.num_alphas))
        fs.mark("composition")
        cp = self.ctx.compose(self.lde, alphas, self.args)
        fri = fri_commit(cp, p, cfg.offset, None,
                         num_folds=self.setup["num_folds"], fs=fs,
                         defer=True, out=(self.fri_values, self.fri_digests,
                                          self.scratch))
        last = fri.final_layer
        fs.state = absorb_value(fs.state, *final_words(last, wide))
        dev_out = plan.run_device(fs.state, self.lde, self.trace_buf,
                                  self.fri_values, self.fri_digests,
                                  ptrs=self.ptrs)
        if fs.kinds() != self.setup["log_kinds"]:
            raise RuntimeError(f"mega program's Fiat-Shamir log {fs.kinds()} "
                               f"differs from its template "
                               f"{self.setup['log_kinds']}")
        parts = [*fs.payloads(), last, *dev_out]
        return pack_words(parts), fs, [tuple(t.shape) for t in parts]

    def _refill(self, state_hex: str, lde: torch.Tensor,
                publics: dict) -> None:
        if not self.initial:
            self.state_host.copy_(state_words(state_hex, "cpu"))
            self.state.copy_(self.state_host, non_blocking=True)
        self.pubs_host.copy_(Fp.get(self.cfg.modulus).array(
            [publics[k] for k in self.ctx.compose_publics], "cpu"))
        self.pubs.copy_(self.pubs_host, non_blocking=True)
        self.lde.copy_(lde)

    def _capture(self) -> None:
        dev = self.lde.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._region()  # builds the kernels, fills the caches
                with _sync_debug("error"):
                    self._region()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                before = torch.cuda.memory_reserved(dev)
                out, fs, shapes = self._region()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        self.graph, self.out, self.fs, self.shapes = graph, out, fs, shapes
        _count("captures")

    def launch(self, state_hex: str, lde: torch.Tensor,
               publics: dict) -> None:
        """Refill the inputs from the channel's state, the LDE and the
        statement's publics, and run the region: one replay of the graph
        (captured first on the first launch), or eagerly on the CPU."""
        self._refill(state_hex, lde, publics)
        if not self.lde.is_cuda:
            self.out, self.fs, self.shapes = self._region()
            _count("eager")
            return
        if self.graph is None:
            t0 = time.perf_counter()
            self._capture()
            self.graph.replay()
            torch.cuda.synchronize(self.lde.device)
            self.first_s = time.perf_counter() - t0
        else:
            self.graph.replay()
        _count("replays")

    def fetch(self) -> list:
        """The one device->host copy of the packed outputs, split."""
        return unpack_words(self.out.cpu().numpy(), self.shapes)


def _get_mega_fn(cfg, air, ctx, setup: dict, initial: bool) -> MegaProgram:
    """The cached mega program of one (AIR, configuration, placement),
    keyed as the JAX package's (stark_tpu/stark/prover.py:502-512) on the
    structure, `initial` (a fresh channel's first absorb has its own SHA
    block layout) and the query count, on the AIR's context."""
    key = (setup["struct_key"], initial, cfg.num_queries)
    with _MEGA_LOCK:
        cache = ctx.__dict__.setdefault("_mega_fns", {})
        prog = cache.get(key)
        if prog is None:
            prog = cache[key] = MegaProgram(cfg, air, ctx, setup, initial)
    return prog


def _prove_mega(cfg, air, channel, f_evals, publics, plan, mx, strict,
                device) -> StarkProof:
    """The post-LDE prove as one program (``prove-device``: refill and
    replay) and one packed copy followed by the host replay of the
    byte-identical transcript (``fetch-replay``), as the JAX package's
    (stark_tpu/stark/prover.py:576-629).  Only the trace and LDE checks
    of ``STARK_TPU_TORCH_DEBUG`` run: a verdict fetch cannot sit in a
    graph."""
    global LAST_PROVE_PATH
    LAST_PROVE_PATH = "mega"
    ctx = get_air_context(air, cfg, device)
    setup = _mega_setup(cfg, air, plan, f_evals)
    prog = _get_mega_fn(cfg, air, ctx, setup, not channel.state)
    with prog.lock:
        with mx.phase("prove-device"):
            prog.launch(channel.state, f_evals, publics)
        with mx.phase("fetch-replay"):
            fetched = prog.fetch()
            n_pay = len(fetched) - 5
            last_h, final_h, idxs_h, vals_h, digs_h = fetched[n_pay:]
            with span("host-replay"):
                prog.fs.replay_fetched(channel, fetched[:n_pay])
                finish_deferred(cfg.modulus, last_h, channel, strict)
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
        trace_tree = _trace_tree(f_evals, air.num_columns, width == 2, mesh)
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
