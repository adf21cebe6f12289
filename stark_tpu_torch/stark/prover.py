"""Top-level STARK prover (counterpart of ``stark_tpu/stark/prover.py``;
the single-fetch pipeline only).

    host trace -> trace polynomial (INTT, K1) -> coset LDE (NTT, K1) ->
    trace Merkle tree (K3/K4) -> device Fiat-Shamir absorb + alpha draws
    (K5) -> composition -> FRI fold + per-layer tree + absorb ->
    device query phase (one launch of K5's query form) -> ONE
    device->host copy -> host transcript replay -> StarkProof

Everything after the trace upload stays on the device with a
device-resident Fiat-Shamir state; the host replays the canonical
transcript from a single ``.cpu()`` of the packed outputs and checks
that every device-derived challenge equals the host derivation, so the
proof bytes are identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import torch

from stark_tpu_torch.channel import device_query as _dq
from stark_tpu_torch.channel.channel import Channel
from stark_tpu_torch.channel.device_channel import DeviceFS, absorb_value
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.fields.fp import Fp, upload_u32
from stark_tpu_torch.fri.commit import finish_deferred, fri_commit
from stark_tpu_torch.merkle.tree import MerkleTree
from stark_tpu_torch.ntt.ntt import coset_evaluate
from stark_tpu_torch.stark.air import FibonacciSquareAIR
from stark_tpu_torch.stark.trace import trace_polynomial

# which pipeline the last prove() took (the port has one)
LAST_PROVE_PATH: str | None = None


@dataclasses.dataclass
class StarkProof:
    """A complete proof: the transcript plus the public statement."""

    proof: list[bytes]
    a0: int
    a_last: int
    config: ProverConfig
    air_name: str = "fibonacci-square"
    extra_publics: dict | None = None

    @property
    def publics(self) -> dict:
        base = {"a0": self.a0, "a_last": self.a_last}
        if self.extra_publics:
            base.update(self.extra_publics)
        return base

    def size_bytes(self) -> int:
        return sum(len(m) for m in self.proof)

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

    def serialize(self) -> bytes:
        """JSON, in the JAX package's format."""
        obj = self._header()
        obj["proof"] = [m.hex() for m in self.proof]
        return json.dumps(obj).encode()

    @classmethod
    def deserialize(cls, data: bytes) -> "StarkProof":
        if data[:4] == b"STP1":
            raise NotImplementedError(
                "the compressed container is not ported yet "
                "(ROADMAP Queue 1 item 14)")
        obj = json.loads(data.decode())
        c = obj["config"]
        return cls(
            proof=[bytes.fromhex(m) for m in obj["proof"]],
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


def get_air_context(air, cfg: ProverConfig, device):
    """Per-(AIR, config, device) context cache (the inverse tables)."""
    key = (air.name, cfg, str(device))
    ctx = _CTX_CACHE.get(key)
    if ctx is None:
        ctx = _CTX_CACHE[key] = air.context(cfg, device)
    return ctx


@functools.lru_cache(maxsize=None)
def query_plan(cfg: ProverConfig) -> _dq.DeviceQueryPlan:
    """The device query plan of the Fibonacci-square prove of `cfg`, built
    once per configuration."""
    air = FibonacciSquareAIR()
    M = cfg.eval_domain_size
    offsets = tuple(s * cfg.blowup for s in air.shifts)
    rng = M - max(offsets)
    fri_lengths = tuple(M >> k for k in range(air.num_folds(cfg) + 1))
    if not _dq.supported(rng, M, fri_lengths):
        raise NotImplementedError(
            "configuration outside the single-fetch path; the per-phase "
            "path waits for ROADMAP Queue 1 item 14")
    return _dq.DeviceQueryPlan(rng, cfg.num_queries, offsets, M, fri_lengths)


def prove(cfg: ProverConfig, a1: int = 3141592, *,
          device="cuda") -> StarkProof:
    """Prove the Fibonacci-square statement with secret a_1 on `device`:
    the card by default, where the kernels run; a CPU device runs their
    plain versions."""
    if cfg.mesh_shape is not None:
        raise NotImplementedError(
            "sharded proving on several GPUs waits for ROADMAP Queue 1 "
            "item 15")
    device = torch.device(device)
    air = FibonacciSquareAIR(a1=a1)
    air.validate(cfg)
    p, M, h = cfg.modulus, cfg.eval_domain_size, cfg.offset
    Fp.get(p)  # u32 fields only: raises for 64-bit moduli
    plan = query_plan(cfg)

    # -- trace + LDE: one upload of the host trace -------------------------
    trace_host = air.host_trace(cfg)
    publics = air.publics_from_host(trace_host)
    trace = upload_u32(trace_host, device)
    f_evals = coset_evaluate(trace_polynomial(trace, p), p, M, h)
    return _prove_single_fetch(cfg, air, Channel(p), f_evals, publics, plan)


def _prove_single_fetch(cfg, air, channel, f_evals, publics,
                        plan) -> StarkProof:
    global LAST_PROVE_PATH
    LAST_PROVE_PATH = "single-fetch"
    p, h = cfg.modulus, cfg.offset
    device = f_evals.device

    trace_tree = MerkleTree(f_evals)
    fs = DeviceFS(p, channel.state, device=device)
    fs.mark("trace-commit")
    fs.absorb_root(trace_tree.root_digest)
    alphas = tuple(fs.draw() for _ in range(air.num_alphas))

    fs.mark("composition")
    cp = get_air_context(air, cfg, device).compose(f_evals, alphas, publics)
    fri = fri_commit(cp, p, h, fs, num_folds=len(plan.fri_lengths) - 1)

    # the canonical transcript sends the final FRI constant before the
    # query draws: advance the device state over that send too
    last = fri.fri_layers[-1]
    fs.state = absorb_value(fs.state, torch.zeros_like(last[0]), last[0])

    dev = plan.run_device(fs.state, f_evals, trace_tree.buffer, fri.values,
                          fri.digests)

    # THE one device->host copy: every payload, packed into one buffer
    pieces = [t.reshape(-1).to(torch.int32)
              for t in (*fs.payloads(), last, *dev)]
    host = torch.cat(pieces).cpu().numpy()
    parts, pos = [], 0
    for t in pieces:
        parts.append(host[pos:pos + t.numel()])
        pos += t.numel()
    n_pay = len(fs.payloads())
    payload_h, (last_h, final_h, idxs_h, vals_h, digs_h) = (
        parts[:n_pay], parts[n_pay:])
    q_n = cfg.num_queries

    fs.replay_fetched(channel, payload_h)
    fri.final_value = finish_deferred(p, last_h, channel)
    channel.mark_phase("queries")
    plan.replay(channel, final_h, idxs_h, vals_h.reshape(q_n, -1),
                digs_h.reshape(q_n, -1, 8))
    return _finish_proof(cfg, air, channel, publics)


def _finish_proof(cfg, air, channel, publics) -> StarkProof:
    return StarkProof(proof=[bytes(m) for m in channel.proof],
                      a0=publics["a0"], a_last=publics["a_last"], config=cfg,
                      air_name=air.name)
