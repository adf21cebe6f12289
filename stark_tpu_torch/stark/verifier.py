"""STARK verifier — host side (counterpart of ``stark_tpu/stark/verifier.py``),
pure Python ints plus hashlib, so it checks a proof on a machine without
JAX.

Replays the full transcript: the trace openings (one row message of the
AIR's columns per shift) against the trace Merkle root, the recomputed
composition value against the FRI layer-0 opening, every FRI layer's
Merkle proofs, the fold relation between layers, and the final
constant.  All challenges are
re-derived from the transcript.
"""

from __future__ import annotations

from stark_tpu_torch.channel.channel import ChannelError, VerifierChannel
from stark_tpu_torch.fri.verify import (FRIVerificationError, replay_commit,
                                        verify_query_layers)
from stark_tpu_torch.merkle.tree import MerkleTree
from stark_tpu_torch.ntt.reference_ntt import root_of_unity
from stark_tpu_torch.stark.air import air_from_name
from stark_tpu_torch.stark.prover import StarkProof


class StarkVerificationError(Exception):
    pass


def verify(proof: StarkProof, air=None, *, expected_config=None,
           expected_publics=None, min_queries: int = 1) -> bool:
    """Verify a STARK proof against its public statement.  Raises
    StarkVerificationError on failure; True on success.  `proof.config`
    and `proof.publics` travel with the proof: pin them with
    `expected_config` / `expected_publics` where they matter."""
    cfg = proof.config
    if expected_config is not None and cfg != expected_config:
        raise StarkVerificationError(
            f"proof config {cfg} != expected {expected_config}")
    if (expected_publics is not None
            and dict(proof.publics) != dict(expected_publics)):
        raise StarkVerificationError(
            f"proof publics {proof.publics} != expected {expected_publics}")
    try:
        cfg.validate()
    except ValueError as e:
        raise StarkVerificationError(f"insecure/invalid config: {e}") from e
    if cfg.num_queries < min_queries:
        raise StarkVerificationError(
            f"proof has {cfg.num_queries} queries < required {min_queries}")
    if air is None:
        air = air_from_name(proof.air_name, proof.publics)
    air.validate(cfg)
    p, M, b, h = cfg.modulus, cfg.eval_domain_size, cfg.blowup, cfg.offset
    w = root_of_unity(p, M)
    offsets = [s * b for s in air.shifts]
    publics = proof.publics
    ncols = air.num_columns

    try:
        ch = VerifierChannel(p, proof.proof)
        trace_root = ch.read().decode()
        alphas = tuple(ch.receive_random_field_element().value
                       for _ in range(air.num_alphas))
        roots, betas, final_value = replay_commit(ch, air.num_folds(cfg))
        for q in range(cfg.num_queries):
            idx = ch.receive_random_int(0, M - max(offsets) - 1, True)
            opened = []
            for off in offsets:
                # a row message of ncols values, 8-byte BE each: its bytes
                # are the committed leaf's preimage
                msg = ch.read()
                if len(msg) != 8 * ncols:
                    raise StarkVerificationError(
                        f"query {q}: row opening is {len(msg)} bytes, "
                        f"expected {8 * ncols}")
                path = ch.read()
                if not MerkleTree.validate(trace_root, path, idx + off, msg,
                                           M):
                    raise StarkVerificationError(
                        f"query {q}: trace Merkle proof fails at offset {off}")
                vals = tuple(int.from_bytes(msg[8 * i:8 * i + 8], "big")
                             for i in range(ncols))
                opened.append(vals[0] if ncols == 1 else vals)
            x = h * pow(w, idx, p) % p
            verify_query_layers(
                ch, idx, roots, betas, final_value, p, M, h,
                expect_first=air.cp_at(cfg, x, opened, alphas, publics),
                label=f"query {q}: ")
        if ch.cursor != len(proof.proof):
            raise StarkVerificationError(
                f"{len(proof.proof) - ch.cursor} unread trailing messages")
    except (ChannelError, FRIVerificationError) as e:
        raise StarkVerificationError(str(e)) from e
    except (UnicodeDecodeError, OverflowError, ValueError) as e:
        raise StarkVerificationError(f"malformed transcript: {e!r}") from e
    return True
