# Copied from stark_tpu/fri/verify.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""FRI verifier — host side.

What the reference's ``verify_fri`` intended but never finished
(reference: src/fri/fri_verify.rs — disabled, reads ``proof.last()``
forever at :45,:56,:97,:106, hardcodes layer size 8192 at :108, and left
the fold-consistency check as a commented-out placeholder at :148-170).

This verifier walks the transcript with a cursor (VerifierChannel),
re-derives every challenge, Merkle-validates each opened value, and
enforces the actual FRI relation between consecutive layers:

    p_{k+1}(x^2) = (p_k(x) + p_k(-x)) / 2 + beta_k * (p_k(x) - p_k(-x)) / (2x)

The verifier is pure host Python (cheap: O(queries * layers) hashes and
field ops) and is used in CI to check device-produced proofs.  The STARK
verifier reuses :func:`replay_commit` + :func:`verify_query_layers`,
binding the layer-0 opening to the composition value it recomputes from
the trace openings (``expect_first``).
"""

from __future__ import annotations

from stark_tpu_torch.channel.channel import VerifierChannel
from stark_tpu_torch.merkle.tree import MerkleTree
from stark_tpu_torch.ntt.reference_ntt import root_of_unity


class FRIVerificationError(Exception):
    pass


def replay_commit(ch: VerifierChannel, num_folds: int):
    """Replay the commit phase: returns (roots, betas, final_value)."""
    roots = [ch.read().decode()]
    betas = []
    for _ in range(num_folds):
        betas.append(ch.receive_random_field_element().value)
        roots.append(ch.read().decode())
    final_value = int.from_bytes(ch.read(), "big")
    return roots, betas, final_value


def verify_query_layers(
    ch: VerifierChannel,
    idx0: int,
    roots: list[str],
    betas: list[int],
    final_value: int,
    p: int,
    domain_size: int,
    offset: int,
    expect_first: int | None = None,
    label: str = "",
) -> None:
    """Walk one query's per-layer openings, Merkle-validating and checking
    the fold relation; raises FRIVerificationError on any failure.

    `expect_first`, when given, pins the layer-0 opened value (the STARK
    verifier passes the composition value recomputed from trace openings —
    this is what binds FRI to the trace commitment)."""
    num_folds = len(betas)
    sizes = [domain_size >> k for k in range(num_folds + 1)]
    offsets = [pow(offset, 1 << k, p) for k in range(num_folds + 1)]
    ws = [root_of_unity(p, s) if s > 1 else 1 for s in sizes]
    inv2 = pow(2, p - 2, p)

    prev = None
    for k, (size, root) in enumerate(zip(sizes, roots)):
        if size == 1:
            _ = ch.read()  # the reference's len==1 extra send
        idx = idx0 % size
        sib_idx = (idx + size // 2) % size
        v = int.from_bytes(ch.read(), "big")
        v_path = ch.read()
        s = int.from_bytes(ch.read(), "big")
        s_path = ch.read()
        if not MerkleTree.validate(root, v_path, idx, v.to_bytes(8, "big"), size):
            raise FRIVerificationError(
                f"{label}Merkle proof fails for value, layer {k}"
            )
        if not MerkleTree.validate(root, s_path, sib_idx, s.to_bytes(8, "big"), size):
            raise FRIVerificationError(
                f"{label}Merkle proof fails for sibling, layer {k}"
            )
        if k == 0 and expect_first is not None and v != expect_first:
            raise FRIVerificationError(
                f"{label}layer-0 value {v} does not match recomputed "
                f"composition value {expect_first}"
            )
        x = offsets[k] * pow(ws[k], idx, p) % p
        if prev is not None:
            pv, ps, px = prev
            beta = betas[k - 1]
            # the check fri_verify.rs:148-170 left as a placeholder:
            folded = (
                (pv + ps) * inv2 + beta * (pv - ps) * inv2 * pow(px, p - 2, p)
            ) % p
            if folded != v:
                raise FRIVerificationError(
                    f"{label}fold relation fails entering layer {k}"
                )
        prev = (v, s, x)
    if prev[0] != final_value:
        raise FRIVerificationError(
            f"{label}last layer value {prev[0]} != final constant {final_value}"
        )


def verify_fri(
    proof: list[bytes],
    p: int,
    domain_size: int,
    offset: int,
    num_folds: int,
    num_queries: int,
    max_index: int,
    channel: VerifierChannel | None = None,
) -> bool:
    """Verify a standalone FRI transcript produced by fri_commit +
    decommit_fri.  Raises FRIVerificationError with a reason on failure;
    returns True on success."""
    ch = channel or VerifierChannel(p, proof)
    try:
        roots, betas, final_value = replay_commit(ch, num_folds)
        for q in range(num_queries):
            idx0 = ch.receive_random_int(0, max_index, True)
            verify_query_layers(
                ch, idx0, roots, betas, final_value, p, domain_size, offset,
                label=f"query {q}: ",
            )
    except (UnicodeDecodeError, OverflowError, ValueError) as e:
        # malformed transcript bytes are rejections, not crashes
        raise FRIVerificationError(f"malformed transcript: {e!r}") from e
    return True
