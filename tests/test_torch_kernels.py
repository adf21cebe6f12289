"""Each hand-written CUDA kernel of the port against its plain torch
version on the card, exact equality, at small sizes (the full-size
comparison is chip_smoke.py's).  Marked ``cuda``: they skip without a
CUDA device.  The card's machine has no JAX, so run them there without
the suite's conftest (which imports JAX) and its xdist options:

    python -m pytest tests/test_torch_kernels.py -q --noconftest -o addopts=""
"""

import json
import os

import numpy as np
import pytest
import torch

P = 3 * 2**30 + 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    return torch.device("cuda:0")


def _u32(shape, bound, seed, dev):
    rs = np.random.RandomState(seed)
    v = rs.randint(0, bound, size=shape, dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(v.view(np.int32)).to(dev)


@pytest.mark.parametrize("p", [P, 97])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 9, 12, 15])
@pytest.mark.parametrize("inverse", [False, True])
def test_k1_ntt_matches_plain(dev, p, log_n, inverse):
    from stark_tpu_torch.ntt.cuda_ntt import ntt_plain, ntt_two_step

    if p == 97 and log_n > 5:
        pytest.skip("GF(97) has roots of unity up to order 32 only")
    x = _u32(1 << log_n, p, log_n, dev)
    before = ntt_two_step.launches
    got = ntt_two_step(x, p, inverse)
    torch.cuda.synchronize()
    assert ntt_two_step.launches == before + 1
    assert torch.equal(got, ntt_plain(x, p, inverse))


@pytest.mark.parametrize("n", [1, 2, 255, 4096])
def test_k3_k4_match_plain(dev, n):
    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_nodes
    from stark_tpu_torch.hash.sha256 import sha256_pairs, sha256_u64_leaves

    v = _u32(n, P, n, dev)
    assert torch.equal(sha_leaves(v), sha256_u64_leaves(v))
    kids = _u32((2 * n, 8), 2**32, n + 1, dev)
    assert torch.equal(sha_nodes(kids), sha256_pairs(kids))


def test_tree_matches_plain(dev):
    from stark_tpu_torch.merkle.tree import MerkleTree

    v = _u32(1 << 10, P, 7, dev)
    plain = MerkleTree(v.cpu()).buffer.to(dev)
    assert torch.equal(MerkleTree(v).buffer, plain)


def test_k5_chain_matches_plain(dev):
    from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW,
                                                 sha_chain, sha_chain_plain)

    flags = [[FIRST_ROW, 0], [0, 1], [FIRST_HEX, 0], [0, 0], [0, 1],
             [0, 0], [FIRST_HEX, 1], [FIRST_ROW, 1]]
    fl = torch.tensor(flags, dtype=torch.int32, device=dev)
    stream = _u32((len(flags), 16), 2**32, 3, dev)
    chain = _u32(8, 2**32, 4, dev)
    assert torch.equal(sha_chain(stream, fl, chain),
                       sha_chain_plain(stream, fl, chain))


def test_golden_vectors_on_card(dev):
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import StarkProof, prove

    path = os.path.join(os.path.dirname(__file__), "vectors",
                        "golden_proofs.json")
    with open(path) as fh:
        vec = json.load(fh)
    got = prove(ProverConfig(modulus=97, generator=5, log2_trace=2, blowup=4,
                             num_queries=2), a1=3, device=dev)
    assert got.proof == StarkProof.deserialize(
        json.dumps(vec["fib_gf97_2e2"]).encode()).proof
