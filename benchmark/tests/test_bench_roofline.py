"""The frozen op and byte counts reproduce the program's chip checks
(chip_smoke.py) at the shapes of the three cells."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from benchmark import roofline  # noqa: E402

FIBSQ = {"air": "fibonacci-square", "modulus": 3 * 2**30 + 1,
         "log2_trace": 23, "blowup": 8}
FIBMUL_GL = {"air": "fibmul", "modulus": 2**64 - 2**32 + 1,
             "log2_trace": 21, "blowup": 8}


@pytest.mark.parametrize("c,wide", [(1, False), (1, True), (2, True),
                                    (2, False), (3, False), (6, True)])
def test_leaf_ops_match_chip_smoke(c, wide):
    assert roofline.sha_leaf_ops(c, wide) == chip_smoke.sha_leaf_ops(c, wide)


def test_node_ops_are_2288():
    assert roofline.NODE_OPS == 2288
    assert roofline.NODE_OPS == chip_smoke.SHA_OPS + chip_smoke.SHA_PAD_OPS


def _smoke_card(sms=132, mhz=1980.0):
    card = object.__new__(chip_smoke.Card)
    card.sms, card.clock_hz = sms, mhz * 1e6
    card.int32_ops_per_s = sms * chip_smoke.INT32_OPS_PER_SM_CLOCK * mhz * 1e6
    return card


@pytest.mark.parametrize("n,inverse", [(1 << 23, True), (1 << 26, False),
                                       (1 << 21, True), (1 << 24, False),
                                       (1 << 24, True), (1 << 22, True)])
def test_ntt_bound_matches_chip_smoke(n, inverse):
    ours = roofline.Card(132, 1980.0)
    ms, _ = _smoke_card().ntt_bound(n, inverse)
    assert ours.ntt_bound(n, inverse) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_rates_are_the_derived_ones():
    card = roofline.Card(132, 1980.0)
    assert card.int32_ops_per_s == pytest.approx(3.3454e13, rel=1e-4)
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S


def test_prove_trees_of_the_cells():
    assert roofline.prove_trees(FIBSQ)[:3] == [
        (1 << 26, 1, False), (1 << 26, 1, False), (1 << 25, 1, False)]
    assert len(roofline.prove_trees(FIBSQ)) == 25
    trees = roofline.prove_trees(FIBMUL_GL)
    assert trees[0] == (1 << 24, 2, True) and trees[-1] == (8, 1, True)


def test_merkle_bound_is_the_op_bound_at_the_cells():
    card = roofline.Card(132, 1980.0)
    for spec in (FIBSQ, FIBMUL_GL):
        ops = sum(roofline.tree_work(*t)[1]
                  for t in roofline.prove_trees(spec))
        assert roofline.merkle_least_s(spec, card) == pytest.approx(
            ops / card.int32_ops_per_s)
    # the trace tree alone at 2^26 u32 leaves: chip_smoke's K3 + K4 bound
    n = 1 << 26
    ops = roofline.tree_work(n, 1, False)[1]
    smoke = (chip_smoke.sha_leaf_ops(1, False) * n + 2288 * (n - 1))
    assert ops == smoke


def test_ntt_least_covers_each_column():
    card = roofline.Card(132, 1980.0)
    one = roofline.ntt_least_s(FIBSQ, card)
    assert one == pytest.approx(card.ntt_bound(1 << 23, True)
                                + card.ntt_bound(1 << 26, False))
    two = roofline.ntt_least_s(FIBMUL_GL, card)
    assert two == pytest.approx(2 * (card.ntt_bound(1 << 21, True)
                                     + card.ntt_bound(1 << 24, False)))
