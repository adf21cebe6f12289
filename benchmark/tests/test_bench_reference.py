"""The plain reference against Python ints, hashlib and the program's
proves at small sizes, on the CPU."""

import hashlib
import os
import random
import struct
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import airs, tracemaker  # noqa: E402
from benchmark.reference import field, sha256  # noqa: E402
from benchmark.reference import stark as ref  # noqa: E402

P32 = 3 * 2**30 + 1
GL = 2**64 - 2**32 + 1


def _edge_values(p):
    rng = random.Random(p)
    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 2**32 - 1 if p > 2**32
             else p - 3, 2**32 % p, 2**31, 2**16 - 1]
    return [v % p for v in edges] + [rng.randrange(p) for _ in range(300)]


@pytest.mark.parametrize("p", [P32, GL])
def test_field_ops_match_python_ints(p):
    f = field.field_for(p)
    vals = _edge_values(p)
    xs = [a for a in vals for _ in vals[:12]]
    ys = [b for _ in vals for b in vals[:12]]
    a, b = f.from_ints(xs, "cpu"), f.from_ints(ys, "cpu")
    assert f.to_ints(f.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert f.to_ints(f.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert f.to_ints(f.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    nz = f.from_ints([v or 1 for v in vals], "cpu")
    inv = f.to_ints(field.inverse(f, nz))
    assert inv == [pow(v or 1, p - 2, p) for v in vals]


def test_goldilocks_canon_takes_wide_digits():
    f = field.GoldilocksField()
    rng = random.Random(3)
    c1 = [rng.randrange(-2**37, 2**37) for _ in range(2000)] + [2**35, -1]
    c0 = [rng.randrange(-2**37, 2**37) for _ in range(2000)] + [-1, 2**33]
    got = f.to_ints(f.canon(torch.tensor(c1), torch.tensor(c0)))
    assert got == [(h * 2**32 + lo) % GL for h, lo in zip(c1, c0)]


@pytest.mark.parametrize("nbytes", [8, 16, 64])
def test_sha256_matches_hashlib(nbytes):
    rng = random.Random(nbytes)
    msgs = [bytes(rng.randrange(256) for _ in range(nbytes))
            for _ in range(64)]
    rows = torch.tensor([list(struct.unpack(f">{nbytes // 4}I", m))
                         for m in msgs], dtype=torch.int64)
    got = sha256.hash_columns([rows[:, j] for j in range(nbytes // 4)],
                              nbytes, chunk=16)
    for m, d in zip(msgs, got):
        assert sha256.digest_bytes(d) == hashlib.sha256(m).digest()


@pytest.mark.parametrize("p", [P32, GL])
def test_ntt_matches_the_definition(p):
    f = field.field_for(p)
    n = 16
    w = field.root_of_unity(p, n)
    vals = [random.Random(n).randrange(p) for _ in range(n)]
    got = f.to_ints(ref.ntt(f, f.from_ints(vals, "cpu"), w))
    assert got == [sum(v * pow(w, j * k, p) for j, v in enumerate(vals)) % p
                   for k in range(n)]
    back = f.to_ints(ref.intt(f, f.from_ints(got, "cpu"), w))
    assert back == vals


@pytest.mark.parametrize("air", ["fibonacci-square", "fibmul"])
@pytest.mark.parametrize("p", [P32, GL])
def test_trace_maker_matches_the_plain_loop(air, p):
    spec = ref.Spec(air, p, 5, 9, 4, 4)
    got = tracemaker.values(air, p, 987654321, (1 << 9) - 1)
    want = ref.plain_trace(spec, 987654321)
    assert [list(map(int, c)) for c in got.reshape(len(want), -1)] == want


CASES = [("fibonacci-square", P32, 5, 10, 4, 4), ("fibmul", GL, 7, 8, 4, 4),
         ("fibmul", P32, 5, 8, 4, 4), ("fibonacci-square", GL, 7, 8, 4, 4),
         ("fibonacci-square", P32, 5, 9, 8, 16), ("fibmul", GL, 7, 7, 8, 28)]


@pytest.mark.parametrize("air,p,gen,log2,blowup,queries", CASES)
def test_reference_proof_equals_the_programs(air, p, gen, log2, blowup,
                                             queries):
    """The reference's transcript and publics equal the program's prove of
    the same statement, message for message, from the witness and from
    the benchmark's trace words; the blowup-8 cases carry the cells'
    query counts."""
    import stark_tpu_torch.stark as stark
    from stark_tpu_torch.config import ProverConfig

    cfg = ProverConfig(modulus=p, generator=gen, log2_trace=log2,
                       blowup=blowup, num_queries=queries)
    w = 4242424242 % p
    cls_name, keyword = airs.load(air).PROGRAM_AIR
    pr = stark.prove(cfg, air=getattr(stark, cls_name)(**{keyword: w}),
                     device="cpu")
    spec = ref.Spec(air, p, gen, log2, blowup, queries)
    messages, publics = ref.prove(spec, ref.plain_trace(spec, w), "cpu")
    assert messages == pr.proof
    assert publics == pr.publics
    words = tracemaker.storage_words(
        tracemaker.values(air, p, w, (1 << log2) - 1), p)
    cols = ref.columns_from_words(spec, torch.from_numpy(
        words.astype("int64")))
    assert ref.prove(spec, cols, "cpu")[0] == pr.proof


@pytest.mark.parametrize("air", ["fibonacci-square", "fibmul"])
def test_each_air_names_the_programs_class(air):
    import stark_tpu_torch.stark as stark

    d = airs.load(air)
    cls_name, keyword = d.PROGRAM_AIR
    assert keyword in getattr(stark, cls_name).__init__.__code__.co_varnames
    assert len(d.SHIFTS) >= 1 and d.COLUMNS >= 1 and d.ALPHAS >= 1
    assert os.path.isfile(airs.path(air, ".cpp"))


@pytest.mark.parametrize("name", ["tribmul", "../run", "fibmul.py", ""])
def test_an_unknown_air_is_refused(name):
    with pytest.raises(ValueError):
        airs.load(name)
    with pytest.raises(ValueError):
        tracemaker.values(name, P32, 5, 7)
    with pytest.raises(ValueError):
        ref.plain_trace(ref.Spec(name, P32, 5, 3, 4, 2), 5)


def test_reference_catches_a_changed_trace():
    spec = ref.Spec("fibonacci-square", P32, 5, 6, 4, 3)
    trace = ref.plain_trace(spec, 99)
    a = ref.prove(spec, trace, "cpu")[0]
    trace[0][17] = (trace[0][17] + 1) % P32
    with pytest.raises(ValueError):  # no longer low degree: FRI refuses
        ref.prove(spec, trace, "cpu")
    assert a[0] != ref.prove(ref.Spec("fibonacci-square", P32, 5, 6, 4, 3),
                             ref.plain_trace(spec, 98), "cpu")[0][0]
