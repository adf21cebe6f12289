"""Cells over a mesh of shards, the blocked reference and the per-card
readings, on the CPU at 2^5 to 2^6 rows."""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.metrics import device_idle, peak_mem_mib  # noqa: E402
from benchmark.reference import stark as ref  # noqa: E402

SEED = 2**33 + 4321
P32 = 3 * 2**30 + 1
GL = 2**64 - 2**32 + 1
SMALL = {"fibsq-2p23-trace": 6, "fibmulgl-2p21-trace": 5}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sharded_cell_proves_as_the_unsharded_one(workload):
    """A configuration with ``shards: 4`` on four logical shards of the
    CPU: a correct run, whose proof is the configuration's without
    shards."""
    bench = run.load_bench()
    cell = run.find(bench["workloads"], workload, "workload")
    small = {"log2_trace": SMALL[workload]}
    proved = []

    def sharded(spec, device, devices):
        real = run.program(spec, device, devices)

        def prove(st, metrics=None):
            proved.append((st, real(st, metrics)))
            return proved[-1][1]

        return prove

    res = run.run_cell(bench, cell, SEED, 0.5, False, device="cpu",
                       spec_override=dict(small, shards=4),
                       devices=["cpu"] * 4, prove_fn=sharded, warmup=0)
    assert res["correct"], res["checks"]
    assert res["checks"]["ref_mismatch"]["value"] == 0
    assert res["device"]["count"] == 1
    st, proof = proved[0]
    plain = run.program(dict(run.load_config(bench, cell), **small), "cpu")
    assert plain(st) == proof


def test_shards_are_refused_where_the_cell_cannot_hold_them():
    bench = run.load_bench()
    cell = run.find(bench["workloads"], "fibsq-2p23-trace", "workload")
    spec = run.load_config(bench, cell)
    assert run.shard_devices(spec, cell, "cuda") is None
    with pytest.raises(SystemExit, match="4 shards on 1 card"):
        run.shard_devices(dict(spec, shards=4), cell, "cuda")
    with pytest.raises(SystemExit, match="power of two"):
        run.shard_devices(dict(spec, shards=3), dict(cell, chips=4), "cuda")
    with pytest.raises(ValueError):
        run.shard_devices(dict(spec, shards=4), cell, "cpu", ["cpu"] * 2)
    with pytest.raises(ValueError):
        run.shard_devices(spec, cell, "cpu", ["cpu"] * 4)
    four = dict(cell, chips=4)
    assert run.shard_devices(dict(spec, shards=4), four, "cuda") == [
        torch.device("cuda", i) for i in range(4)]
    assert run.shard_devices(dict(spec, shards=2), four, "cuda") == [
        torch.device("cuda", 0), torch.device("cuda", 2)]


@pytest.mark.parametrize("air,p,gen,log2,blowup", [
    ("fibonacci-square", P32, 5, 6, 4), ("fibmul", GL, 7, 6, 4)])
def test_blocked_reference_equals_one_block(air, p, gen, log2, blowup,
                                            monkeypatch):
    """Blocks of 2^3 and 2^5 lanes of a 2^8 to 2^9-point domain, with
    subtrees of 4 leaves (so blocks hold several, hash them to their
    roots, and paths rebuild them): the proof of one block the domain's
    size, which the unpatched constants give at these sizes."""
    spec = ref.Spec(air, p, gen, log2, blowup, 6)
    trace = ref.plain_trace(spec, 123456789)
    want = ref.prove(spec, trace, "cpu")
    monkeypatch.setattr(ref, "SUBTREE_LOG", 2)
    monkeypatch.setattr(ref, "BLOCK_ROWS", 2)
    for block_log in (3, 5):
        monkeypatch.setattr(ref, "BLOCK_LOG", block_log)
        assert ref.prove(spec, trace, "cpu") == want


def _event(device_type, name, start, end, index=0):
    return SimpleNamespace(device_type=device_type, name=name,
                           device_index=index, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def _profile(events):
    return SimpleNamespace(events=lambda: events)


def _timeline():
    """A phase of 1000 us with kernels at 100-400 (two overlapping) and
    600-700 on device 0: busy 400 us, idle 600 us."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    return [_event(cuda, "k1", 100, 300), _event(cuda, "k2", 200, 400),
            _event(cuda, "k1", 600, 700)]


def test_read_profile_on_one_device_is_the_union():
    from torch.autograd import DeviceType

    phase = _event(DeviceType.CPU, "phase:fri-commit", 0, 1000, -1)
    info = run.read_profile(_profile([phase] + _timeline()), [0])
    assert info["busy_s"] == 400e-6
    assert info["busy_s_per_device"] == [400e-6]
    assert info["idle_gaps"] == [["fri-commit", 600e-6]]
    assert info["kernel_s"] == pytest.approx({"k1": 300e-6, "k2": 200e-6})
    assert run.read_profile(_profile([phase] + _timeline())) == info
    record = {"profile": dict(info, traced_window_s=1000e-6),
              "peak_bytes": 3 << 20}
    assert device_idle.read(record) == pytest.approx(60.0)
    assert peak_mem_mib.read(record) == 3.0


def test_read_profile_over_two_devices_is_the_mean():
    """Card 1 busy 100-200 us and 600-700 us; a third card with no events
    counts as idle."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    phase = _event(DeviceType.CPU, "phase:queries", 0, 1000, -1)
    other = [_event(cuda, "k2", 100, 200, 1), _event(cuda, "k1", 600, 700, 1)]
    info = run.read_profile(_profile([phase] + _timeline() + other), [0, 1])
    assert info["busy_s_per_device"] == [400e-6, 200e-6]
    assert info["busy_s"] == pytest.approx(300e-6)
    assert info["idle_gaps"][0][1] == pytest.approx(700e-6)
    assert info["kernel_s"] == pytest.approx({"k1": 400e-6, "k2": 300e-6})
    three = run.read_profile(_profile([phase] + _timeline() + other),
                             [0, 1, 2])
    assert three["busy_s"] == pytest.approx(200e-6)
    assert three["idle_gaps"][0][1] == pytest.approx(800e-6)


def test_peak_is_the_fullest_cards(monkeypatch):
    peaks = {0: 5 << 20, 1: 9 << 20, 2: 7 << 20}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[d.index])
    cards = [torch.device("cuda", i) for i in range(3)]
    assert run.card_peaks(cards) == (9 << 20, [5 << 20, 9 << 20, 7 << 20])
    assert run.card_peaks(cards[:1]) == (5 << 20, [5 << 20])
    assert run.card_peaks([]) == (0, [])
    assert peak_mem_mib.read({"peak_bytes": run.card_peaks(cards)[0]}) == 9.0
