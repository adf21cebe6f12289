"""A run with the timed path broken underneath comes out not correct,
and so does the control; a sound run comes out correct.  The harness's
look for a card is skipped (run_cell on the CPU at a small trace)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, run  # noqa: E402

SMALL = {"fibsq-2p23-trace": 6, "fibmulgl-2p21-trace": 5,
         "fibsq-2p23-witness": 6}
SEED = 2**33 + 12345


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    bench = run.load_bench()
    cell = run.find(bench["workloads"], workload, "workload")
    res = run.run_cell(bench, cell, SEED, 0.5, False, device="cpu",
                       spec_override={"log2_trace": SMALL[workload]})
    assert res["correct"], res["checks"]
    assert res["checks"]["ref_mismatch"]["value"] == 0
    assert ("repeat_mismatch" in res["checks"]) == workload.endswith("trace")
    # the cell's end-to-end metrics, but the card's peak, which the CPU
    # has not
    want = {m["name"] for m in run.cell_metrics(bench, cell, False)}
    assert set(res["metrics"]) == want - {"peak_mem_mib"}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_run_reports_the_cells_per_layer_metrics(workload):
    """Traced on the CPU: the synced phase walls of the cell's own
    per-layer metrics (those that `moves` an end-to-end metric the cell
    reports); the device's (rooflines, idle) need the card."""
    bench = run.load_bench()
    cell = run.find(bench["workloads"], workload, "workload")
    res = run.run_cell(bench, cell, SEED + 3, 0.5, True, device="cpu",
                       spec_override={"log2_trace": SMALL[workload]})
    assert res["correct"], res["checks"]
    want = {m["name"] for m in run.cell_metrics(bench, cell, True)
            if m["source"] == "program_span"}
    assert want and set(res["metrics"]) == want
    e2e = {m["name"] for m in run.cell_metrics(bench, cell, False)}
    assert all(m["moves"] in e2e for m in run.cell_metrics(bench, cell,
                                                           True))


def test_every_metric_has_a_reader():
    import importlib

    bench = run.load_bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = importlib.import_module(
            "benchmark.metrics." + m["name"].split(".", 1)[0])
        assert callable(reader.read), m["name"]


@pytest.mark.parametrize("mode", ["stale", "flip", "control"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_broken_run_is_not_correct(workload, mode):
    got = control.read(workload, SEED + 1, mode, 0.5, "cpu",
                       log2_trace=SMALL[workload])
    assert got["correct"] is False
    assert got["checks"]["ref_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", ["fibsq-2p23-trace",
                                      "fibmulgl-2p21-trace"])
def test_answers_differing_between_proves_are_not_correct(workload):
    # a window long enough for the pool of 4 to repeat on the CPU, where
    # a prove at these sizes takes about 2 s
    got = control.read(workload, SEED + 2, "alternate", 16.0, "cpu",
                       log2_trace=5)
    assert got["attempted"] > 4  # the pool of 4 repeats
    assert got["correct"] is False
    assert got["checks"]["repeat_mismatch"]["value"] > 0
