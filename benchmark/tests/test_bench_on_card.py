"""One short run of each cell on the card: the harness's exit code and
its result line.  Marked ``cuda``; skips without a card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fibsq-2p23-trace",
                                      "fibmulgl-2p21-trace",
                                      "fibsq-2p23-witness"])
def test_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", workload, "--seed", "2999999999", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
