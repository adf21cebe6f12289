"""The no-JAX guard compares top-level module names whole, and the
harness refuses to run without a card."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import guard  # noqa: E402


def test_the_port_passes():
    mods = {"stark_tpu_torch": None, "stark_tpu_torch.stark.prover": None,
            "torch": None, "jaxtyping": None, "benchmark.run": None}
    assert guard.forbidden_modules(mods) == []


def test_jax_and_the_jax_package_fail():
    mods = {"stark_tpu": None, "stark_tpu.fields.fp": None, "jax": None,
            "jax.numpy": None, "jaxlib.xla_client": None, "flax": None,
            "stark_tpu_torch": None}
    assert guard.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "stark_tpu",
        "stark_tpu.fields.fp"]


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "fibsq-2p23-trace", "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_harness_loads_no_jax():
    """Importing the harness, the reference and the program leaves no JAX
    module loaded."""
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, "
            "benchmark.control, stark_tpu_torch.stark; "
            "from benchmark import guard; "
            "print(guard.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(
                             os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
