"""The port's CLI (``python -m stark_tpu_torch``) as subprocesses with
--cpu: prove -> verify -> tamper, the proof file byte-identical to the
JAX package's CLI (``python -m stark_tpu prove --cpu``) with the same
arguments, the daemon round trip through ``prove --daemon``, and the
card as the default (a prove without --cpu exits non-zero here, where
there is no CUDA device).  Also the import guard of the entry points."""

import os
import subprocess
import sys

import pytest
import torch

from stark_tpu_torch import serve
from stark_tpu_torch.stark import StarkProof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--log2-trace", "5", "--blowup", "4", "--num-queries", "3"]


def run(package, *args, cwd, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", package, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("air", ["fibonacci-square", "tribmul"])
def test_prove_file_equals_jax_cli(air, tmp_path):
    args = ["prove", "--cpu", "--air", air, *SMALL, "--secret", "7"]
    mine = run("stark_tpu_torch", *args, "-o", "port.json", cwd=tmp_path)
    assert mine.returncode == 0, mine.stderr
    ref = run("stark_tpu", *args, "-o", "jax.json", cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "jax.json").read_bytes()


def test_prove_verify_tamper_round_trip(tmp_path):
    res = run("stark_tpu_torch", "prove", "--cpu", "--air", "mimc5",
              "--log2-trace", "5", "--blowup", "8", "--num-queries", "3",
              "--modulus", "goldilocks", "--compress", "-o", "p.bin",
              cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    blob = (tmp_path / "p.bin").read_bytes()
    assert blob[:4] == b"STP1"
    proof = StarkProof.deserialize(blob)
    assert proof.air_name == "mimc5" and proof.config.generator == 7
    ok = run("stark_tpu_torch", "verify", "p.bin", cwd=tmp_path)
    assert ok.returncode == 0, ok.stderr
    assert "verified" in ok.stderr
    k = len(proof.proof) // 2
    msg = bytearray(proof.proof[k])
    msg[0] ^= 1
    proof.proof[k] = bytes(msg)
    (tmp_path / "bad.json").write_bytes(proof.serialize())
    (tmp_path / "junk.bin").write_bytes(b"STP1" + blob[5:40])
    for name in ("bad.json", "junk.bin"):
        bad = run("stark_tpu_torch", "verify", name, cwd=tmp_path)
        assert bad.returncode == 1, bad.stderr
        assert "REJECTED" in bad.stderr


def test_prove_through_the_daemon(tmp_path):
    """prove --daemon spawns a CPU daemon on the socket and writes the
    same file as an in-process prove; the daemon stays up until shut
    down."""
    sock = str(tmp_path / "d.sock")
    args = ["prove", "--cpu", "--air", "tribmul", *SMALL]
    try:
        via = run("stark_tpu_torch", *args, "--daemon", "--socket", sock,
                  "-o", "daemon.json", cwd=tmp_path)
        assert via.returncode == 0, via.stderr
        assert serve.ping(sock)["platform"] == "cpu"
    finally:
        try:
            serve.request({"op": "shutdown"}, sock, timeout=30)
        except (ConnectionError, OSError):
            pass
    direct = run("stark_tpu_torch", *args, "-o", "direct.json", cwd=tmp_path)
    assert direct.returncode == 0, direct.stderr
    assert (tmp_path / "daemon.json").read_bytes() == (
        tmp_path / "direct.json").read_bytes()


def test_the_card_is_the_default(tmp_path):
    """Without --cpu, prove and serve need a CUDA device and exit non-zero
    with a message where there is none, --mesh too; with --cpu, --mesh 2
    proves over two logical CPU shards."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for args in (["prove", *SMALL, "-o", "p.json"],
                 ["serve", "--socket", "x.sock"]):
        res = run("stark_tpu_torch", *args, cwd=tmp_path)
        assert res.returncode == 2, res.stderr
        assert "no CUDA device: pass --cpu" in res.stderr
    assert not (tmp_path / "p.json").exists()
    mesh = run("stark_tpu_torch", "prove", "--mesh", "2", *SMALL,
               cwd=tmp_path)
    assert mesh.returncode == 2 and "no CUDA device" in mesh.stderr
    mesh = run("stark_tpu_torch", "prove", "--cpu", "--mesh", "2", *SMALL,
               "-o", "m.json", cwd=tmp_path)
    assert mesh.returncode == 0, mesh.stderr
    assert "2-shard mesh" in mesh.stderr
    assert StarkProof.deserialize((tmp_path / "m.json").read_bytes()).proof


def test_info(tmp_path):
    res = run("stark_tpu_torch", "info", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert f"torch {torch.__version__}" in res.stdout
    assert "CUDA kernels sha_chain:" in res.stdout
    assert "native host trace host_trace:" in res.stdout


def test_entry_points_import_no_jax():
    """The CLI, the daemon, the families and the container import neither
    jax nor stark_tpu (a fresh interpreter)."""
    code = (
        "import sys\n"
        "import stark_tpu_torch.cli, stark_tpu_torch.serve\n"
        "import stark_tpu_torch.stark.families\n"
        "import stark_tpu_torch.channel.compress\n"
        "import stark_tpu_torch.__main__\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'stark_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_verify_takes_cpu(tmp_path):
    """``verify --cpu`` (the JAX CLI's flag) verifies as ``verify`` does:
    the verifier is host code."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import prove

    pr = prove(ProverConfig(log2_trace=5, blowup=4, num_queries=3),
               device="cpu")
    (tmp_path / "p.json").write_bytes(pr.serialize())
    res = run("stark_tpu_torch", "verify", "p.json", "--cpu", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "verified" in res.stderr


@pytest.mark.parametrize("flags", [[], ["--quick", "--cpu"]])
def test_bench_says_it_is_not_ported(flags, capsys):
    """``bench`` takes the JAX CLI's flags and exits non-zero with one
    line naming the roadmap item, without running ``bench.py`` (which
    imports JAX)."""
    from stark_tpu_torch import cli

    assert cli.main(["bench", *flags]) == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1
    assert "no benchmark yet" in err and "ROADMAP.md item 10" in err
