"""The port's prover daemon (stark_tpu_torch/serve.py), in a thread on a
tmp socket with device="cpu": its proofs equal the in-process port prove
and the JAX package's prove, it serves the families and the compressed
container, its error paths answer without killing it, and its stats
carry the prove's phase metrics."""

import socket
import struct
import threading
import time

import pytest
import torch

from stark_tpu.config import ProverConfig as JProverConfig
from stark_tpu.stark import prove as jprove
from stark_tpu_torch import serve
from stark_tpu_torch.config import ProverConfig
from stark_tpu_torch.stark import prove, verify
from stark_tpu_torch.stark.families import TRIBMUL
from stark_tpu_torch.utils.metrics import MetricsCollector

CFG = ProverConfig(log2_trace=6, blowup=4, num_queries=4)
PHASES = ("trace-lde", "trace-commit", "composition", "fri-commit",
          "queries")


def start(path):
    server = serve.ProverServer(path, device="cpu")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            serve.ping(path)
            return t
        except (ConnectionError, OSError):
            time.sleep(0.05)
    raise RuntimeError("daemon did not come up")


def stop(path, t):
    try:
        serve.request({"op": "shutdown"}, path, timeout=10)
    except (ConnectionError, OSError):
        pass
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sock") / "d.sock")
    t = start(path)
    yield path
    stop(path, t)


class TestProtocol:
    def test_ping(self, daemon):
        info = serve.ping(daemon)
        assert info["ok"] and info["platform"] == "cpu"
        assert info["device"] == "cpu" and "pid" in info

    def test_prove_equals_in_process_and_jax(self, daemon):
        via_daemon = serve.daemon_prove(CFG, secret=3141592,
                                        socket_path=daemon)
        direct = prove(CFG, a1=3141592, device="cpu")
        ref = jprove(JProverConfig(log2_trace=6, blowup=4, num_queries=4),
                     a1=3141592)
        assert via_daemon.serialize() == direct.serialize()
        assert via_daemon.serialize() == ref.serialize()
        assert verify(via_daemon)

    def test_prove_family(self, daemon):
        cfg = ProverConfig(log2_trace=5, blowup=4, num_queries=3)
        via_daemon = serve.daemon_prove(cfg, air="tribmul", secret=99,
                                        socket_path=daemon)
        direct = prove(cfg, air=TRIBMUL(b0=99), device="cpu")
        assert via_daemon.proof == direct.proof
        assert via_daemon.publics == direct.publics
        assert verify(via_daemon)

    def test_compressed_container(self, daemon):
        p = serve.daemon_prove(CFG, compress=True, socket_path=daemon)
        assert p.proof == prove(CFG, device="cpu").proof
        assert verify(p)

    def test_unknown_op_is_error_not_crash(self, daemon):
        resp = serve.request({"op": "transmogrify"}, daemon)
        assert resp == {"ok": False, "error": "unknown op 'transmogrify'"}
        assert serve.ping(daemon)["ok"]

    def test_bad_config_is_error_not_crash(self, daemon):
        resp = serve.request(
            {"op": "prove", "config": {"modulus": 6}}, daemon)
        assert not resp["ok"] and "modulus" in resp["error"]
        assert serve.ping(daemon)["ok"]

    def test_bad_air_is_error(self, daemon):
        resp = serve.request(
            {"op": "prove", "config": {"log2_trace": 6, "blowup": 4,
                                       "num_queries": 4},
             "air": "nope"}, daemon)
        assert not resp["ok"] and "nope" in resp["error"]
        with pytest.raises(RuntimeError, match="daemon prove failed"):
            serve.daemon_prove(CFG, air="nope", socket_path=daemon)

    def test_warm_returns_no_proof(self, daemon):
        before = serve.ping(daemon)["proves"]
        resp = serve.request(
            {"op": "warm",
             "config": {"log2_trace": 6, "blowup": 4, "num_queries": 4}},
            daemon)
        assert resp["ok"] and "proof_b64" not in resp and resp["wall_s"] > 0
        assert serve.ping(daemon)["proves"] == before + 1

    def test_stats_lists_the_phases(self, daemon):
        serve.daemon_prove(CFG, socket_path=daemon)
        resp = serve.request({"op": "stats"}, daemon)
        assert resp["ok"] and resp["proves"] >= 1
        names = [ph["name"] for ph in resp["metrics"]["phases"]]
        assert set(PHASES) <= set(names)
        assert resp["metrics"]["counters"]["proves"] >= 1
        assert resp["metrics"]["counters"]["proof_bytes"] > 0

    def test_garbage_frame_does_not_kill_server(self, daemon):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(daemon)
            s.sendall(struct.pack(">I", 7) + b"not-js")
        assert serve.ping(daemon)["ok"]


class TestClientErrors:
    def test_no_daemon_raises(self, tmp_path):
        with pytest.raises((ConnectionError, OSError)):
            serve.ping(str(tmp_path / "none.sock"), timeout=1.0)

    def test_frame_too_large_rejected(self):
        class Fake:
            def __init__(self):
                self.data = struct.pack(">I", serve._MAX_FRAME + 1)
                self.pos = 0

            def recv(self, n):
                chunk = self.data[self.pos:self.pos + n]
                self.pos += len(chunk)
                return chunk

        with pytest.raises(ConnectionError, match="frame too large"):
            serve._recv_frame(Fake())


def test_stale_socket_replaced_and_removed_on_shutdown(tmp_path):
    path = str(tmp_path / "stale.sock")
    with open(path, "w"):
        pass  # a dead daemon's leftover
    t = start(path)
    assert serve.ping(path)["ok"]
    with pytest.raises(RuntimeError, match="already serving"):
        serve.ProverServer(path, device="cpu").serve_forever()
    stop(path, t)
    assert not (tmp_path / "stale.sock").exists()


def test_the_card_is_the_default():
    """A daemon serves the card unless asked for the CPU; without CUDA it
    refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ProverServer("unused.sock")


def test_prove_records_the_phases():
    mx = MetricsCollector()
    pr = prove(CFG, device="cpu", metrics=mx)
    assert [ph.name for ph in mx.phases] == list(PHASES)
    assert mx.counters == {"proves": 1, "proof_bytes": pr.size_bytes()}
    assert mx.to_dict()["total_wall_s"] > 0


def test_default_socket_path_env(monkeypatch):
    monkeypatch.setenv("STARK_TPU_TORCH_SOCKET", "/x/port.sock")
    monkeypatch.setenv("STARK_TPU_SOCKET", "/x/jax.sock")
    assert serve.default_socket_path() == "/x/port.sock"
    monkeypatch.delenv("STARK_TPU_TORCH_SOCKET")
    path = serve.default_socket_path()
    assert "stark_tpu_torch-" in path and path != "/x/jax.sock"
