"""Resident prover daemon (counterpart of ``stark_tpu/serve.py``): one
process holds the card, its built kernels, NTT plans and AIR contexts,
and answers prove requests over a Unix domain socket, so a repeat prove
skips the cold start (library load, context and twiddle tables).

    python -m stark_tpu_torch serve --warm 14      # hold the card, prewarm
    python -m stark_tpu_torch prove --daemon ...   # a thin client

Protocol: framed JSON (frame = 4-byte big-endian length + JSON payload;
a proof rides as base64 of its serialized container), the JAX package's:

    {"op": "ping"}                          -> {"ok", "platform", "device",
                                                "pid", "uptime_s", "proves"}
    {"op": "prove", "config": {...}, "air": NAME, "secret": INT,
     "mimc_key": INT, "compress": BOOL}     -> {"ok", "proof_b64", "wall_s"}
    {"op": "warm", "config": {...}, "air"}  -> {"ok", "wall_s"}   (no proof)
    {"op": "stats"}                         -> {"ok", "metrics", ...}
    {"op": "shutdown"}                      -> {"ok"}

``platform`` is "gpu" for a daemon on the card, "cpu" for one started
with ``--cpu``.  The client side (``request``, ``daemon_prove``) never
touches the card: it holds no CUDA context on the daemon's device.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import struct
import subprocess
import sys
import tempfile
import threading
import time

_FRAME = struct.Struct(">I")
_MAX_FRAME = 256 * 1024 * 1024  # proofs are ~100 KB; big-trace ~tens MB


def default_socket_path() -> str:
    """``$STARK_TPU_TORCH_SOCKET``, else a per-user socket in the temporary
    directory (never the JAX package's daemon socket)."""
    return os.environ.get(
        "STARK_TPU_TORCH_SOCKET",
        os.path.join(tempfile.gettempdir(),
                     f"stark_tpu_torch-{os.getuid()}.sock"))


def _send_frame(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(_FRAME.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> dict:
    (n,) = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame too large: {n}")
    return json.loads(_recv_exact(sock, n).decode())


def _config_to_wire(cfg) -> dict:
    return {"modulus": cfg.modulus, "generator": cfg.generator,
            "log2_trace": cfg.log2_trace, "blowup": cfg.blowup,
            "num_queries": cfg.num_queries}


def _config_from_wire(c: dict):
    from stark_tpu_torch.config import ProverConfig

    kw = {k: c[k] for k in
          ("log2_trace", "blowup", "num_queries") if k in c}
    if c.get("modulus") is not None:
        kw["modulus"] = c["modulus"]
    if c.get("generator") is not None:
        kw["generator"] = c["generator"]
    cfg = ProverConfig(**kw)
    cfg.validate()
    return cfg


class ProverServer:
    """Owns the device and the prover's caches; serves proves over a
    socket.  One prove at a time (one card, and the Fiat-Shamir pipeline
    is serial); concurrent client connections queue on the prove lock."""

    def __init__(self, socket_path: str | None = None, device="cuda"):
        import torch

        self.socket_path = socket_path or default_socket_path()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the daemon serves on the "
                               "card unless started with device='cpu'")
        self._prove_lock = threading.Lock()
        self._t0 = time.time()
        self._proves = 0
        self._server: socketserver.ThreadingUnixStreamServer | None = None

    # -- request handlers -------------------------------------------------

    def _do_ping(self, req: dict) -> dict:
        import torch

        on_card = self.device.type == "cuda"
        return {"ok": True, "platform": "gpu" if on_card else "cpu",
                "device": (torch.cuda.get_device_name(self.device)
                           if on_card else "cpu"),
                "pid": os.getpid(), "uptime_s": time.time() - self._t0,
                "proves": self._proves}

    def _do_prove(self, req: dict, keep_proof: bool = True) -> dict:
        from stark_tpu_torch.stark import prove
        from stark_tpu_torch.stark.families import build_air

        cfg = _config_from_wire(req.get("config") or {})
        secret = int(req.get("secret", 3141592))
        air = build_air(req.get("air", "fibonacci-square"), secret,
                        mimc_key=int(req.get("mimc_key", 777)))
        with self._prove_lock:
            t0 = time.perf_counter()
            proof = prove(cfg, a1=secret, air=air, device=self.device)
            wall = time.perf_counter() - t0
            self._proves += 1
        resp = {"ok": True, "wall_s": wall}
        if keep_proof:
            blob = proof.serialize(compress=bool(req.get("compress")))
            resp["proof_b64"] = base64.b64encode(blob).decode()
        return resp

    def _do_stats(self, req: dict) -> dict:
        from stark_tpu_torch.utils.metrics import GLOBAL

        return {"ok": True, "metrics": GLOBAL.to_dict(),
                "proves": self._proves, "uptime_s": time.time() - self._t0}

    def _dispatch(self, req: dict) -> tuple[dict, bool]:
        op = req.get("op")
        if op == "ping":
            return self._do_ping(req), False
        if op == "prove":
            return self._do_prove(req), False
        if op == "warm":
            return self._do_prove(req, keep_proof=False), False
        if op == "stats":
            return self._do_stats(req), False
        if op == "shutdown":
            return {"ok": True}, True
        return {"ok": False, "error": f"unknown op {op!r}"}, False

    # -- server loop ------------------------------------------------------

    def serve_forever(self) -> None:
        from stark_tpu_torch.utils.logging import get_logger

        log = get_logger()
        path = self.socket_path
        if os.path.exists(path):
            # stale socket from a dead daemon: refuse to serve if a live
            # one answers, else clear it
            try:
                ping(path, timeout=2.0)
                raise RuntimeError(f"daemon already serving on {path}")
            except (ConnectionError, OSError, json.JSONDecodeError):
                os.unlink(path)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = _recv_frame(self.request)
                except (ConnectionError, json.JSONDecodeError):
                    return
                try:
                    resp, stop = outer._dispatch(req)
                except Exception as e:  # config/air errors -> client
                    log.exception("request failed")
                    resp, stop = {"ok": False,
                                  "error": f"{type(e).__name__}: {e}"}, False
                try:
                    _send_frame(self.request, resp)
                except (ConnectionError, OSError):
                    pass
                if stop:
                    threading.Thread(
                        target=outer._server.shutdown, daemon=True).start()

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        self._server = Server(path, Handler)
        os.chmod(path, 0o600)
        log.info("prover daemon serving on %s (pid %d, %s)", path,
                 os.getpid(), self.device)
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()
            try:
                os.unlink(path)
            except OSError:
                pass
            log.info("prover daemon stopped")


# -- client ---------------------------------------------------------------


def request(req: dict, socket_path: str | None = None,
            timeout: float | None = 600.0) -> dict:
    """One framed request/response roundtrip.  Raises ConnectionError /
    FileNotFoundError when no daemon is serving on the socket."""
    path = socket_path or default_socket_path()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(path)
        _send_frame(sock, req)
        return _recv_frame(sock)


def ping(socket_path: str | None = None, timeout: float = 5.0) -> dict:
    return request({"op": "ping"}, socket_path, timeout)


def daemon_prove(cfg, air: str = "fibonacci-square", secret: int = 3141592,
                 mimc_key: int = 777, compress: bool = False,
                 socket_path: str | None = None,
                 timeout: float | None = 600.0):
    """Prove via a resident daemon; returns a StarkProof whose transcript
    is byte-identical to an in-process ``prove`` of the same request."""
    from stark_tpu_torch.stark.prover import StarkProof

    resp = request(
        {"op": "prove", "config": _config_to_wire(cfg), "air": air,
         "secret": secret, "mimc_key": mimc_key, "compress": compress},
        socket_path, timeout)
    if not resp.get("ok"):
        raise RuntimeError(f"daemon prove failed: {resp.get('error')}")
    return StarkProof.deserialize(base64.b64decode(resp["proof_b64"]))


def ensure_daemon(socket_path: str | None = None, wait_s: float = 900.0,
                  extra_args: tuple = ()) -> dict:
    """Return a live daemon's ping response, spawning one if none is
    serving (``python -m stark_tpu_torch serve --socket PATH
    *extra_args``, e.g. ``("--cpu",)``).  The spawned daemon keeps running
    after this process exits — that persistence is the point."""
    path = socket_path or default_socket_path()
    try:
        return ping(path)
    except (ConnectionError, OSError):
        pass
    proc = subprocess.Popen(
        [sys.executable, "-m", "stark_tpu_torch", "serve",
         "--socket", path, *extra_args],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    deadline = time.time() + wait_s
    while time.time() < deadline:
        try:
            return ping(path)
        except (ConnectionError, OSError):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"daemon exited rc={proc.returncode} before serving")
            time.sleep(0.25)
    raise TimeoutError(f"daemon did not serve on {path} within {wait_s}s")
