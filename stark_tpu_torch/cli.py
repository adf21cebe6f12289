"""CLI — ``python -m stark_tpu_torch <prove|verify|serve|bench|info>``
(counterpart of ``stark_tpu/cli.py``).

``prove`` and ``serve`` run on the card unless given ``--cpu``; on a
machine with no CUDA device they exit non-zero without ``--cpu`` and
never carry on on the CPU.  ``verify`` is host code (it takes ``--cpu``,
as the JAX CLI's does, and ignores it).  ``bench`` takes the JAX CLI's
arguments and exits non-zero: the port has no benchmark yet.
"""

from __future__ import annotations

import argparse
import sys
import time

# named field shortcuts: (modulus, multiplicative generator)
_FIELDS = {
    "stark101": (3 * 2**30 + 1, 5),
    "goldilocks": (2**64 - 2**32 + 1, 7),
}
# the hand-written AIRs; the declarative families follow (families.py)
_HAND_WRITTEN = ("fibonacci-square", "mimc3", "fibmul")


class NoDevice(Exception):
    """The command needs the card and the machine has none."""


def _field(value: str):
    if value in _FIELDS:
        return _FIELDS[value]
    return (int(value), None)


def _add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--log2-trace", type=int, default=10,
                    help="trace rows = 2^k - 1 (default 10: STARK-101 shape)")
    ap.add_argument("--blowup", type=int, default=8)
    ap.add_argument("--num-queries", type=int, default=16)
    ap.add_argument("--modulus", type=_field, default=None, metavar="P",
                    help="field modulus (int), or a name: "
                    + ", ".join(_FIELDS))
    ap.add_argument("--generator", type=int, default=None,
                    help="multiplicative generator of GF(p) (auto for "
                    "named fields)")
    ap.add_argument("--cpu", action="store_true",
                    help="prove on the CPU (plain kernel versions) instead "
                         "of the card")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard over the first N visible GPUs (with --cpu: "
                         "N logical CPU shards)")


def _make_config(args):
    from stark_tpu_torch.config import DEFAULT_MODULUS, ProverConfig

    modulus, gen = args.modulus if args.modulus else (DEFAULT_MODULUS, None)
    if args.generator is not None:
        gen = args.generator
    kw = {"generator": gen} if gen is not None else {}
    return ProverConfig(
        modulus=modulus,
        log2_trace=args.log2_trace,
        blowup=args.blowup,
        num_queries=args.num_queries,
        **kw,
    )


def _device(args) -> str:
    """"cpu" with --cpu, else "cuda" — which must exist."""
    if args.cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: pass --cpu to run on the CPU")
    return "cuda"


def _mesh(args, device: str):
    """The mesh of --mesh N (as the JAX CLI's ``_setup``): the first N
    visible GPUs, or N logical shards on the CPU with --cpu; None
    without --mesh.  Fewer devices than N raise."""
    if not args.mesh:
        return None
    from stark_tpu_torch.dist import make_mesh

    if device == "cpu":
        return make_mesh(args.mesh, devices=["cpu"] * args.mesh)
    try:
        return make_mesh(args.mesh)
    except ValueError as e:
        raise NoDevice(str(e)) from None


def cmd_prove(args) -> int:
    from stark_tpu_torch import serve
    from stark_tpu_torch.stark import prove
    from stark_tpu_torch.stark.families import build_air
    from stark_tpu_torch.utils.logging import setup_logging

    log = setup_logging()
    cfg = _make_config(args)
    cfg.validate()
    log.info("proving %s: 2^%d-1 rows, blowup %d, %d queries%s",
             args.air, args.log2_trace, args.blowup, args.num_queries,
             f", {args.mesh}-shard mesh" if args.mesh else "")
    if args.daemon:
        # the daemon proves on its own device: this process stays off the
        # card, and checks that the daemon is where --cpu says
        info = serve.ensure_daemon(args.socket,
                                   extra_args=("--cpu",) if args.cpu else ())
        path = args.socket or serve.default_socket_path()
        want = "cpu" if args.cpu else "gpu"
        if info["platform"] != want:
            raise NoDevice(f"the daemon on {path} serves "
                           f"{info['platform']}, not {want}")
        log.info("daemon pid %d on %s (%s, %d proves served)",
                 info["pid"], path, info["device"], info["proves"])
        t0 = time.perf_counter()
        proof = serve.daemon_prove(
            cfg, air=args.air, secret=args.secret, mimc_key=args.mimc_key,
            socket_path=args.socket)
        dt = time.perf_counter() - t0
        blob = proof.serialize(compress=args.compress)
        with open(args.output, "wb") as fh:
            fh.write(blob)
        log.info("proved via daemon in %.2fs: %d transcript bytes -> %s",
                 dt, proof.size_bytes(), args.output)
        return 0
    device = _device(args)
    mesh = _mesh(args, device)
    t0 = time.perf_counter()
    air = build_air(args.air, args.secret, mimc_key=args.mimc_key)
    proof = prove(cfg, a1=args.secret, air=air, device=device, mesh=mesh)
    dt = time.perf_counter() - t0
    blob = proof.serialize(compress=args.compress)
    with open(args.output, "wb") as fh:
        fh.write(blob)
    log.info("proved on %s in %.2fs: %d transcript bytes, %d on disk%s -> "
             "%s (public output %d)",
             device, dt, proof.size_bytes(), len(blob),
             " (compressed)" if args.compress else "", args.output,
             proof.a_last)
    return 0


def cmd_verify(args) -> int:
    from stark_tpu_torch.stark import (StarkProof, StarkVerificationError,
                                       verify)
    from stark_tpu_torch.utils.logging import setup_logging

    log = setup_logging()
    with open(args.proof, "rb") as fh:
        try:
            proof = StarkProof.deserialize(fh.read())
        except Exception as e:  # corrupt container: reject, don't crash
            log.error("proof REJECTED: unreadable container (%s)", e)
            return 1
    t0 = time.perf_counter()
    try:
        verify(proof)
    except StarkVerificationError as e:
        log.error("proof REJECTED: %s", e)
        return 1
    log.info("proof verified in %.3fs (a0=%d, a_last=%d)",
             time.perf_counter() - t0, proof.a0, proof.a_last)
    return 0


def cmd_bench(args) -> int:
    """The JAX CLI runs ``bench.py``, which imports JAX: the port has no
    benchmark of its own yet (ROADMAP.md item 10)."""
    print("stark_tpu_torch bench: the port has no benchmark yet (ROADMAP.md "
          "item 10)", file=sys.stderr)
    return 2


def cmd_serve(args) -> int:
    from stark_tpu_torch import serve
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import prove
    from stark_tpu_torch.utils.logging import setup_logging

    log = setup_logging()
    device = _device(args)
    for log2 in args.warm or ():
        t0 = time.perf_counter()
        prove(ProverConfig(log2_trace=log2, blowup=4, num_queries=16),
              device=device)
        log.info("warm prove 2^%d done in %.1fs", log2,
                 time.perf_counter() - t0)
    server = serve.ProverServer(args.socket, device=device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_info(args) -> int:
    import os

    import torch

    import stark_tpu_torch
    from stark_tpu_torch import _build

    print(f"stark_tpu_torch {stark_tpu_torch.__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}")
    else:
        print("devices: no CUDA device (prove/serve need --cpu)")
    for name in _build.SIGNATURES:
        kind = ("native " + name.replace("_", " ")
                if name in _build.HOST_SOURCES else "CUDA kernels")
        built = os.path.exists(_build._lib_path(name))
        print(f"{kind} {name}: {'built' if built else 'not built'}")
    return 0


def main(argv=None) -> int:
    from stark_tpu_torch.stark.families import FAMILIES

    ap = argparse.ArgumentParser(prog="stark_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove", help="produce a STARK proof")
    _add_config_args(p)
    p.add_argument("--secret", type=int, default=3141592,
                   help="the private a_1 / x_0 (default: STARK-101's pi)")
    p.add_argument("--air", default="fibonacci-square",
                   choices=[*_HAND_WRITTEN, *FAMILIES],
                   help="statement family to prove (families beyond the "
                        "first three are declarative AirSpec specs)")
    p.add_argument("--mimc-key", type=int, default=777)
    p.add_argument("-o", "--output", default="proof.json")
    p.add_argument("--compress", action="store_true",
                   help="write the binary node-deduplicated container "
                        "(channel/compress.py) instead of JSON")
    p.add_argument("--daemon", action="store_true",
                   help="prove via the resident daemon (spawning it if "
                        "needed; stark_tpu_torch/serve.py)")
    p.add_argument("--socket", default=None,
                   help="daemon socket path (default: per-user tmp)")
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser(
        "serve", help="run the resident prover daemon (stark_tpu_torch/"
                      "serve.py)")
    p.add_argument("--socket", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="serve CPU proves instead of the card's")
    p.add_argument("--warm", type=int, nargs="*", default=None,
                   metavar="LOG2_TRACE",
                   help="prewarm the prove pipeline at these trace sizes "
                        "before serving (e.g. --warm 14 18)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("verify", help="verify a proof file (host code)")
    p.add_argument("proof")
    p.add_argument("--cpu", action="store_true",
                   help="accepted for the JAX CLI's sake: verifying is host "
                        "code")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("bench", help="the benchmark suite (not ported yet)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="environment info")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (NoDevice, NotImplementedError) as e:
        print(f"stark_tpu_torch {args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
