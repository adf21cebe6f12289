"""Multi-process runtime (counterpart of ``stark_tpu/dist/multihost.py``).

The JAX package forms its process group with ``jax.distributed`` and lets
XLA lower the collectives; the port's process group is
``torch.distributed``'s, one process a card under ``torchrun`` (NCCL) or
several processes of logical shards (gloo), and its collectives are the
process mesh's exchanges (``dist/mesh.py``):

* :func:`initialize` forms the process group, idempotently, from its
  arguments or torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
  ``WORLD_SIZE``; one process forms none.
* :func:`global_mesh`: every rank's local devices, in rank order.
* :func:`multihost_prove`, the rank-0-transcript convention: every
  process runs the same deterministic prove over the global mesh, keeps
  its own Fiat-Shamir state, absorbs the same replicated roots and so
  holds the same transcript, with no broadcast; with `check_agreement`
  :func:`check_transcript_agreement` all-gathers a 4-byte digest of it
  and raises on a divergence.

Run it with ``python -m torch.distributed.run --nproc-per-node N`` (each
process calls :func:`initialize` with no arguments) or by calling
:func:`initialize` with an address, a world size and a rank.
"""

from __future__ import annotations

import hashlib
import os

import torch
import torch.distributed as dist

from stark_tpu_torch.dist.mesh import make_mesh, rank_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Idempotent ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` ("host:port"), the arguments
    defaulting to torchrun's variables.  One process (no world size, or
    1) forms no group.  `backend`: "nccl" (one card a rank) or "gloo";
    default NCCL where CUDA is available, else gloo."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or num_processes == 1:
        return
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_info() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(backend: str | None = None, devices=None):
    """The mesh over every process's local devices, in rank order.
    `backend` names the devices' platform, as the JAX package's does (not
    the process group's backend, which is ``make_mesh``'s): "cpu" (one
    CPU shard a process) or "cuda" (default: with several processes
    this rank's card, ``mesh.rank_device``, else every visible GPU);
    `devices` lists this process's shards instead (a device may repeat:
    logical shards).  The process group's own backend carries the
    exchanges."""
    world = process_info()[1]
    if devices is None:
        if backend == "cpu":
            devices = ["cpu"]
        elif world > 1:
            devices = [rank_device()]
    if world == 1:
        return make_mesh(devices=devices)
    return make_mesh(devices=devices, backend=dist.get_backend())


def multihost_prove(cfg, a1: int = 3141592, backend: str | None = None,
                    check_agreement: bool = False, devices=None, **kw):
    """Run the sharded prover over every process's devices
    (:func:`global_mesh`); every process calls this alike and gets the
    same proof.  With `check_agreement` the transcript digests are
    cross-checked over the processes.  `kw` goes to ``prove``."""
    from stark_tpu_torch.stark.prover import prove

    mesh = global_mesh(backend, devices)
    proof = prove(cfg, a1=a1, mesh=mesh, **kw)
    if check_agreement and process_info()[1] > 1:
        check_transcript_agreement(proof.proof)
    return proof


def check_transcript_agreement(proof_messages) -> None:
    """All-gather a 4-byte digest of the transcript over the processes
    and raise on a divergence: the prove is deterministic, so any
    difference is a fault (a corrupted process, a nondeterministic
    kernel, a bad resume), surfaced instead of emitting proofs that
    differ by process."""
    digest = hashlib.sha256(b"".join(proof_messages)).digest()[:4]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    local = torch.tensor([int.from_bytes(digest, "big")], dtype=torch.int64,
                         device=dev)
    every = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(every, local)
    values = [int(t) for t in every]
    if any(v != values[0] for v in values):
        raise RuntimeError("transcript divergence across processes: digests "
                           f"{[hex(v) for v in values]}")
