#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stark_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--phase multiproc|api|mega]

Builds the port's CUDA kernels from ``stark_tpu_torch/csrc`` (and its
native host trace from ``stark_tpu_torch/native``), holds each kernel
against its plain torch version on the card at the prover's shapes
(exact equality; the NTT kernels, one two-pass family counted as K1 up to
2^22 and as K2 above, also against the Stockham dataflow, on every branch
of their split, and in their batched form on (C, n) columns), proves the
four u32 golden vectors byte-identical to
``tests/vectors/golden_proofs.json``, then proves the Fibonacci-square
statement at 2^20 rows and at 2^24 rows, the MiMC³ statement at 2^20
rows and the two-column FibMul statement at 2^20 and 2^24 rows (blowup
4, 16 queries; LDE 2^22 and 2^26) twice each: the two transcripts must
agree and hash (SHA-256 of the messages) to the pinned transcript
digest, the port's host verifier must accept the proof and reject it
with one byte flipped, and the kernels of each path must have launched
(K1 on the 2^20 paths; K2 on the 2^24 paths; one NTT wrapper call per
transform whatever C, two a prove; each tree as ``merkle/tree.py``
splits it: K3's subtree form once a tree of more than 2^10 leaves, or
once a chunk of a chunked tree, its row form for FibMul's trace tree, K4
once a level between the subtree's top and the tail, the tail once a
tree; K5's query form exactly once per prove; the kernels line gives
each prove's launches).  K5 has two entry points, the chain form (the channel's absorbs
and draws) and the query form (all queries of a prove in one launch);
both count as K5 and both are held against their plain
versions: the chain form on a 5,000-block stream with mixed flags and on
the proves' query streams, the query form on the 2^20 and 2^24 plans
and on plans of 2- and 6-column row openings, with seeded trees.

The large-trace path: every tree of the single-fetch prove stores only
its levels of at most 2^22 nodes (``merkle/tree.py``), a tree of 2^27
leaves or more builds in chunks of 2^24 leaves, and K5's query form
recomputes the unstored siblings inside its launch.  The chunked build
is held against the one-pass pruned build at 2^27 leaves (one u32
column, the C = 2 row form, the 64-bit mode); the query form with the
recompute against its plain version on the pruned plans of fib-sq 2^24
and 2^26, FibMul 2^24 and FibMul-GL 2^22.  Fib-sq is proved at 2^25 and
2^26 rows (LDE 2^27, 2^28) and FibMul-GL at 2^22 and 2^24 rows as
above, with pinned digests; fib-sq 2^24 (with warm walls in turns),
2^25, 2^26 and FibMul-GL 2^22 are proved once more with pruning off
(``STARK_TPU_TORCH_NO_PRUNE``), which must give the same transcript.
Every prove's cold run is synced a phase at a time and logs its five
phases' walls and peak device memory.

Over the Goldilocks field (p = 2^64 - 2^32 + 1, values as (hi, lo) limb
planes) it holds K3's 64-bit mode against its plain version (one column
at 2^22 and 2^26 leaves, the row form at C = 1..6 and 2 x 2^22) and K5's
query form on the FibMul-GL plan (two value slots a 64-bit value), proves
the fibmul_gl_2e5 golden vector, the Fibonacci-square and FibMul
statements at 2^20 rows as above (pinned digests; no K1/K2 launch: the
Goldilocks NTT is the 64-bit kernels, two launches a prove; K3's 64-bit
mode once per tree),
FibMul-GL at 2^14 and 2^18 rows for a table of walls and peak memory,
and both statements at 2^8 and 2^12 rows, whose transcripts must equal
the digests the JAX package made on a CPU (``GL_ANCHORS``,
``scripts/jax_anchor_digests.py``).

The user's entry points: the declarative families (``families.build_air``
with their default witnesses) ``tribmul`` (three columns: the batched
NTT at C = 3, K3's row form at C = 3, 24-byte row openings), ``mimc5``
and ``mimc5rc`` (degree 5 at blowup 8: LDE 2^23 on the K2 route, 22
folds; mimc5rc's 8-cycle periodic column) over the u32 field and
``tribmul`` over Goldilocks (K3's 64-bit row form at C = 3, six value
slots a row opening), each at 2^20 rows as the proves above (pinned
digests, launches checked) with its Python host-trace wall, and at 2^8
rows in both fields against the JAX package's digests
(``FAMILY_ANCHORS``); the kernels at those shapes against their plain
versions (the batched NTT at (3, 2^20) and (3, 2^22), K3's row form at
C = 3 over 2^22 rows in both modes, K5's query form on both tribmul
plans).  Then the prover daemon, ``python -m stark_tpu_torch serve``
started without ``--cpu`` as a child process: its ping must name the
card; it answers ``warm``, the four family proves (one in the
compressed container), each verified and equal to the in-process
transcript, a client process's prove (which must leave CUDA
uninitialised), ``stats`` (the five phase names) and ``shutdown`` (exit
0, socket removed).  Last the CLI on the card: ``prove --air tribmul
--log2-trace 20 --blowup 4``, ``verify`` (exit 0) and ``verify`` of a
copy with one byte flipped (exit 1, REJECTED).

The tree build: K3 is one kernel, ``sha_subtree``, that hashes a block
of 2^10 leaves and the 5 node levels above them in shared memory (K3
alone without the levels for an odd tree's leaves), and the tail is the
same kernel over one block from a level of at most 2^10 nodes to the
root.  Each is held against its plain version: the subtree kernel in
every form at 2^22 / 2^26 leaves, the whole split (``build_tree``) at
2^22 leaves in both modes, one column and C = 1..6, prune 0..6, the tail
at 2^0 .. 2^10 leaves and nodes, the tree batch of 16 x 2^22; the tree
measurements of ``scripts/tree_build_times.py`` (K3 alone and the
builds at 2^20 / 2^22 / 2^26 leaves with each kernel's device time, K4
a launch and its host time) are printed for this checkout.

The ``kernels`` line gives each kernel's time and its plain version's
(CUDA events, median of 5 after a warm-up) beside its bound: the larger
of the bytes it must move over 3.35 TB/s and its 32-bit integer
operations over a derived peak of SMs x 128 (four schedulers, each one
32-lane instruction a clock) x the maximum SM clock that nvidia-smi
reports.  K5 is one serial chain: its bound is a latency bound, with the
dependent-issue latency that a clock64 probe measures on the card in
this run (printed beside the assumed 4 cycles).

The rest of the single-device API: each batched kernel form of
``stark/batch.py`` (K3 / K4 over 16 trees of 2^22 leaves, K5's chain
form on 16 mixed-flag streams, K5's query form on 16 proofs of the 2^20
plan) against its plain version and 16 single launches; ``batch``:
``prove_batch`` of 16 fib-sq, 4 FibMul and 4 fib-sq-GL statements at
2^20 rows (statement 0 the pinned one), every proof equal to its
statement's prove and verified, each kernel launched as often as one
prove launches it, with the batch's and the sequential proves' walls,
proofs/s and the batch's peak memory; ``resume``: ``prove_resumable`` of
fib-sq 2^24 stopped after each phase, serialized and resumed to the
pinned digest, a corrupted checkpoint refused, the per-phase prove's
walls beside the single-fetch prove's; ``fri``: BASELINE config #3
(``bench.py``), ``fri_commit`` and ``decommit_fri`` at 2^21 points five
times, the transcript verified, equal on the BatchGather loop, the
query form launched once a decommit.

``mesh``: the sharded prove (``stark_tpu_torch/dist``) on four logical
shards of the one card: the four-step NTT and INTT and the sharded tree
at 2^26 points against the single-device K2 transform and tree (root
and 16 paths), timed beside them with the bytes their exchanges copy;
K5's sharded query form (each source a table of entries, one a block or
subtree) on the fib-sq 2^24 mesh plan against its plain version, timed;
fib-sq 2^24 proved on the mesh to the pinned single-device digest on
the ``single-fetch-mesh`` path, verified, tamper-rejected, its copies
equal to ``dist.comm``'s model, every kernel of the path launched and
the sharded query form once (its row of the kernels line), cold and
warm walls and phases' peaks; FibMul and fib-sq-GL 2^20 on two shards
and a per-phase mesh prove of fib-sq 2^20, each to its pinned digest.
With several cards the 2^24 prove runs again over them; with one, a
line says it was not run.

``multiproc``: the sharded prove across processes
(``stark_tpu_torch/dist/multihost.py``): two spawned processes on the
one card under gloo, two logical shards each, after the kernels are
built here.  On each rank K5's query form cut at the query boundary (17
launches, 16 all-reduces through pinned host memory) on the fib-sq 2^24
mesh plan with seeded sources against its plain version, exact, timed
beside the one-launch sharded form over every entry and beside its
all-reduces alone, and the four-step NTT at 2^26 across the processes
against K2's transform, timed; then fib-sq 2^24
over the global mesh of four through ``multihost_prove``: the pinned
single-device digest on both ranks, verified and tamper-rejected on
each, agreement checked, K1/K2, K3, K4, the K5 chain and the cut query
form launched on each rank, the bytes that crossed processes summed
over the ranks equal to ``dist.comm``'s model, cold and warm walls and
each rank's phases' peaks.  With two or more cards the prove runs again
under NCCL, one rank a card; with one, a probe of two NCCL ranks on the
card prints what NCCL answers.  ``--phase multiproc`` runs only the
build, the latency probe and this phase.

``mega`` (after the golden vectors, which take the mega path too): the
single-dispatch prove (``stark/prover.py`` ``_prove_mega``), whose
region after the LDE is one CUDA graph captured once and replayed.
fib-sq ``ProverConfig()`` (M = 2^13, the JAX package's default prove),
fib-sq, MiMC³ and FibMul at 2^18 rows and tribmul at 2^16 (blowup 4, M
up to 2^20, the gate's edge), each through ``prove(cfg)`` alone: the
"mega" path, one capture (the region's wrappers called three times in
the capturing prove: two eager runs, the second under
``torch.cuda.set_sync_debug_mode("error")``, and the capture) and a
replay (no region wrapper called; ``prover.MEGA_STATS`` counts it), the
transcript equal to the ``STARK_TPU_TORCH_NO_MEGA`` prove's, verified,
a flipped byte rejected; warm walls of both paths in turns
(MEGA_TURNS each), the first prove's wall and the graph's pool, and
for MEGA_PROFILED the device busy share, the kernels of one replay and
the host launch calls of each path.  Then two statements through one
graph, a continued channel (its own graph), and, recorded only,
FibMul-GL 2^16 under ``STARK_TPU_TORCH_WIDE_MEGA`` and fib-sq 2^20 (M =
2^22) under ``STARK_TPU_TORCH_MEGA_MAX``.  ``--phase mega`` runs only
the build, the golden vectors and this phase.

``api`` (after the proves above): the rest of the public API on the
card.  ``ntt.lde`` of seeded values at 2^20 -> 2^22 (K1) and 2^24 ->
2^26 (K2) against its plain version (the kernels' plain passes around
the same scale and pad), exact, two launches of its route each, timed;
``CosetFri`` at 2^26 points and its next domain against the host's
powers; ``Fp.inv`` over 2^20 values against ``Fp.pow(x, p - 2)``; the
fib-sq 2^24 prove under ``STARK_TPU_TORCH_DEBUG=1`` (the pinned digest,
verified, tamper-rejected, launches as a plain prove's), its warm walls
with the flag off and on in turns, and a 2^20 trace holding p refused
("non-canonical"); ``utils.profile_trace`` around a warm 2^24 prove,
whose Chrome trace must name the six kernels of K1-K5; the native host
hash against hashlib (``sha256``, ``channel_absorb``, the root of
``merkle_build_host`` at 2^16 against the port's tree), with the 2^24
proof's host replay and ``verify`` timed through each.  ``--phase api``
runs only the build and this phase.

``--profile`` then adds where a warm prove spends its time, for the
Fibonacci-square proves at 2^20 and 2^24 rows, MiMC³ at 2^20, FibMul at
2^24, FibMul-GL and tribmul at 2^20: a phase split synced after each phase (and
the cold build of the AIR's context, which a warm prove takes from its
cache), five warm walls, and one prove under ``torch.profiler`` (device
busy time, the kernels' shares; the full tables go to
``chiprun_out/profile_prove_*.txt``), and the mesh prove's warm phase
split.

Needs one CUDA device; exits non-zero without one.  Imports nothing of
JAX.  The last line of standard output is the result object.  Leaves no
process behind: it is the child subreaper of what it starts, and on the
way out, after a failure too, ``stop_children`` closes the
multiprocessing resource tracker and stops and reaps every process still
below it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

P = 3 * 2**30 + 1
SEED = 20261016
REPS = 5
# the NTT kernels (K1 route n <= 2^22, K2 route above): each path's trace
# INTT and LDE, 2^23, small sizes and GF(97), 2^27 (the last split with
# 8-column groups) and 2^28 (the first with narrower ones); then the
# narrow branches again at small sizes under a shrunk block budget
NTT_K1_LOGS = (1, 2, 9, 20, 22)
NTT_K2_LOGS = (23, 24, 26, 27, 28)
NTT_GF97_LOGS = (1, 3, 5)
NTT_REDUCED = ((8, 13), (8, 14), (8, 16))  # (BLOCK_LOG, log n)
# K3/K4: equality over a 2^22-point LDE's tree; times at the 2^24 path's
# 2^26 leaves and 2^25 nodes (plain versions in 2^22-lane slices: their
# int64 message schedule of 2^26 lanes would need ~32 GiB)
TREE_LOG = 22
TREE_TIME_LOG = 26
# the tree build's split (merkle/tree.py) against the plain tree: 2^22
# leaves in every form at these prune depths (past the 5 fused levels at
# 6); the tail alone at 2^0 .. 2^TAIL_TOP leaves and nodes
SPLIT_LOG, SPLIT_PRUNES, TAIL_TOP = 22, range(7), 10
# the proves: (configuration, AIR name, the AIR's arguments); None is the
# default Fibonacci-square statement
_CFG20 = dict(log2_trace=20, blowup=4, num_queries=16)
_CFG24 = dict(log2_trace=24, blowup=4, num_queries=16)
GOLDILOCKS = 2**64 - 2**32 + 1
_GL = dict(modulus=GOLDILOCKS, generator=7)
_FIBMUL = dict(a0=1, b0=2718281)
PROVES = {"2^20": (_CFG20, None, {}), "2^24": (_CFG24, None, {}),
          "2^25": (dict(_CFG24, log2_trace=25), None, {}),
          "2^26": (dict(_CFG24, log2_trace=26), None, {}),
          "FibMul-GL 2^22": (dict(_CFG20, log2_trace=22, **_GL), "fibmul",
                             _FIBMUL),
          "FibMul-GL 2^24": (dict(_CFG24, **_GL), "fibmul", _FIBMUL),
          "MiMC 2^20": (_CFG20, "mimc3", dict(x0=271828, k=777)),
          "FibMul 2^20": (_CFG20, "fibmul", _FIBMUL),
          "FibMul 2^24": (_CFG24, "fibmul", _FIBMUL),
          "GL 2^20": (dict(_CFG20, **_GL), None, {}),
          "FibMul-GL 2^20": (dict(_CFG20, **_GL), "fibmul", _FIBMUL)}
# the declarative families (stark_tpu_torch/stark/families.py), proved with
# their default witnesses through families.build_air: (configuration,
# family name, unused); mimc5's degree 5 needs blowup 8 (LDE 2^23, the K2
# route)
FAMILY_PROVES = ("tribmul 2^20", "mimc5 2^20", "mimc5rc 2^20",
                 "tribmul-GL 2^20")
PROVES.update({"tribmul 2^20": (_CFG20, "tribmul", {}),
               "mimc5 2^20": (dict(_CFG20, blowup=8), "mimc5", {}),
               "mimc5rc 2^20": (dict(_CFG20, blowup=8), "mimc5rc", {}),
               "tribmul-GL 2^20": (dict(_CFG20, **_GL), "tribmul", {})})
# the large-trace path (pruned trees, chunked from 2^27 leaves): the
# proves that a second prove with pruning off must equal, transcript for
# transcript (True: with warm walls too), and those whose walls and
# phases' peak memory the large-trace table line collects
UNPRUNED_TOO = {"2^24": True, "2^25": False, "2^26": False,
                "FibMul-GL 2^22": False}
LARGE = ("2^24", "2^25", "2^26", "FibMul-GL 2^22", "FibMul-GL 2^24")
# warm walls of the 2^24 prove, pruned and unpruned in turns (this many
# each), for the spread the keep-log is judged by
WARM_TURNS = 3
# the chunked build against the one-pass pruned build at 2^27 leaves
CHUNKED_LOG = 27
# K5's query form on pruned plans (the in-launch recompute of the unstored
# siblings): (prove whose plan it is, in the kernels line)
PRUNED_PLANS = {"2^26 plan (trace prune 6)": ("2^26", True),
                "FibMul-GL 2^22 plan (64-bit, prune 2)":
                    ("FibMul-GL 2^22", False)}
# the daemon's compressed prove
SERVE_COMPRESSED = "mimc5 2^20"
PROFILED = ("2^20", "2^24", "2^26", "MiMC 2^20", "FibMul 2^24",
            "FibMul-GL 2^20",
            "tribmul 2^20")
# the Goldilocks memory table: FibMul-GL cold and warm walls and peak
# device memory at these trace sizes (2^20 is the prove above)
GL_MEMORY_LOGS = (14, 18)
# SHA-256 transcript digests of Goldilocks proves (blowup 4, 16 queries)
# made by the JAX package on a CPU (scripts/jax_anchor_digests.py): the
# port's proves of the same statements on the card must equal them
GL_ANCHORS = {
    ("fib-sq-GL", 8):
        "6a2c0ba1c58151f36dfb9f5302c2bf4056ae1725147cfa1035ced70d9c4eb8e5",
    ("FibMul-GL", 8):
        "a52ed63e759e1100d6a1799868f1b80751e566d2614a305206ed7dd523c0b339",
    ("fib-sq-GL", 12):
        "a323f01017905e71b3c6abd20fcbe6f8cb09effca2f207ee2437491a9704bb62",
    ("FibMul-GL", 12):
        "b952943b2ea26d13b0fd1dde1c10a624cb127ba30b4ed04b3e42b9f68e89e512"}
# SHA-256 transcript digests of the families' proves (default witnesses,
# 16 queries, blowup 4; 8 for the mimc5 families) made by the JAX package
# on a CPU (scripts/jax_anchor_digests.py --families 8): "-GL" names the
# Goldilocks field
FAMILY_ANCHORS = {
    ("tribmul", 8):
        "3a2c41b6434f1a713e21d66bdf4c6e5ea2801c16a1758e9a4642184805ed033b",
    ("mimc5", 8):
        "d0cc06bd4875cc2b8356267155692c7b10699f208d2e89f42f994336b6f7ea25",
    ("mimc5rc", 8):
        "b7db133397b074e5731b00f5d2ba50d4d42b1e5ec92079cb89628a4068e6dbaa",
    ("tribmul-GL", 8):
        "3367ea62a747e25d0834795ce28a597b4b70cd9c9394eab58c9d55aae3ee971b",
    ("mimc5-GL", 8):
        "9e23e7fc2a5717edc97123dcc7b039fe0a415ee18b2df1c161b7e3d6ccda9e5f",
    ("mimc5rc-GL", 8):
        "64059236980cd5bd6aa1a831312b0e0d7af9685cb90c475384d419be11f9c8ef"}
# SHA-256 of each prove's transcript (its messages concatenated): the
# fib-sq ones are those of the port before the multi-column machinery
# (commit 1ea9dbe), which the proves must keep byte for byte; the others
# pin the MiMC³ / FibMul, Goldilocks and family transcripts of the port
# that added them (the Goldilocks ones beside GL_ANCHORS and the families
# beside FAMILY_ANCHORS, which tie them to the JAX package at 2^8 and
# 2^12 rows); fib-sq 2^25 / 2^26 and FibMul-GL 2^22 / 2^24 are the first
# pruned proves' (the CPU tests tie pruned proves to the JAX package's, and
# the unpruned proves here to the pruned ones)
TRANSCRIPT_SHA256 = {
    "2^20": "c6eccf09e57fe3ac5b23b41b67a0415d88edec9305b7f59804eac2940e37c2b8",
    "2^24": "d513cf301e6e8c7e2d25c012b971a8f0d84944015ad71f73b9e7a3d3668f7367",
    "MiMC 2^20":
        "05510f2e30c1f7d4e9838c1581361b6641b51a70d13a00ff98075cac64644e0e",
    "FibMul 2^20":
        "397713f4c901e5f2b914d89eb22b400113dfa0c3c3b236c57a685576957ae9a6",
    "FibMul 2^24":
        "c7940dca9a4643a69c4ebe524db4b17f13e54653a6e681c23c3e427573457cb7",
    "GL 2^20":
        "1457c7cb962b4dea89e0493cdf81b382b4b0a07d9fdd9663e457f48ba33aef7e",
    "FibMul-GL 2^20":
        "5f29c58dad47b69912921082679883e05b119e97aa50be84c03481dd2b21f1b0",
    "tribmul 2^20":
        "42105bfc89172dac1855f6468df6bda44cd03fd351421b7ba1ede1a2fedd7e34",
    "mimc5 2^20":
        "a4c1c713796f12294bd444846992d1d3863d85ed3c6f57f536c3f92ba3816a4d",
    "mimc5rc 2^20":
        "1c5c0a20a28dcff0a8ad87dff9c98abacc18039927e47ed17adcf332c515048c",
    "tribmul-GL 2^20":
        "07e9aabf756d07fac56c4e5ddf0e6d45e29e72d070e6d0ea1abba800a61e05b5",
    "2^25": "39a6119e162c3451ac85e7623d3f1c6f7b8f58bf2b05043f8271ede4fb6d77cf",
    "2^26": "8fe63793c22a5b7ff45f93ac5025da8d79e173dd1e5de1c43fdf9634b1dc60a4",
    "FibMul-GL 2^22":
        "3b274489078fa81684fb113fc36cf89d22e62fa43fb12e73ab65eee24d73061d",
    "FibMul-GL 2^24":
        "c0dc576838008a76ab0e94eaab013138fb62997249db7de0e2d4b761ad810905"}
# the sharded prove over a mesh (stark_tpu_torch/dist): MESH_SHARDS logical
# shards on the one card; the four-step NTT and the sharded tree at
# 2^MESH_LOG points against the single-device K2 NTT and tree; K5's
# sharded query form on the MESH_PROVE mesh plan; the MESH_PROVE prove
# (its pinned single-device digest, launches counted), then MESH_OTHER
# on MESH_OTHER_SHARDS shards and one per-phase mesh prove of
# MESH_PER_PHASE
MESH_SHARDS = 4
MESH_LOG = 26
MESH_PROVE = "2^24"
MESH_OTHER = ("FibMul 2^20", "GL 2^20")
MESH_OTHER_SHARDS = 2
MESH_PER_PHASE = "2^20"
MESH_PATHS = 16  # authentication paths compared
MESH_WARM = 3
# the sharded prove across processes (stark_tpu_torch/dist/multihost.py):
# MULTIPROC_RANKS processes on the one card under gloo, MULTIPROC_SHARDS
# logical shards each (a global mesh of MESH_SHARDS), proving MESH_PROVE;
# K5's cut query form on that mesh plan against its plain version and
# the one-launch sharded form; each child's result within this many
# seconds; the NCCL probe of two ranks on one card within its own
MULTIPROC_RANKS, MULTIPROC_SHARDS = 2, 2
MULTIPROC_TIMEOUT, NCCL_PROBE_TIMEOUT = 600, 120
# the prove whose launch counts fill each row of the kernels line (rows
# not named here: the 2^24 Fibonacci-square prove)
ROW_PATH = {"K1": "2^20", "K1 batched": "FibMul 2^20",
            "NTT 64-bit": "GL 2^20", "NTT 64-bit batched": "FibMul-GL 2^22",
            "K2 batched": "FibMul 2^24", "K3 row form": "FibMul 2^24",
            "K5 row messages": "FibMul 2^24", "K3 wide": "GL 2^20",
            "K3 wide row form": "FibMul-GL 2^20",
            "K5 pruned recompute": "2^26"}
PATH = "2^24"
# the NTT shapes timed: each path's trace INTT (inverse) and LDE (forward);
# the LDE's time fills the route's row of the kernels line
NTT_TIMED = {}
for _kw in (_CFG20, _CFG24):
    _log = _kw["log2_trace"]
    NTT_TIMED[(_log, True)] = False
    NTT_TIMED[(_log + _kw["blowup"].bit_length() - 1, False)] = True
# the batched NTT: FibMul's two columns on both routes, at its paths'
# shapes (timed), and under a shrunk block budget (narrow column groups)
NTT_COLS = 2
NTT_BATCHED_REDUCED = ((8, 13), (8, 16))
# tribmul's three columns at its 2^20 prove's shapes: (log n, inverse)
NTT_FAMILY_COLS, NTT_FAMILY_SHAPES = 3, ((20, True), (22, False))
# the 64-bit (Goldilocks) NTT kernels against ntt_limbs and their own
# passes, (columns, log n, inverse): every Goldilocks prove's trace INTT
# and LDE, the benchmark's FibMul-GL at 2^21 rows and blowup 8 first, then
# the proves here at blowup 4 (fib-sq-GL 2^20 one column, FibMul-GL 2^20,
# 2^22, 2^24, tribmul-GL 2^20); timed (True: in the kernels line) at the
# benchmark's shapes, one column and two; then narrow splits under a
# shrunk block budget, (BLOCK_LOG, columns, log n)
NTT64_SHAPES = ((2, 21, True), (2, 24, False), (1, 21, True), (1, 24, False),
                (1, 20, True), (1, 22, False), (2, 20, True), (2, 22, False),
                (2, 22, True), (2, 24, True), (2, 26, False), (3, 20, True),
                (3, 22, False))
NTT64_TIMED = {(1, 24, False): True, (1, 21, True): False,
               (2, 24, False): True, (2, 21, True): False}
NTT64_REDUCED = ((8, 1, 14), (8, 2, 15), (8, 2, 16))
# K3's row form at tribmul's trace tree: C = 3 over 2^22 rows, both modes
ROW_FAMILY = (3, 22)
# K3's row form: every column count at 2^20 rows, FibMul's 2^26-row tree
ROW_LEAVES_LOG, ROW_LEAVES_TIME = 20, (2, 26)
# K5's query form on row messages: the FibMul 2^24 prove's plan (C = 2,
# in the kernels line), a 6-column plan at 2^20 rows (one full hex block
# before the tail) and the FibMul-GL 2^20 prove's plan (two value slots a
# 64-bit value): (prove, columns or None for the prove's own)
QUERY_ROW_PLANS = {"FibMul 2^24 plan (C = 2)": ("FibMul 2^24", None),
                   "6-column 2^20 plan": ("FibMul 2^20", 6),
                   "FibMul-GL 2^20 plan (C = 2, 64-bit values)":
                       ("FibMul-GL 2^20", None),
                   "tribmul 2^20 plan (C = 3)": ("tribmul 2^20", None),
                   "tribmul-GL 2^20 plan (C = 3, 64-bit values)":
                       ("tribmul-GL 2^20", None)}
QUERY_ROW_PLAN_IN_ROW = "FibMul 2^24 plan (C = 2)"
# K3's 64-bit mode: one column at the Goldilocks 2^20 paths' 2^22 leaves
# (in the kernels line) and at 2^26; the row form at every column count
# over 2^20 rows and FibMul-GL's two columns over 2^22 rows (in the line)
WIDE_LEAVES_LOGS = (22, 26)
WIDE_ROW_LOG, WIDE_ROW_TIME = 20, (2, 22)
# the launches of 0.1-0.7 ms among them (one column at 2^22, the row form
# at 2^20) read 1.96x and 4.06x of their bound in two calls: their median
# of this many runs
SMALL_REPS = 25

# the bound's rates: HBM3 of the H100 SXM (its datasheet's rate) and a
# 32-bit integer peak derived as SMs x 128 x max SM clock: each SM's four
# schedulers issue one 32-lane instruction a clock.  (SMs x 64 INT32 lanes
# x clock is no least time: K3 and K4 ran at or past it on the card.)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_SM_CLOCK = 128
# operation counts (32-bit, with Hopper's 3-input add and logic ops):
# a Montgomery product 6 (4 multiplies, one 3-input add, one conditional
# subtract), an add or subtract mod p 2, so a butterfly 10; per element
# to_mont and the twiddle-table product 6 each, from_mont 4, n^-1 6
MONT_OPS, ADDSUB_OPS, FROM_MONT_OPS = 6, 2, 4
# a Goldilocks product: four 32 x 32 products with their carries and the
# reduction (2^64 = 2^32 - 1, 2^96 = -1 mod p) 22; an add or subtract 6
GL_MUL_OPS, GL_ADDSUB_OPS = 22, 6
# a SHA-256 compression: 64 rounds of 14 (two Sigma of 3 rotates + one
# xor3, Ch and Maj one logic op each, 4 adds with K+W folded), 48
# schedule words of 10, 8 final adds; a node's padding block has a
# constant schedule
SHA_ROUND_OPS, SHA_SCHED_OPS = 14, 10
SHA_OPS = 64 * SHA_ROUND_OPS + 48 * SHA_SCHED_OPS + 8
SHA_PAD_OPS = 64 * SHA_ROUND_OPS + 8


def sha_leaf_ops(c: int, wide: bool) -> int:
    """The operations of one leaf of sha_leaves<c, wide> once the compiler
    has folded its constant message words (the u32 mode's zero high
    words, the zeros past the values, the padding word, the bit length):
    SHA_OPS's count with every Sigma, sigma, Ch, Maj and add of constant
    inputs left out, an add of n data-dependent terms and a constant that
    is not zero costing n // 2 3-input adds.  A leaf has at most 12 data
    words, so each form counts below SHA_OPS (scripts/sass_round_count.py
    holds the count against the compiled code)."""
    from stark_tpu_torch.hash.sha256 import H0, K

    data, mask = None, 0xFFFFFFFF  # a word that depends on the leaf

    def rotr(x, n):
        return (x >> n | x << 32 - n) & mask

    def op(cost, f, *args):
        if any(a is data for a in args):
            return data, cost
        return f(*args) & mask, 0

    def add(*terms):
        n = sum(t is data for t in terms)
        k = sum(t for t in terms if t is not data) & mask
        return (k, 0) if n == 0 else (data, (n + (k != 0)) // 2)

    def big_sigma(*r):
        return lambda x: rotr(x, r[0]) ^ rotr(x, r[1]) ^ rotr(x, r[2])

    def small_sigma(r1, r2, s):
        return lambda x: rotr(x, r1) ^ rotr(x, r2) ^ x >> s

    w = [0] * 16
    for k in range(c):
        if wide:
            w[2 * k] = data
        w[2 * k + 1] = data
    w[2 * c], w[15] = 0x80000000, 64 * c
    ops = 0
    for t in range(16, 64):
        s1, o1 = op(4, small_sigma(17, 19, 10), w[t - 2])
        s0, o2 = op(4, small_sigma(7, 18, 3), w[t - 15])
        word, o3 = add(s1, w[t - 7], s0, w[t - 16])
        w.append(word)
        ops += o1 + o2 + o3
    a, b, cc, d, e, f, g, h = H0
    for t in range(64):
        s1, o1 = op(4, big_sigma(6, 11, 25), e)
        ch, o2 = op(1, lambda x, y, z: x & y ^ ~x & z, e, f, g)
        t1, o3 = add(h, s1, ch, K[t], w[t])
        s0, o4 = op(4, big_sigma(2, 13, 22), a)
        maj, o5 = op(1, lambda x, y, z: x & y ^ x & z ^ y & z, a, b, cc)
        new_a, o6 = add(t1, s0, maj)
        new_e, o7 = add(d, t1)
        ops += o1 + o2 + o3 + o4 + o5 + o6 + o7
        a, b, cc, d, e, f, g, h = new_a, a, b, cc, new_e, e, f, g
    return ops + sum(add(x, iv)[1] for x, iv in zip(
        (a, b, cc, d, e, f, g, h), H0))
# K5's latency bound: per round the new e is at least 3 dependent
# operations after the last (a funnel shift and the xor3 of Sigma1, then
# one 3-input add of Sigma1, Ch and d + h + K + W, which is formed rounds
# ahead), at an assumed 4 cycles each (the dependent-issue latency of an
# integer op on recent NVIDIA SMs) or at what the probe measures; the
# earlier count of 4 operations (T1, then d + T1) is printed beside it
CHAIN_DEP_OPS, DEP_CYCLES, OLD_CHAIN_DEP_OPS = 3, 4, 4
# the probe: steps per timed loop and loops, per mode of stark_dep_latency
# (0 SHF, 1 LOP3, 2 SHF -> LOP3 -> add, 3 and 4 independent SHF / LOP3)
PROBE_STEPS, PROBE_ITERS = 64, 4096
PROBE_MODES = {0: ("shf (dependent)", 1), 1: ("lop3 xor3 (dependent)", 1),
               2: ("shf -> lop3 -> add (dependent)", 3),
               3: ("shf (8 independent chains)", 1),
               4: ("lop3 xor3 (8 independent chains)", 1)}
# the long mixed-flag stream of the chain form: ten 512-row chunks; the
# first 4096 of its rows also time a block by kind
LONG_STREAM, ROW_COST_BLOCKS = 5000, 4096
# batch proving (stark/batch.py): (prove whose statement is statement 0,
# batch size); the other statements' secrets come from a seeded
# generator; the first batch's launches fill the batched rows
BATCHES = (("2^20", 16), ("FibMul 2^20", 4), ("GL 2^20", 4))
# the batched kernel forms against their plain loops: B trees of 2^22
# leaves, B chain-form streams of mixed flags, the B = 16 2^20 query plan
BATCH_B, BATCH_TREE_LOG, BATCH_STREAM = 16, 22, 997
# checkpoint / resume: the prove stopped after each phase, resumed
RESUME = "2^24"
# the standalone FRI commit / decommit (BASELINE config #3, bench.py:
# 297-345): a seeded polynomial of degree < 2^18, its LDE to 2^21 points
# at offset 5, 18 folds, 16 queries; commit and decommit walls over runs
FRI_LOG_DEG, FRI_BLOWUP, FRI_OFFSET, FRI_QUERIES, FRI_RUNS = 18, 8, 5, 16, 5

# the api phase: lde of seeded values at 2^20 and 2^24 points (blowup 4,
# offset 3; the K1 and K2 routes, the rows their launches go into), the
# coset domain and the inverses it checks, the debug-flag walls (turns of
# off, on, on, off), the native tree and the replay / verify turns
API_LDE = ((20, "K1"), (24, "K2"))
API_LDE_BLOWUP, API_LDE_OFFSET = 4, 3
API_COSET_LOG, API_INV_LOG = 26, 20
API_DEBUG_TURNS, API_HOST_TURNS = 2, 3
API_NATIVE_TREE_LOG = 16
# the kernels a profiled 2^24 prove's trace must name
API_TRACE_KERNELS = ("ntt_pass1", "ntt_pass2", "sha_subtree", "sha_nodes",
                     "sha_chain", "query_chain")
# the single-dispatch ("mega") prove (stark/prover.py _prove_mega): each
# configuration proved through its captured graph (prove() with no device
# argument) against the multi-launch prove (STARK_TPU_TORCH_NO_MEGA), with
# MEGA_TURNS warm walls of each in turns: (configuration, AIR name, the
# AIR's arguments), None the default statement; ProverConfig() is the JAX
# package's default prove (M = 2^13), the 2^18-row ones sit at the gate's
# edge (M = 2^20)
_MEGA20 = dict(log2_trace=18, blowup=4, num_queries=16)
MEGA_PROVES = {"fib-sq ProverConfig()": ({}, None, {}),
               "fib-sq 2^18": (_MEGA20, None, {}),
               "MiMC 2^18": (_MEGA20, "mimc3", dict(x0=271828, k=777)),
               "FibMul 2^18": (_MEGA20, "fibmul", _FIBMUL),
               "tribmul 2^16": (dict(_MEGA20, log2_trace=16), "tribmul", {})}
# recorded only, no default changed: (configuration, AIR, arguments, the
# environment that lets the prove take the mega path)
MEGA_RECORDED = {
    "FibMul-GL 2^16 (WIDE_MEGA)": (dict(_MEGA20, log2_trace=16, **_GL),
                                   "fibmul", _FIBMUL,
                                   {"STARK_TPU_TORCH_WIDE_MEGA": "1"}),
    "fib-sq 2^20, M = 2^22 (MEGA_MAX = 2^22)": (
        _CFG20, None, {}, {"STARK_TPU_TORCH_MEGA_MAX": str(1 << 22)})}
MEGA_TURNS, MEGA_RECORDED_TURNS = 5, 3
# the proves whose warm mega and multi-launch runs are profiled (device
# busy share, kernels and host launch calls)
MEGA_PROFILED = ("fib-sq ProverConfig()", "fib-sq 2^18", "FibMul 2^18")
# the kernel rows a prove's LDE launches (outside the mega region) and
# those of the region (whose wrappers a replay does not call)
LDE_ROWS = ("K1", "K2", "K1 batched", "K2 batched", "NTT 64-bit",
            "NTT 64-bit batched")
REGION_ROWS = ("K3", "K3 row form", "K3 wide", "K3 wide row form", "K4",
               "K4 tail", "K5 row messages", "K5 pruned recompute")

def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS, warm: bool = True) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up
    unless `warm` is false)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, pattern: str, reps: int = REPS) -> dict:
    """Device ms per call of each kernel whose name matches `pattern`
    (torch.profiler over `reps` calls of fn, after a warm-up)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m:
            out[m.group(0)] = e.self_device_time_total / reps / 1e3
    return out


def timed_plain(fn):
    """(fn(), its ms under CUDA events): a plain version's one run, whose
    result a check compares and whose time a timing reports."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the uint32 values the int32 tensors hold."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def rand_u32(rs, shape, bound, device) -> torch.Tensor:
    vals = rs.randint(0, bound, size=shape, dtype=np.int64)
    return torch.from_numpy(vals.astype(np.uint32).view(np.int32)).to(device)


def rand_u32_dev(gen, shape, bound, device) -> torch.Tensor:
    """Seeded random words made on the card (the 2^26-lane inputs)."""
    vals = torch.randint(0, bound, shape, generator=gen, device=device,
                         dtype=torch.int64)
    return vals.to(torch.int32)


def rand_gl_dev(gen, shape, device) -> torch.Tensor:
    """Seeded canonical Goldilocks values made on the card as limb planes
    ((2, n) or (C, 2, n), the high words' plane first), p - 1, 2^32 - 1
    and 2^32 first in each column."""
    x = rand_words_dev(gen, shape, device)
    hi, lo = x[..., 0, :], x[..., 1, :]
    lo.masked_fill_(hi == -1, 0)  # hi = 2^32 - 1 takes lo = 0: below p
    hi[..., :3] = torch.tensor([-1, 0, 1], dtype=torch.int32, device=device)
    lo[..., :3] = torch.tensor([0, -1, 0], dtype=torch.int32, device=device)
    return x


def rand_words_dev(gen, shape, device) -> torch.Tensor:
    """Seeded random 32-bit words made on the card in place, 2^26 at a
    time (the query form's trees: up to 2^31 words)."""
    out = torch.empty(shape, dtype=torch.int32, device=device)
    flat = out.view(-1)
    for k in range(0, flat.numel(), 1 << 26):
        part = flat[k:k + (1 << 26)]
        part.random_(generator=gen)  # [0, 2^31)
        part.bitwise_xor_(part << 1)  # a random top bit too
    return out


class Card:
    """The card's rates for the bounds, read in this run."""

    def __init__(self):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()[0]
        self.clock_hz = float(smi) * 1e6
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.int32_ops_per_s = (self.sms * INT32_OPS_PER_SM_CLOCK
                                * self.clock_hz)
        # cycles a round's critical path takes, set by phase_latency
        self.round_cycles = None
        log(f"bound rates: {HBM_BYTES_PER_S:.3e} B/s; derived int32 peak "
            f"{self.int32_ops_per_s:.4e} op/s ({self.sms} SMs x "
            f"{INT32_OPS_PER_SM_CLOCK} x {self.clock_hz / 1e6:.0f} MHz)")

    def bound(self, nbytes: float, ops: float) -> tuple[float, str]:
        """(least ms, "bytes" or "operations") for this work."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.int32_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def ntt_bound(self, n: int, inverse: bool):
        """An NTT of n canonical words: n read, n written; n/2 log2(n)
        butterflies plus the per-element Montgomery products."""
        log_n = n.bit_length() - 1
        butterfly = MONT_OPS + 2 * ADDSUB_OPS
        ops = (butterfly * (n // 2) * log_n
               + n * (2 * MONT_OPS + FROM_MONT_OPS + MONT_OPS * inverse))
        return self.bound(8 * n, ops)

    def ntt64_bound(self, n: int, cols: int, inverse: bool):
        """The 64-bit NTT of `cols` columns of n values: 32 bytes a value
        (x read, the intermediate written and read, X written); a column
        (n/2) log2(n) butterflies (a product, an add, a subtract), two
        products a value for pass 1's twiddle, one for the INTT's n^-1."""
        log_n = n.bit_length() - 1
        ops = cols * ((n // 2) * log_n * (GL_MUL_OPS + 2 * GL_ADDSUB_OPS)
                      + n * GL_MUL_OPS * (2 + inverse))
        return self.bound(32 * cols * n, ops)

    def chain_bound(self, blocks: int, round_cycles=None):
        """K5's latency bound: `blocks` compressions of 64 dependent
        rounds, one after another, each `round_cycles` long (default: the
        measured critical path of a round)."""
        cycles = blocks * 64 * (round_cycles or self.round_cycles)
        return cycles / self.clock_hz * 1e3, "operations"

    def query_bound(self, tb):
        """The query form's latency bound: the chain's blocks, and per
        query the recompute's critical path when the plan prunes (a leaf
        compression, then two a level up to the deepest kept level, all
        blocks' nodes of a level in parallel), each a compression of 64
        rounds at the measured round latency.  (blocks, compressions)."""
        blocks = tb.num_queries * int(tb.template.shape[0])
        extra = tb.num_queries * (2 * tb.max_prune - 1) * (tb.max_prune > 0)
        return blocks, blocks + extra

    def chain_bounds_text(self, blocks: int, ms: float) -> str:
        """The kernel time against the measured and the assumed bounds."""
        out = []
        for what, rc in (("measured", self.round_cycles),
                         ("assumed 3 x 4 cycles", CHAIN_DEP_OPS * DEP_CYCLES),
                         ("earlier 4 x 4 cycles",
                          OLD_CHAIN_DEP_OPS * DEP_CYCLES)):
            b = self.chain_bound(blocks, rc)[0]
            out.append(f"{what} {b:.4f} ms (x{ms / b:.2f})")
        return (f"{blocks} blocks, {ms / blocks * 1e6:.1f} ns a block; "
                f"latency bound " + ", ".join(out))


class Results:
    """Per-kernel comparison records for the kernels line."""

    def __init__(self, card: Card):
        self.card = card
        self.rows: dict[str, dict] = {}

    def add(self, name: str, source: str, replaces: str) -> None:
        self.rows[name] = {
            "name": name, "route": "cuda", "source": source,
            # None until a main path counts it / a check compares it
            "replaces": replaces, "launches": None, "max_abs_err": None,
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
            # no PyTorch call computes an NTT over GF(p) or SHA-256
            "library_ms": None, "shape": None, "launches_by_prove": {}}

    def check(self, kernel: str, what: str, got, want) -> None:
        err = max_abs_err(got, want)
        log(f"{kernel} {what}: max_abs_err {err} (tolerance 0)")
        if err != 0:
            raise AssertionError(f"{kernel} {what}: kernel != plain version")
        row = self.rows[kernel]
        row["max_abs_err"] = max(row["max_abs_err"] or 0, err)

    def time(self, kernel: str, shape: str, kernel_fn, plain_fn, bound,
             row: bool = True, plain_reps: int = REPS,
             other: bool = False, reps: int = REPS) -> dict:
        """Time kernel_fn (median of `reps`) and plain_fn (same inputs)
        and log them beside `bound` (ms, by); `row` puts them in the
        kernels line, `other` under the row's "shapes".  With `plain_reps`
        below REPS the plain version, already run by its check, is timed
        that many times without a warm-up; a number for plain_fn is its
        time taken already (timed_plain around the check's run)."""
        ms = cuda_ms(kernel_fn, reps)
        pms = (plain_fn if isinstance(plain_fn, float)
               else cuda_ms(plain_fn, plain_reps, warm=plain_reps == REPS))
        log(f"{kernel} {shape}: kernel {ms:.4f} ms (median of {reps}), "
            f"plain {pms:.4f} ms, "
            f"bound {bound[0]:.4f} ms ({bound[1]}); kernel / bound "
            f"{ms / bound[0]:.2f}")
        got = dict(ms=ms, plain_ms=pms, bound_ms=bound[0], bound_by=bound[1],
                   shape=shape)
        if row:
            self.rows[kernel].update(got)
        if other:
            self.rows[kernel].setdefault("shapes", {})[shape] = got
        return got


def card_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card_smi())
    return name


def phase_build() -> None:
    from stark_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(os.path.basename(p) for p in paths.values())})")


def phase_ntt(res: Results, dev) -> None:
    """The NTT kernels against both plain versions (their own passes and
    the Stockham dataflow), exact, through the K1 and K2 routes; times at
    the paths' shapes."""
    from stark_tpu_torch.ntt import cuda_ntt
    from stark_tpu_torch.ntt.cuda_ntt import (ntt_k1, ntt_k2,
                                              ntt_passes_plain, ntt_plain)

    rs = np.random.RandomState(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = ([(P, k) for k in NTT_K1_LOGS + NTT_K2_LOGS]
             + [(97, k) for k in NTT_GF97_LOGS])
    for p, log_n in cases:
        n = 1 << log_n
        name, route = ("K1", ntt_k1) if n <= 1 << cuda_ntt.MAX_LOG_N else (
            "K2", ntt_k2)
        x = (rand_u32(rs, n, p, dev) if log_n <= 22
             else rand_u32_dev(gen, (n,), p, dev))
        log1, log2, cols_log = cuda_ntt.split(log_n)
        for inverse in (False, True):
            what = (f"{'intt' if inverse else 'ntt'} n=2^{log_n} GF({p}) "
                    f"(passes 2^{log1} x 2^{log2}, 2^{cols_log} columns)")
            got = route(x, p, inverse)
            res.check(name, f"{what} vs its passes",
                      got, ntt_passes_plain(x, p, inverse))
            res.check(name, f"{what} vs Stockham", got,
                      ntt_plain(x, p, inverse))
            del got
            if p == P and (log_n, inverse) in NTT_TIMED:
                shape = f"{'intt' if inverse else 'ntt'} n=2^{log_n}"
                got = res.time(name, shape, lambda: route(x, P, inverse),
                               lambda: ntt_passes_plain(x, P, inverse),
                               res.card.ntt_bound(n, inverse),
                               row=NTT_TIMED[(log_n, inverse)], other=True)
                got["passes_ms"] = kernel_device_ms(
                    lambda: route(x, P, inverse), r"ntt_pass[12]<\d+>")
                log(f"{name} {shape}: device ms per pass "
                    f"{json.dumps(got['passes_ms'])}")
        del x
        torch.cuda.empty_cache()
    # the batched form: NTT_COLS columns, one launch of each pass, at the
    # FibMul paths' shapes (each column also against Stockham)
    for log_n in sorted({k[0] for k in NTT_TIMED}):
        n = 1 << log_n
        name, route = ("K1", ntt_k1) if n <= 1 << cuda_ntt.MAX_LOG_N else (
            "K2", ntt_k2)
        x = rand_u32_dev(gen, (NTT_COLS, n), P, dev)
        for inverse in (False, True):
            kind = f"{'intt' if inverse else 'ntt'}"
            what = f"{kind} ({NTT_COLS}, 2^{log_n})"
            got = route(x, P, inverse)
            res.check(f"{name} batched", f"{what} vs its passes", got,
                      ntt_passes_plain(x, P, inverse))
            for c in range(NTT_COLS):
                res.check(f"{name} batched", f"{what} column {c} vs "
                          "Stockham", got[c], ntt_plain(x[c], P, inverse))
            del got
            if (log_n, inverse) in NTT_TIMED:
                b = res.card.ntt_bound(n, inverse)
                got = res.time(f"{name} batched", what,
                               lambda: route(x, P, inverse),
                               lambda: ntt_passes_plain(x, P, inverse),
                               (NTT_COLS * b[0], b[1]),
                               row=NTT_TIMED[(log_n, inverse)], other=True)
                got["passes_ms"] = kernel_device_ms(
                    lambda: route(x, P, inverse), r"ntt_pass[12]<\d+>")
                log(f"{name} batched {what}: device ms per pass "
                    f"{json.dumps(got['passes_ms'])}")
        del x
        torch.cuda.empty_cache()
    # tribmul's three columns (one launch of each pass), each column also
    # against Stockham
    for log_n, inverse in NTT_FAMILY_SHAPES:
        x = rand_u32_dev(gen, (NTT_FAMILY_COLS, 1 << log_n), P, dev)
        what = (f"{'intt' if inverse else 'ntt'} ({NTT_FAMILY_COLS}, "
                f"2^{log_n})")
        got = ntt_k1(x, P, inverse)
        res.check("K1 batched", f"{what} vs its passes", got,
                  ntt_passes_plain(x, P, inverse))
        for c in range(NTT_FAMILY_COLS):
            res.check("K1 batched", f"{what} column {c} vs Stockham", got[c],
                      ntt_plain(x[c], P, inverse))
        b = res.card.ntt_bound(1 << log_n, inverse)
        res.time("K1 batched", what, lambda: ntt_k1(x, P, inverse),
                 lambda: ntt_passes_plain(x, P, inverse),
                 (NTT_FAMILY_COLS * b[0], b[1]), row=False, other=True)
        del x, got
    torch.cuda.empty_cache()
    saved = cuda_ntt.BLOCK_LOG
    try:
        for block_log, log_n in NTT_BATCHED_REDUCED:
            cuda_ntt.BLOCK_LOG = block_log
            x = rand_u32(rs, (NTT_COLS, 1 << log_n), P, dev)
            for inverse in (False, True):
                what = (f"{'intt' if inverse else 'ntt'} ({NTT_COLS}, "
                        f"2^{log_n}), block budget 2^{block_log}")
                res.check("K2 batched", f"{what} vs its passes",
                          ntt_k2(x, P, inverse),
                          ntt_passes_plain(x, P, inverse))
        for block_log, log_n in NTT_REDUCED:
            cuda_ntt.BLOCK_LOG = block_log
            x = rand_u32(rs, 1 << log_n, P, dev)
            log1, log2, cols_log = cuda_ntt.split(log_n)
            for inverse in (False, True):
                what = (f"{'intt' if inverse else 'ntt'} n=2^{log_n}, block "
                        f"budget 2^{block_log} (passes 2^{log1} x 2^{log2}, "
                        f"2^{cols_log} columns)")
                got = ntt_k2(x, P, inverse)
                res.check("K2", f"{what} vs its passes", got,
                          ntt_passes_plain(x, P, inverse))
                res.check("K2", f"{what} vs Stockham", got,
                          ntt_plain(x, P, inverse))
    finally:
        cuda_ntt.BLOCK_LOG = saved


def phase_ntt64(res: Results, dev) -> None:
    """The 64-bit NTT kernels against ``ntt_limbs`` (the torch-op
    Stockham, their CPU route) and their own passes (``ntt64.plain``) on
    the card, exact, at NTT64_SHAPES (the references column by column
    above 2^25 values, which bounds their temporaries to ~22 GB) and
    under a shrunk block budget; times at NTT64_TIMED beside ``ntt_limbs``
    and their bound."""
    from stark_tpu_torch.ntt import cuda_ntt64
    from stark_tpu_torch.ntt.cuda_ntt64 import ntt64
    from stark_tpu_torch.ntt.ntt import ntt_limbs

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def check(row, x, inverse, what):
        got = ntt64(x, GOLDILOCKS, inverse)
        cols = int(x.shape[0]) if x.dim() == 3 else 1
        parts = ([(x, got)] if cols * int(x.shape[-1]) <= 1 << 25 else
                 [(x[c], got[c]) for c in range(cols)])
        for xc, gc in parts:
            res.check(row, f"{what} vs ntt_limbs", gc,
                      ntt_limbs(xc, GOLDILOCKS, inverse))
            res.check(row, f"{what} vs its passes", gc,
                      ntt64.plain(xc, GOLDILOCKS, inverse))

    for cols, log_n, inverse in NTT64_SHAPES:
        n = 1 << log_n
        row = "NTT 64-bit" if cols == 1 else "NTT 64-bit batched"
        x = rand_gl_dev(gen, (2, n) if cols == 1 else (cols, 2, n), dev)
        log1, log2, cols_log = cuda_ntt64.split(log_n)
        what = (f"{'intt' if inverse else 'ntt'} {tuple(x.shape)} "
                f"(passes 2^{log1} x 2^{log2}, 2^{cols_log} columns)")
        check(row, x, inverse, what)
        if (cols, log_n, inverse) in NTT64_TIMED:
            got = res.time(row, what, lambda: ntt64(x, GOLDILOCKS, inverse),
                           lambda: ntt_limbs(x, GOLDILOCKS, inverse),
                           res.card.ntt64_bound(n, cols, inverse),
                           row=NTT64_TIMED[(cols, log_n, inverse)],
                           other=True, plain_reps=3)
            got["passes_ms"] = kernel_device_ms(
                lambda: ntt64(x, GOLDILOCKS, inverse), r"ntt64_pass[12]<\d+>")
            log(f"{row} {what}: device ms per pass "
                f"{json.dumps(got['passes_ms'])}")
        del x
        cuda_ntt64._cached_plan.cache_clear()
        torch.cuda.empty_cache()
    saved = cuda_ntt64.BLOCK_LOG
    try:
        for block_log, cols, log_n in NTT64_REDUCED:
            cuda_ntt64.BLOCK_LOG = block_log
            n = 1 << log_n
            row = "NTT 64-bit" if cols == 1 else "NTT 64-bit batched"
            x = rand_gl_dev(gen, (2, n) if cols == 1 else (cols, 2, n), dev)
            log1, log2, cols_log = cuda_ntt64.split(log_n)
            for inverse in (False, True):
                check(row, x, inverse,
                      f"{'intt' if inverse else 'ntt'} {tuple(x.shape)}, "
                      f"block budget 2^{block_log} (passes 2^{log1} x "
                      f"2^{log2}, 2^{cols_log} columns)")
    finally:
        cuda_ntt64.BLOCK_LOG = saved
        cuda_ntt64._cached_plan.cache_clear()


def plain_tree(leaves: torch.Tensor) -> torch.Tensor:
    """The whole (2n - 1, 8) buffer of a power-of-two tree over its leaf
    digests, level by level with the plain pairs (any device)."""
    from stark_tpu_torch.hash.sha256 import sha256_pairs
    from stark_tpu_torch.merkle.tree import level_offsets

    n = int(leaves.shape[0])
    out = torch.empty((2 * n - 1, 8), dtype=torch.int32, device=leaves.device)
    out[:n] = leaves
    offs = level_offsets(n)
    for (oc, sc), (op, sp) in zip(offs, offs[1:]):
        out[op:op + sp] = sha256_pairs(out[oc:oc + sc])
    return out


def subtree_bound(card: "Card", n: int, c: int, wide: bool, levels: int,
                  stored: bool = True):
    """The subtree kernel over n leaves of C columns with `levels` node
    levels: each value read once, each stored digest written once, one
    leaf's folded operations a leaf and a node's (two compressions, the
    second of a constant block) a node."""
    nodes = n - (n >> levels)
    return card.bound((8 if wide else 4) * c * n + 32 * (n + nodes) * stored,
                      sha_leaf_ops(c, wide) * n
                      + (SHA_OPS + SHA_PAD_OPS) * nodes)


def subtree_case(res: Results, row: str, vals, rows: bool, wide: bool,
                 in_line: bool, reps: int = REPS) -> None:
    """The subtree kernel as the tree build launches it (2^SUBTREE_LOG
    leaves a block, SUBTREE_LEVELS node levels, every level written) over
    `vals`, exact against its plain version (in 2^TREE_LOG-leaf slices,
    each a run of whole blocks), and timed beside its bound; `in_line`
    puts the time in the kernels line."""
    from stark_tpu_torch.hash.cuda_sha import level_row, sha_subtree
    from stark_tpu_torch.merkle import tree as mt

    n = int(vals.shape[-1])
    k, s, f = n.bit_length() - 1, mt.SUBTREE_LOG, mt.SUBTREE_LEVELS
    c = int(vals.shape[0]) if rows else 1
    out = torch.empty((level_row(k, 0, f, n >> f), 8), dtype=torch.int32,
                      device=vals.device)
    kw = dict(rows=rows, wide=wide, span_log=s, levels=f, tree_log=k)

    def run():
        return sha_subtree(vals, out, **kw)

    def plain():
        want = torch.empty_like(out)
        sl = min(n, 1 << TREE_LOG)
        for q in range(0, n, sl):
            sha_subtree.plain(vals[..., q:q + sl], want, block0=q >> s, **kw)
        return want

    what = (f"subtree {'C=%d ' % c if rows else ''}n=2^{k}, {f} levels"
            f"{' 64-bit' * wide}")
    want, plain_ms = timed_plain(plain)
    res.check(row, f"{what} (plain in 2^{TREE_LOG}-leaf slices)", run(),
              want)
    del want
    res.time(row, what, run, plain_ms,
             subtree_bound(res.card, n, c, wide, f), row=in_line,
             other=True, reps=reps)


def time_alone(res: Results, row: str, shape: str, fn, bound,
               reps: int = REPS) -> None:
    """Time fn (a kernel whose plain version its check already ran) and
    log it beside `bound` under the row's "shapes"."""
    ms = cuda_ms(fn, reps)
    log(f"{row} {shape}: kernel {ms:.4f} ms (median of {reps}), bound "
        f"{bound[0]:.4f} ms ({bound[1]}); kernel / bound {ms / bound[0]:.2f}")
    res.rows[row].setdefault("shapes", {})[shape] = dict(
        ms=ms, bound_ms=bound[0], bound_by=bound[1])


def phase_tree(res: Results, dev) -> None:
    """K3 and K4: K3 alone, K4 a level and the whole build over a 2^22
    tree; the subtree kernel at the 2^24 path's 2^26 leaves (and K3 alone
    there), K4 at 2^25 nodes; the row form."""
    from stark_tpu_torch.hash.cuda_sha import (sha_leaves, sha_nodes,
                                               sha_row_leaves)
    from stark_tpu_torch.hash.sha256 import (sha256_pairs, sha256_row_leaves,
                                             sha256_u64_leaves)
    from stark_tpu_torch.merkle.tree import build_tree

    rs = np.random.RandomState(SEED + 1)
    n = 1 << TREE_LOG
    vals = rand_u32(rs, n, P, dev)
    res.check("K3", f"leaves n=2^{TREE_LOG} (no node level)",
              sha_leaves(vals), sha256_u64_leaves(vals))
    kids = rand_u32(rs, (n, 8), 1 << 32, dev)
    res.check("K4", f"nodes m=2^{TREE_LOG - 1}", sha_nodes(kids),
              sha256_pairs(kids))
    res.check("K4", f"full tree n=2^{TREE_LOG} (the subtree kernel, K4, "
              "the tail)", build_tree(vals),
              plain_tree(sha256_u64_leaves(vals)))
    del vals, kids

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    big = 1 << TREE_TIME_LOG
    sl = 1 << TREE_LOG

    def sliced(fn, x, per):
        return torch.cat([fn(x[k:k + per]) for k in range(0, len(x), per)])

    vals = rand_u32_dev(gen, (big,), P, dev)
    time_alone(res, "K3", f"leaves n=2^{TREE_TIME_LOG} (no node level)",
               lambda: sha_leaves(vals),
               res.card.bound(36 * big, sha_leaf_ops(1, False) * big))
    subtree_case(res, "K3", vals, False, False, True)
    del vals
    kids = rand_u32_dev(gen, (big, 8), 1 << 32, dev)
    m = big // 2
    want, plain_ms = timed_plain(lambda: sliced(sha256_pairs, kids, sl))
    res.check("K4", f"nodes m=2^{TREE_TIME_LOG - 1} (plain in "
              f"2^{TREE_LOG} slices)", sha_nodes(kids), want)
    del want
    res.time("K4", f"nodes m=2^{TREE_TIME_LOG - 1}", lambda: sha_nodes(kids),
             plain_ms, res.card.bound(96 * m, (SHA_OPS + SHA_PAD_OPS) * m))
    del kids

    # K3's row form: every column count, then FibMul's 2^26-row tree
    for c in range(1, 7):
        cols = rand_u32(rs, (c, 1 << ROW_LEAVES_LOG), P, dev)
        res.check("K3 row form", f"row leaves C={c} n=2^{ROW_LEAVES_LOG}",
                  sha_row_leaves(cols), sha256_row_leaves(cols))
    c, log = ROW_LEAVES_TIME
    cols = rand_u32_dev(gen, (c, 1 << log), P, dev)
    # tribmul's trace tree: C = 3 over 2^22 rows
    fc, flog = ROW_FAMILY
    fcols = rand_u32_dev(gen, (fc, 1 << flog), P, dev)
    subtree_case(res, "K3 row form", fcols, True, False, False)
    del fcols
    subtree_case(res, "K3 row form", cols, True, False, True)
    # the columns read once (4 bytes a value), the digests written once
    time_alone(res, "K3 row form", f"row leaves C={c} n=2^{log} (no node "
               "level)", lambda: sha_row_leaves(cols),
               res.card.bound((4 * c + 32) << log,
                              sha_leaf_ops(c, False) << log))
    del cols


def phase_tree_wide(res: Results, dev) -> None:
    """K3's 64-bit mode (Goldilocks limb planes): K3 alone over one
    column at 2^22 leaves and the row form at C = 1..6 over 2^20 rows,
    exact against its plain version, and timed at 2^22 and 2^26; the
    subtree kernel over one column and over C = 2 and 3 at 2^22 rows,
    exact and timed (the one column and C = 2 in the kernels line).  The
    words are any 32-bit values: the kernel hashes hi || lo whatever they
    are."""
    from stark_tpu_torch.hash.cuda_sha import sha_leaves, sha_row_leaves
    from stark_tpu_torch.hash.sha256 import (sha256_row_leaves,
                                             sha256_u64_leaves)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    sl = 1 << TREE_LOG
    for log_n in WIDE_LEAVES_LOGS:
        n = 1 << log_n
        vals = rand_words_dev(gen, (2, n), dev)

        def plain():
            return torch.cat([sha256_u64_leaves(vals[:, k:k + sl], wide=True)
                              for k in range(0, n, sl)])

        what = f"leaves (2, 2^{log_n})"
        if log_n == TREE_LOG:
            res.check("K3 wide", f"{what} (no node level)",
                      sha_leaves(vals, wide=True), plain())
        # each limb pair read once (8 bytes), each digest written once
        time_alone(res, "K3 wide", f"{what} (no node level)",
                   lambda: sha_leaves(vals, wide=True),
                   res.card.bound(40 * n, sha_leaf_ops(1, True) * n),
                   SMALL_REPS if log_n == TREE_LOG else REPS)
        if log_n == WIDE_LEAVES_LOGS[0]:
            subtree_case(res, "K3 wide", vals, False, True, True,
                         reps=SMALL_REPS)
        del vals
    for c in range(1, 7):
        cols = rand_words_dev(gen, (c, 2, 1 << WIDE_ROW_LOG), dev)
        what = f"row leaves C={c} ({c}, 2, 2^{WIDE_ROW_LOG})"
        res.check("K3 wide row form", what, sha_row_leaves(cols, wide=True),
                  sha256_row_leaves(cols, wide=True))
        time_alone(res, "K3 wide row form", f"{what} (no node level)",
                   lambda: sha_row_leaves(cols, wide=True),
                   res.card.bound((8 * c + 32) << WIDE_ROW_LOG,
                                  sha_leaf_ops(c, True) << WIDE_ROW_LOG),
                   SMALL_REPS)
    c, log_n = ROW_FAMILY  # tribmul-GL's trace tree
    cols = rand_words_dev(gen, (c, 2, 1 << log_n), dev)
    subtree_case(res, "K3 wide row form", cols, True, True, False)
    c, log_n = WIDE_ROW_TIME
    cols = rand_words_dev(gen, (c, 2, 1 << log_n), dev)
    subtree_case(res, "K3 wide row form", cols, True, True, True,
                 reps=SMALL_REPS)
    del cols
    torch.cuda.empty_cache()


def phase_tree_split(res: Results, dev) -> None:
    """The tree build's split on the card (the subtree kernel, K4 a
    level, the tail) against the plain tree, bit for bit: 2^22 leaves in
    both modes, one column and the row form at C = 1..6, every prune
    depth 0..6 (6 passes the fused levels: the scratch and a K4 launch);
    then the tail alone at 2^0 .. 2^10 leaves (the whole tree in one
    launch) and from a level of 2^1 .. 2^10 digest rows, timed at 2^10
    nodes (the kernels line's row) beside K4's 10 launches."""
    from stark_tpu_torch.hash.cuda_sha import sha_nodes, sha_tail
    from stark_tpu_torch.hash.sha256 import (sha256_row_leaves,
                                             sha256_u64_leaves)
    from stark_tpu_torch.merkle.tree import build_tree, level_offsets

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    n = 1 << SPLIT_LOG
    for wide in (False, True):
        for c in range(0, 7):  # 0: one column
            shape = ((c,) if c else ()) + ((2,) if wide else ()) + (n,)
            vals = rand_words_dev(gen, shape, dev)
            row = ("K3" + " wide" * wide + " row form" * (c > 0))
            whole = plain_tree(sha256_row_leaves(vals, wide) if c
                               else sha256_u64_leaves(vals, wide))
            for prune in SPLIT_PRUNES:
                got = build_tree(vals, rows=c > 0, wide=wide, prune=prune)
                res.check(row, f"build_tree {tuple(shape)} prune {prune}",
                          got, whole[2 * n - 2 * (n >> prune):])
            del vals, whole
    torch.cuda.empty_cache()
    rs = np.random.RandomState(SEED + 11)
    for log_n in range(TAIL_TOP + 1):
        m = 1 << log_n
        vals = rand_u32(rs, m, P, dev)
        out = torch.empty((2 * m - 1, 8), dtype=torch.int32, device=dev)
        res.check("K4 tail", f"leaves n=2^{log_n} (the whole tree)",
                  sha_tail(vals, out, leaves=True),
                  plain_tree(sha256_u64_leaves(vals)))
        if m > 1:
            kids = rand_u32(rs, (m, 8), 1 << 32, dev)
            top = torch.empty((m - 1, 8), dtype=torch.int32, device=dev)
            res.check("K4 tail", f"nodes m=2^{log_n}", sha_tail(kids, top),
                      plain_tree(kids)[m:])
    offs = level_offsets(m)

    def levels():
        for (oc, sc), (op, sp) in zip(offs, offs[1:]):
            sha_nodes(buf[oc:oc + sc], out=buf[op:op + sp])

    buf = plain_tree(kids)
    res.time("K4 tail", f"nodes m=2^{TAIL_TOP} to the root",
             lambda: sha_tail(kids, top),
             lambda: sha_tail.plain(kids, top),
             res.card.bound(32 * (2 * m - 1), (SHA_OPS + SHA_PAD_OPS)
                            * (m - 1)), reps=SMALL_REPS)
    log(f"K4 tail: the same {TAIL_TOP} levels as {TAIL_TOP} K4 launches "
        f"{cuda_ms(levels, SMALL_REPS):.4f} ms (device times: the tree "
        "times below)")


def phase_tree_times() -> None:
    """The tree build's measurements of scripts/tree_build_times.py on
    this checkout, in a process of their own (the profiler of a long
    process drops device events): K3 alone, the builds at 2^20 / 2^22 /
    2^26 leaves with each kernel's device time and launches, K4 a launch
    and its host time."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "tree_build_times.py"),
         "--root", root, "--reps", str(REPS)], capture_output=True,
        text=True, timeout=600, check=True).stdout
    for line in out.splitlines():
        row = json.loads(line)
        log(f"tree times {row.pop('kind')}: "
            f"{json.dumps({k: v for k, v in row.items() if k != 'root'})}")


def phase_tree_chunked(res: Results, dev) -> None:
    """The chunked pruned build (K3's subtree form once a chunk of
    2^CHUNK_LOG leaves, writing the chunk's slice of the first stored
    level, then K4 a level and the tail) against the one-pass pruned
    build, both on the card, at 2^27 leaves in three modes: one u32
    column, the C = 2 row form and the 64-bit mode; stored levels equal,
    each build timed."""
    from stark_tpu_torch.merkle import tree as mt

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    n = 1 << CHUNKED_LOG
    prune = mt.prune_depth_for(n)
    chunks = n >> mt.chunk_log(n, prune)
    for row, shape, wide in (("K3", (n,), False),
                             ("K3 row form", (2, n), False),
                             ("K3 wide", (2, n), True)):
        vals = rand_words_dev(gen, shape, dev)
        build = (mt.MerkleTree.from_columns if row == "K3 row form"
                 else mt.MerkleTree)

        def tree():
            return build(vals, wide=wide, prune=prune).buffer

        reset_counts()
        chunked = tree()
        launches = read_counts()
        saved = mt.CHUNK_MIN_LOG
        mt.CHUNK_MIN_LOG = CHUNKED_LOG + 1  # one pass over all the leaves
        try:
            one_pass = tree()
            one_ms = cuda_ms(tree, warm=False)
        finally:
            mt.CHUNK_MIN_LOG = saved
        what = (f"chunked build {shape} (prune {prune}, {chunks} chunks)"
                f"{' 64-bit' * wide}")
        res.check(row, f"{what} vs one-pass pruned build", chunked, one_pass)
        ms = cuda_ms(tree, warm=False)
        log(f"{row} {what}: {ms:.4f} ms; one-pass pruned build "
            f"{one_ms:.4f} ms; launches {launches[row]} K3, "
            f"{launches['K4']} K4")
        t = mt.tree_launches(n, prune)
        want = (t["subtree"], t["nodes"], t["tail"])
        if (launches[row], launches["K4"], launches["K4 tail"]) != want:
            raise AssertionError(f"chunked build launched {launches}, "
                                 f"expected (K3, K4, tail) {want}")
        res.rows[row].setdefault("chunked_build", {})[str(shape)] = dict(
            ms=ms, one_pass_ms=one_ms, k3=launches[row], k4=launches["K4"])
        del vals, chunked, one_pass
        torch.cuda.empty_cache()


def phase_latency(card: Card, dev) -> None:
    """The dependent-issue latency of 32-bit integer operations on this
    card (a clock64 loop over dependent SHF / LOP3 / add chains), and
    from it the critical path of a SHA-256 round that K5's bound uses."""
    from stark_tpu_torch import _build

    lib = _build.lib("sha_chain")
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    per_op = {}
    for mode, (what, ops) in PROBE_MODES.items():
        for _ in range(2):  # the first run loads the code
            _build.check(lib.stark_dep_latency(
                out.data_ptr(), mode, PROBE_ITERS, _build.stream_ptr(dev)),
                "the latency probe")
            torch.cuda.synchronize()
        cycles = int(out[0])
        per_op[mode] = cycles / (PROBE_ITERS * PROBE_STEPS * ops)
        log(f"latency probe {what}: {cycles} cycles for "
            f"{PROBE_ITERS * PROBE_STEPS * ops} operations, "
            f"{per_op[mode]:.3f} cycles each")
    card.round_cycles = per_op[2] * CHAIN_DEP_OPS
    log(f"K5 round critical path: {card.round_cycles:.3f} cycles measured "
        f"(shf -> lop3 -> add), against {CHAIN_DEP_OPS} x {DEP_CYCLES} = "
        f"{CHAIN_DEP_OPS * DEP_CYCLES} assumed; one warp issues an "
        f"independent shf every {per_op[3]:.3f} cycles, an independent "
        f"lop3 every {per_op[4]:.3f}")
    for blocks in (757, 997):
        log(f"K5 latency bound at {blocks} blocks: measured "
            f"{card.chain_bound(blocks)[0]:.4f} ms, assumed "
            f"{card.chain_bound(blocks, CHAIN_DEP_OPS * DEP_CYCLES)[0]:.4f} "
            f"ms, earlier 4-operation form "
            f"{card.chain_bound(blocks, OLD_CHAIN_DEP_OPS * DEP_CYCLES)[0]:.4f}"
            " ms")


def phase_chain(res: Results, dev) -> None:
    """K5's chain form on the streams the proves send it, with seeded
    openings: the fresh channel's first absorb on its own (3 blocks,
    FIRST_ROW layout), a 5,000-block stream with mixed flags (ten staged
    chunks), then for each path one chain of a later absorb, one query of
    that configuration (built by the prover's own query plan) and a
    reset-only row.  Then K5's query form on each path's plan with seeded
    trees: all 16 queries in one launch against the per-query plain
    loop, on all four outputs."""
    from stark_tpu_torch.channel.device_channel import absorb_stream
    from stark_tpu_torch.channel.device_query import (DeviceQueryPlan,
                                                      query_chain,
                                                      query_chain_plain)
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW,
                                                 sha_chain, sha_chain_plain)
    from stark_tpu_torch.stark.prover import query_plan

    rs = np.random.RandomState(SEED + 2)
    root = rand_u32(rs, 8, 1 << 32, dev)
    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    s0, f0 = absorb_stream(root, initial=True)
    res.check("K5", f"first absorb ({s0.shape[0]} blocks)",
              sha_chain(s0, f0, zero), sha_chain_plain(s0, f0, zero))
    first = rs.choice([0, 0, 0, 0, FIRST_HEX, FIRST_ROW], size=LONG_STREAM)
    last = rs.randint(0, 2, size=LONG_STREAM)
    fl = torch.from_numpy(np.stack([first, last], 1).astype(np.int32)).to(dev)
    stream = rand_u32(rs, (LONG_STREAM, 16), 1 << 32, dev)
    chain = rand_u32(rs, 8, 1 << 32, dev)
    res.check("K5", f"chain form, {LONG_STREAM} blocks of mixed flags",
              sha_chain(stream, fl, chain), sha_chain_plain(stream, fl, chain))
    # what a block costs by kind: W + K staged by the other warps, or a
    # FIRST_HEX row whose hex and schedule run on the chain's thread
    rows = stream[:ROW_COST_BLOCKS]
    for what, pair in (("rows with W + K staged", (0, 0)),
                       ("FIRST_HEX rows", (FIRST_HEX, 1))):
        fk = torch.tensor([pair] * ROW_COST_BLOCKS, dtype=torch.int32,
                          device=dev)
        ms = cuda_ms(lambda: sha_chain(rows, fk, chain))
        cycles = ms * 1e-3 * res.card.clock_hz / ROW_COST_BLOCKS
        log(f"K5 chain form, {ROW_COST_BLOCKS} {what}: {ms:.4f} ms, "
            f"{ms / ROW_COST_BLOCKS * 1e6:.1f} ns a block, {cycles:.0f} "
            f"cycles a block ({cycles / 64:.2f} a round) at "
            f"{res.card.clock_hz / 1e6:.0f} MHz")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    for name in ("2^20", "2^24"):
        plan = query_plan(ProverConfig(**PROVES[name][0]))
        tb = plan.pack(dev)
        nv, nd = tb.num_values, int(tb.slots.shape[0]) - tb.num_values
        sq, fq = plan.stream(rand_u32(rs, nv, P, dev),
                             rand_u32(rs, (nd, 8), 1 << 32, dev))
        s1, f1 = absorb_stream(root, initial=False)
        reset = torch.tensor([[FIRST_ROW, 1]], dtype=torch.int32, device=dev)
        stream = torch.cat([s1, sq, rand_u32(rs, (1, 16), 1 << 32, dev)])
        fl = torch.cat([f1, fq, reset])
        chain = rand_u32(rs, 8, 1 << 32, dev)
        blocks = int(stream.shape[0])
        what = f"absorb + {name} query ({sq.shape[0]} blocks) + reset row"
        res.check("K5", f"{what} ({blocks} blocks)",
                  sha_chain(stream, fl, chain),
                  sha_chain_plain(stream, fl, chain))
        got = res.time("K5", f"{what}, {blocks} blocks",
                       lambda: sha_chain(stream, fl, chain),
                       lambda: sha_chain_plain(stream, fl, chain),
                       res.card.chain_bound(blocks), row=name == PATH)
        log(f"K5 chain form, {name}: "
            f"{res.card.chain_bounds_text(blocks, got['ms'])}")
        del stream, fl

        # the query form: the plan's buffers with seeded words
        n_f, n_td, n_fv, n_fd = tb.sizes
        args = (rand_u32(rs, 8, 1 << 32, dev),
                rand_words_dev(gen, (n_f,), dev),
                rand_words_dev(gen, (n_td, 8), dev),
                rand_words_dev(gen, (n_fv,), dev),
                rand_words_dev(gen, (n_fd, 8), dev))
        got = query_chain(*args, tb)
        want = query_chain_plain(*args, tb)
        for out, a, b in zip(("final chain", "idxs", "vals", "digs"), got,
                             want):
            res.check("K5", f"query form, {name} plan, "
                      f"{tb.num_queries} queries: {out}", a, b)
        blocks, comps = res.card.query_bound(tb)
        got = res.time(
            "K5", f"query form, {name} plan, {tb.num_queries} queries "
            f"({blocks} blocks, {tb.tasks.shape[0]} recompute tasks to "
            f"prune {tb.max_prune})", lambda: query_chain(*args, tb),
            lambda: query_chain_plain(*args, tb),
            res.card.chain_bound(comps), row=False, plain_reps=1)
        log(f"K5 query form, {name}: "
            f"{res.card.chain_bounds_text(comps, got['ms'])}")
        res.rows["K5"].setdefault("query_form", {})[name] = got
        del args, want
        if tb.max_prune:
            res.rows["K5 pruned recompute"].setdefault(
                "shapes", {})[f"{name} plan"] = got
            # the recompute's cost: the same plan over unpruned trees
            # (the same stream, no recompute), in this call
            full = DeviceQueryPlan(plan.rng, plan.num_queries, plan.offsets,
                                   plan.trace_len, plan.fri_lengths).pack(dev)
            n_f, n_td, n_fv, n_fd = full.sizes
            args = (rand_u32(rs, 8, 1 << 32, dev),
                    rand_words_dev(gen, (n_f,), dev),
                    rand_words_dev(gen, (n_td, 8), dev),
                    rand_words_dev(gen, (n_fv,), dev),
                    rand_words_dev(gen, (n_fd, 8), dev))
            full_ms = cuda_ms(lambda: query_chain(*args, full))
            log(f"K5 query form, {name} plan over unpruned trees: "
                f"{full_ms:.4f} ms; the recompute's cost "
                f"{got['ms'] - full_ms:.4f} ms a launch")
            got["unpruned_ms"] = full_ms
            del args
        torch.cuda.empty_cache()

    # the query form on plans of row openings: C values a trace message
    for what, (prove_name, cols) in QUERY_ROW_PLANS.items():
        cfg, air = prove_setup(prove_name)
        plan = query_plan(cfg, air)
        if cols is not None:
            plan = DeviceQueryPlan(plan.rng, plan.num_queries, plan.offsets,
                                   plan.trace_len, plan.fri_lengths, cols)
        tb = plan.pack(dev)
        n_f, n_td, n_fv, n_fd = tb.sizes
        args = (rand_u32(rs, 8, 1 << 32, dev),
                rand_words_dev(gen, (n_f,), dev),
                rand_words_dev(gen, (n_td, 8), dev),
                rand_words_dev(gen, (n_fv,), dev),
                rand_words_dev(gen, (n_fd, 8), dev))
        got = query_chain(*args, tb)
        want = query_chain_plain(*args, tb)
        for out, a, b in zip(("final chain", "idxs", "vals", "digs"), got,
                             want):
            res.check("K5 row messages", f"query form, {what}, "
                      f"{tb.num_queries} queries: {out}", a, b)
        blocks = tb.num_queries * int(tb.template.shape[0])
        got = res.time(
            "K5 row messages", f"query form, {what}, {tb.num_queries} "
            f"queries ({blocks} blocks)", lambda: query_chain(*args, tb),
            lambda: query_chain_plain(*args, tb),
            res.card.chain_bound(blocks), row=what == QUERY_ROW_PLAN_IN_ROW,
            other=True, plain_reps=1)
        log(f"K5 query form, {what}: "
            f"{res.card.chain_bounds_text(blocks, got['ms'])}")
        del args, got, want
        torch.cuda.empty_cache()

    # the query form on pruned plans: the unstored levels' siblings
    # recomputed in the launch, after each draw
    for what, (prove_name, in_row) in PRUNED_PLANS.items():
        cfg, air = prove_setup(prove_name)
        tb = query_plan(cfg, air).pack(dev)
        n_f, n_td, n_fv, n_fd = tb.sizes
        args = (rand_u32(rs, 8, 1 << 32, dev),
                rand_words_dev(gen, (n_f,), dev),
                rand_words_dev(gen, (n_td, 8), dev),
                rand_words_dev(gen, (n_fv,), dev),
                rand_words_dev(gen, (n_fd, 8), dev))
        got = query_chain(*args, tb)
        want = query_chain_plain(*args, tb)
        for out, a, b in zip(("final chain", "idxs", "vals", "digs"), got,
                             want):
            res.check("K5 pruned recompute", f"query form, {what}, "
                      f"{tb.num_queries} queries: {out}", a, b)
        blocks, comps = res.card.query_bound(tb)
        got = res.time(
            "K5 pruned recompute", f"query form, {what}, {tb.num_queries} "
            f"queries ({blocks} blocks, {tb.tasks.shape[0]} recompute "
            f"tasks, {tb.subtree_rows} nodes a query)",
            lambda: query_chain(*args, tb),
            lambda: query_chain_plain(*args, tb),
            res.card.chain_bound(comps), row=in_row, other=True,
            plain_reps=1)
        log(f"K5 query form, {what}: "
            f"{res.card.chain_bounds_text(comps, got['ms'])} (the chain's "
            f"{blocks} blocks and {comps - blocks} recompute compressions)")
        del args, got, want
        torch.cuda.empty_cache()


def phase_golden() -> None:
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR, MimcAIR, StarkProof, prove

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "vectors", "golden_proofs.json")
    with open(path) as fh:
        vectors = json.load(fh)
    cases = {
        "fib_gf97_2e2": (ProverConfig(modulus=97, generator=5, log2_trace=2,
                                      blowup=4, num_queries=2), 3),
        "fib_stark101_2e6": (ProverConfig(log2_trace=6, blowup=8,
                                          num_queries=4), 3141592),
        "mimc3_2e5": (ProverConfig(log2_trace=5, blowup=4, num_queries=3),
                      MimcAIR(x0=271828, k=777)),
        "fibmul_2e5": (ProverConfig(log2_trace=5, blowup=4, num_queries=3),
                       FibMulAIR(a0=1, b0=2718281)),
        "fibmul_gl_2e5": (ProverConfig(log2_trace=5, blowup=4, num_queries=3,
                                       **_GL), FibMulAIR(**_FIBMUL)),
    }
    for name, (cfg, arg) in cases.items():
        # no device: the card by default
        got = (prove(cfg, a1=arg) if isinstance(arg, int)
               else prove(cfg, air=arg)).proof
        want = StarkProof.deserialize(json.dumps(vectors[name]).encode()).proof
        if got != want:
            raise AssertionError(f"golden vector {name}: transcript differs")
        log(f"golden {name} (prove() with its default device): "
            f"{len(got)} messages, byte-identical")


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set for the block (None: unset)."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def synced_prove(cfg, air, want_path: str, **kw):
    """(proof, wall ms) of one prove() with no device argument (the card),
    synchronised before and after; it must take `want_path`."""
    from stark_tpu_torch.stark import prove
    from stark_tpu_torch.stark import prover as tprover

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr = prove(cfg, air=air, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tprover.LAST_PROVE_PATH != want_path:
        raise AssertionError(f"{cfg} took {tprover.LAST_PROVE_PATH}, "
                             f"expected {want_path}")
    return pr, ms


def no_mega_prove(cfg, air, **kw):
    with env_set(STARK_TPU_TORCH_NO_MEGA="1"):
        return synced_prove(cfg, air, "single-fetch", **kw)


def mega_turns(cfg, air, turns: int) -> dict:
    """`turns` warm walls (ms) each of the mega and the multi-launch
    prove, in turns (mega, no-mega, no-mega, mega, ...): each wall, the
    median and the spread (max - min)."""
    walls = {"mega": [], "no-mega": []}
    order = ("mega", "no-mega", "no-mega", "mega")
    for turn in range(2 * turns):
        which = order[turn % 4]
        _, ms = (synced_prove(cfg, air, "mega") if which == "mega"
                 else no_mega_prove(cfg, air))
        walls[which].append(round(ms, 3))
    return {k: {"ms": v, "median": round(statistics.median(v), 3),
                "spread": round(max(v) - min(v), 3)}
            for k, v in walls.items()}


def mega_program(cfg, air):
    """The cached mega program of a fresh channel's prove of `cfg` on the
    default card."""
    from stark_tpu_torch.stark import FibonacciSquareAIR
    from stark_tpu_torch.stark import prover as tprover

    ctx = tprover.get_air_context(air or FibonacciSquareAIR(), cfg,
                                  torch.device("cuda"))
    (prog,) = [p for key, p in ctx._mega_fns.items() if key[1]]
    return prog


def mega_profile(cfg, air, walls: dict) -> dict:
    """One warm prove of each path under torch.profiler: its device
    kernels, memory copies, host kernel-launch and graph-launch calls,
    and the device busy time (union of device event intervals) as a
    share of the path's median warm wall; and one bare replay of the
    graph's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.events()
        gpu = [e for e in ev if e.device_type == DeviceType.CUDA]
        kernels = [e for e in gpu if not e.name.startswith("Mem")]
        return {"device_kernels": len(kernels),
                "device_copies": len(gpu) - len(kernels),
                "host_launch_calls": sum(
                    e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                    for e in ev),
                "graph_launches": sum(e.name == "cudaGraphLaunch"
                                      for e in ev),
                "busy_ms": round(busy_us(gpu) / 1e3, 4)}

    out = {}
    for which, ctxm in (("mega", contextlib.nullcontext()),
                        ("no-mega", env_set(STARK_TPU_TORCH_NO_MEGA="1"))):
        with ctxm:
            got = traced(lambda: synced_prove(
                cfg, air, "mega" if which == "mega" else "single-fetch"))
        got["busy_share_of_median_wall"] = round(
            got["busy_ms"] / walls[which]["median"], 4)
        out[which] = got
    out["one replay"] = traced(mega_program(cfg, air).graph.replay)
    if not out["one replay"]["device_kernels"]:
        raise AssertionError("torch.profiler saw no kernel of a replay")
    return out


def phase_mega(res: Results, dev) -> dict:
    """The single-dispatch prove on the card (stark/prover.py
    _prove_mega, module docstring).  For each MEGA_PROVES configuration:
    prove() with no device argument takes the "mega" path; its first
    prove captures the graph (the region's wrappers called three times:
    two eager runs, one under torch.cuda.set_sync_debug_mode("error"),
    then the capture; the LDE's kernels once), its second replays it
    (capture count unchanged, no region wrapper called: a replay is
    counted as a replay, not as launches); both transcripts equal the
    multi-launch prove's (STARK_TPU_TORCH_NO_MEGA), verified and a
    flipped byte rejected; warm walls of both paths in turns, the first
    prove's wall and the graph's pool, and for MEGA_PROFILED the device
    busy share and the kernels of a replay.  Then two statements through
    one graph, a continued channel, and the MEGA_RECORDED configurations
    (recorded only).  Each kernel row's launches_by_prove gets the
    capturing prove's wrapper calls and the replay's."""
    from stark_tpu_torch.channel.channel import Channel
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import prover as tprover

    drop_plans()
    table = {}
    for name, (kw, air_name, args) in MEGA_PROVES.items():
        cfg, air = ProverConfig(**kw), air_of(air_name, args)
        stats = dict(tprover.MEGA_STATS)
        want = expected_launches(cfg, air)
        reset_counts()
        first, first_ms = synced_prove(cfg, air, "mega")
        capture_counts = read_counts()
        reset_counts()
        second, warm_ms = synced_prove(cfg, air, "mega")
        replay_counts = read_counts()
        got = {k: tprover.MEGA_STATS[k] - stats[k] for k in stats}
        if got != {"captures": 1, "replays": 2, "eager": 0}:
            raise AssertionError(f"{name}: mega counts {got}, expected one "
                                 "capture and two replays")
        for k in LDE_ROWS:
            if capture_counts[k] != want[k] or replay_counts[k] != want[k]:
                raise AssertionError(
                    f"{name}: {k} launched {capture_counts[k]} / "
                    f"{replay_counts[k]} times, expected {want[k]} a prove")
        for k in REGION_ROWS:
            if capture_counts[k] != 3 * want[k] or replay_counts[k]:
                raise AssertionError(
                    f"{name}: region row {k} called {capture_counts[k]} "
                    f"times in the capturing prove (expected {3 * want[k]}) "
                    f"and {replay_counts[k]} in the replay (expected 0)")
        if not capture_counts["K5"] or replay_counts["K5"]:
            raise AssertionError(f"{name}: K5 called {capture_counts['K5']}"
                                 f" / {replay_counts['K5']} times")
        for k, row in res.rows.items():
            row["launches_by_prove"][f"mega {name}, capturing prove"] = \
                capture_counts[k]
            row["launches_by_prove"][f"mega {name}, replay"] = \
                replay_counts[k]
        ref, _ = no_mega_prove(cfg, air)
        digest = hashlib.sha256(b"".join(first.proof)).hexdigest()
        if first.proof != second.proof or first.proof != ref.proof:
            raise AssertionError(f"{name}: the mega transcript differs from "
                                 "the multi-launch prove's")
        check_verifies(name, cfg, first)
        prog = mega_program(cfg, air)
        rec = {"M": cfg.eval_domain_size, "sha256": digest,
               "first_prove_ms": round(first_ms, 3),
               "first_launch_ms": round(prog.first_s * 1e3, 3),
               "second_prove_ms": round(warm_ms, 3),
               "pool_mib": round(prog.pool_bytes / 2**20, 2),
               "region_wrapper_calls_in_capture": {
                   k: capture_counts[k] for k in REGION_ROWS + ("K5",)
                   if capture_counts[k]},
               "walls": mega_turns(cfg, air, MEGA_TURNS)}
        if name in MEGA_PROFILED:
            rec["profile"] = mega_profile(cfg, air, rec["walls"])
        log(f"mega {name} (M = {cfg.eval_domain_size}): path mega, "
            f"transcript sha256 {digest} equal to the multi-launch prove's, "
            f"verified; first prove {first_ms:.3f} ms (capture included), "
            f"pool {rec['pool_mib']} MiB; warm walls (ms) "
            f"{json.dumps(rec['walls'])}"
            + (f"; profile {json.dumps(rec['profile'])}"
               if "profile" in rec else ""))
        table[name] = rec

    # two statements through one graph, then a continued channel
    cfg = ProverConfig()
    caps = tprover.MEGA_STATS["captures"]
    for a1 in (3141592, 2718281):
        got, _ = synced_prove(cfg, None, "mega", a1=a1)
        ref, _ = no_mega_prove(cfg, None, a1=a1)
        if got.proof != ref.proof:
            raise AssertionError(f"a1 = {a1} through the captured graph "
                                 "differs from its multi-launch prove")
    if tprover.MEGA_STATS["captures"] != caps:
        raise AssertionError("a second statement captured a new graph")
    log("mega: two statements (a1 = 3141592, 2718281) through the one "
        "captured ProverConfig() graph, each equal to its multi-launch "
        "prove")

    def channel():
        ch = Channel(cfg.modulus)
        ch.send(b"a statement proved before")
        return ch

    for turn in range(2):
        got, ms = synced_prove(cfg, None, "mega", channel=channel())
        ref, _ = no_mega_prove(cfg, None, channel=channel())
        if got.proof != ref.proof:
            raise AssertionError("a continued channel's mega transcript "
                                 "differs from its multi-launch prove's")
    if tprover.MEGA_STATS["captures"] != caps + 1:
        raise AssertionError("the continued channel did not take one "
                             "program of its own")
    log("mega: a continued channel (initial false) through its own graph, "
        "captured once, replayed once, equal to the multi-launch prove")

    for name, (kw, air_name, args, extra) in MEGA_RECORDED.items():
        cfg, air = ProverConfig(**kw), air_of(air_name, args)
        with env_set(**extra):
            first, first_ms = synced_prove(cfg, air, "mega")
            ref, _ = no_mega_prove(cfg, air)
            if first.proof != ref.proof:
                raise AssertionError(f"{name}: mega transcript differs")
            prog = mega_program(cfg, air)
            rec = {"M": cfg.eval_domain_size, "env": extra,
                   "first_prove_ms": round(first_ms, 3),
                   "pool_mib": round(prog.pool_bytes / 2**20, 2),
                   "walls": mega_turns(cfg, air, MEGA_RECORDED_TURNS)}
        log(f"mega recorded {name}: equal to the multi-launch prove; "
            f"{json.dumps(rec)}")
        table[name] = rec
    log(f"mega table ({card_smi()}): {json.dumps(table)}")
    drop_plans()
    return table


def counters() -> dict:
    """Each row of the kernels line: its wrappers' counters, as (wrapper,
    attribute) pairs (K5 has two entry points, both counted; the batched
    NTT rows count the same wrappers' (C, n) launches)."""
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_batch,
                                                      query_chain_cut)
    from stark_tpu_torch.hash.cuda_chain import sha_chain, sha_chain_batch
    from stark_tpu_torch.hash.cuda_sha import (sha_leaves, sha_nodes,
                                               sha_nodes_batch,
                                               sha_row_leaves, sha_subtree,
                                               sha_subtree_batch, sha_tail,
                                               sha_tail_batch)
    from stark_tpu_torch.ntt.cuda_ntt import ntt_k1, ntt_k2
    from stark_tpu_torch.ntt.cuda_ntt64 import ntt64

    # K3 is one kernel launched with its node levels (sha_subtree) or
    # without (sha_leaves / sha_row_leaves, an odd tree's leaves)
    return {"K1": ((ntt_k1, "launches"),), "K2": ((ntt_k2, "launches"),),
            "K1 batched": ((ntt_k1, "column_launches"),),
            "K2 batched": ((ntt_k2, "column_launches"),),
            "NTT 64-bit": ((ntt64, "launches"),),
            "NTT 64-bit batched": ((ntt64, "column_launches"),),
            "K3": ((sha_subtree, "launches"), (sha_leaves, "launches")),
            "K3 row form": ((sha_subtree, "row_launches"),
                            (sha_row_leaves, "launches")),
            "K3 wide": ((sha_subtree, "wide_launches"),
                        (sha_leaves, "wide_launches")),
            "K3 wide row form": ((sha_subtree, "row_wide_launches"),
                                 (sha_row_leaves, "wide_launches")),
            "K4": ((sha_nodes, "launches"),),
            "K4 tail": ((sha_tail, "launches"), (sha_tail_batch, "launches")),
            "K5": ((sha_chain, "launches"), (query_chain, "launches"),
                   (query_chain_cut, "launches")),
            "K5 row messages": ((query_chain, "launches"),),
            "K5 pruned recompute": ((query_chain, "launches"),),
            "K3 tree batch": ((sha_subtree_batch, "launches"),
                              (sha_subtree_batch, "wide_launches")),
            "K4 tree batch": ((sha_nodes_batch, "launches"),),
            "K5 chain batch": ((sha_chain_batch, "launches"),),
            "K5 query batch": ((query_chain_batch, "launches"),),
            "K5 sharded query": ((query_chain, "sharded_launches"),),
            "K5 cut query": ((query_chain_cut, "launches"),)}


def read_counts() -> dict:
    return {k: sum(getattr(fn, a) for fn, a in pairs)
            for k, pairs in counters().items()}


def reset_counts() -> None:
    for pairs in counters().values():
        for fn, a in pairs:
            setattr(fn, a, 0)


def family_secret(family: str) -> int:
    """The family's default witness value that build_air takes as the
    secret (tribmul's b0, the mimc5 families' x0)."""
    from stark_tpu_torch.stark.families import FAMILIES

    spec, key = FAMILIES[family]
    return spec.witness_params()["witness"][key]


def prove_setup(name: str):
    """(config, AIR or None for the default statement) of a prove."""
    from stark_tpu_torch.config import ProverConfig

    kw, air, args = PROVES[name]
    return ProverConfig(**kw), air_of(air, args)


def air_of(air: str | None, args: dict):
    """The AIR of a name and its arguments (None for the default
    statement); a family through families.build_air with its default
    witness."""
    from stark_tpu_torch.stark import FibMulAIR, MimcAIR
    from stark_tpu_torch.stark.families import FAMILIES, build_air

    if air in FAMILIES:
        return build_air(air, family_secret(air))
    cls = {None: None, "mimc3": MimcAIR, "fibmul": FibMulAIR}[air]
    return cls(**args) if cls else None


def drop_plans() -> None:
    """Forget the NTT plans and oracle tables (device memory) that the
    kernel checks built (the four-step's twiddles too), and the AIR
    contexts and FRI domains of earlier proves, so a cold prove builds
    its own as in a fresh process and its peak memory counts only its
    own."""
    from stark_tpu_torch.dist import ntt as dist_ntt
    from stark_tpu_torch.fri import commit
    from stark_tpu_torch.ntt import cuda_ntt, cuda_ntt64
    from stark_tpu_torch.stark import prover

    cuda_ntt.get_cuda_plan.cache_clear()
    cuda_ntt64._cached_plan.cache_clear()
    cuda_ntt._stage_twiddles.cache_clear()  # the Stockham oracle's tables
    dist_ntt._twiddle.cache_clear()  # the four-step's w^(j2 k1) blocks
    prover._CTX_CACHE.clear()
    commit._inv_domain.cache_clear()
    torch.cuda.empty_cache()


def phase_peaks():
    """A metrics collector for prove(metrics=...) that also records each
    of the five phases' peak device memory in MiB (the peak statistics
    reset as the phase starts; prove() synchronises as it ends)."""
    import contextlib

    from stark_tpu_torch.utils.metrics import MetricsCollector

    class PhasePeaks(MetricsCollector):
        peaks: dict

        @contextlib.contextmanager
        def phase(self, name, **extra):
            torch.cuda.reset_peak_memory_stats()
            with MetricsCollector.phase(self, name, **extra):
                yield
            self.peaks[name] = round(
                torch.cuda.max_memory_allocated() / 2**20, 1)

    mx = PhasePeaks()
    mx.peaks = {}
    return mx


def timed_proves(cfg, air, dev, warm: bool = True):
    """A cold prove (plans and contexts dropped), its five phases synced
    with their peak device memory, and (with `warm`) a warm one: (cold,
    warm or None, cold seconds, warm seconds or None, the cold prove's
    peak device bytes, bytes allocated before it, its launches, its
    phases' {"peak_mib": ..., "wall_ms": ...})."""
    from stark_tpu_torch.stark import prove

    drop_plans()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_counts()
    mx = phase_peaks()
    t0 = time.perf_counter()
    cold = prove(cfg, air=air, device=dev, metrics=mx)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_counts()
    peak = max(mx.peaks.values()) * 2**20
    phases = {"peak_mib": mx.peaks, "wall_ms": {
        ph.name: round(ph.wall_s * 1e3, 3) for ph in mx.phases}}
    if not warm:
        return cold, None, cold_s, None, peak, base, launches, phases
    t0 = time.perf_counter()
    again = prove(cfg, air=air, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if cold.proof != again.proof:
        raise AssertionError(f"{cfg} prove is not deterministic")
    return cold, again, cold_s, warm_s, peak, base, launches, phases


def check_verifies(name: str, cfg, proof) -> None:
    """The host verifier accepts the proof and rejects it with one byte
    of its middle message flipped."""
    from stark_tpu_torch.stark import (StarkProof, StarkVerificationError,
                                       verify)

    blob = proof.serialize()
    if not verify(StarkProof.deserialize(blob), expected_config=cfg):
        raise AssertionError(f"verifier rejected the {name} proof")
    tampered = StarkProof.deserialize(blob)
    k = len(tampered.proof) // 2
    msg = bytearray(tampered.proof[k])
    msg[0] ^= 1
    tampered.proof[k] = bytes(msg)
    try:
        verify(tampered)
    except StarkVerificationError as e:
        log(f"tampered {name} proof (message {k}) rejected: {str(e)[:80]}")
    else:
        raise AssertionError("verifier accepted a tampered proof")


def expected_launches(cfg, air) -> dict:
    """Each kernel row's launches in one prove of `cfg`, from its query
    plan's tree sizes and prune depths.  u32 fields: one NTT wrapper call
    a transform (trace INTT, LDE) whatever the column count, K1 up to
    2^MAX_LOG_N (the 2^20 paths), K2 above; Goldilocks: the 64-bit
    kernels the same way, whatever the size.  Each tree as
    ``merkle/tree.py``'s split builds it
    (``tree_launches``): K3's subtree form once a pass (a tree, or a
    chunk of a chunked one) in the field's mode, its row form for a
    multi-column trace tree; K4 once a level between the subtree's top
    (or the first stored level) and the tail, plus the levels a pass
    prunes past the fused ones; the tail once a tree (the whole build of
    a tree of at most 2^10 leaves); K5's query form once."""
    from stark_tpu_torch.fields.fp import Fp
    from stark_tpu_torch.merkle import tree as mt
    from stark_tpu_torch.ntt import cuda_ntt
    from stark_tpu_torch.stark.prover import query_plan

    plan = query_plan(cfg, air)
    cols = plan.num_columns
    wide = Fp.get(cfg.modulus).width == 2
    k1 = 0 if wide else sum(n <= 1 << cuda_ntt.MAX_LOG_N
                            for n in (cfg.trace_domain_size,
                                      cfg.eval_domain_size))
    k2 = 0 if wide else 2 - k1
    trace = mt.tree_launches(plan.trace_len, plan.trace_prune)
    fri = [mt.tree_launches(ln, pr)
           for ln, pr in zip(plan.fri_lengths, plan.fri_prune)]
    trees = [trace] + fri

    def k3(t):
        return t["subtree"] + t["leaves"]

    k3 = (sum(k3(f) for f in fri) + k3(trace) * (cols == 1),
          k3(trace) * (cols > 1))  # (one column, row form)
    u32_k3, wide_k3 = ((0, 0), k3) if wide else (k3, (0, 0))
    return {"K1": k1, "K2": k2,
            "K1 batched": k1 * (cols > 1), "K2 batched": k2 * (cols > 1),
            "NTT 64-bit": 2 * wide,
            "NTT 64-bit batched": 2 * wide * (cols > 1),
            "K3": u32_k3[0], "K3 row form": u32_k3[1],
            "K3 wide": wide_k3[0], "K3 wide row form": wide_k3[1],
            "K4": sum(t["nodes"] for t in trees),
            "K4 tail": sum(t["tail"] for t in trees),
            # both rows count the query form's launches; the pruned
            # row's own launches are the 2^26 prove's (ROW_PATH)
            "K5 row messages": 1, "K5 pruned recompute": 1}


def tree_launches_text(launches: dict) -> str:
    """A prove's tree kernel launches: K3 (all forms) + K4 + tail."""
    k3 = sum(launches[k] for k in ("K3", "K3 row form", "K3 wide",
                                   "K3 wide row form"))
    return (f"tree launches {k3 + launches['K4'] + launches['K4 tail']} "
            f"(K3 {k3}, K4 {launches['K4']}, tail {launches['K4 tail']})")


def phase_prove(res: Results, dev, name: str) -> dict:
    """Prove the `name` configuration twice (cold, warm): deterministic,
    verified, tamper-rejected, with its kernels launched as its plan's
    trees say; for UNPRUNED_TOO once more (with its warm wall if asked)
    with pruning off, which must give the same transcript.  Returns its
    walls, peak memory and its phases' peaks."""
    from stark_tpu_torch.stark import FibonacciSquareAIR

    cfg, air = prove_setup(name)
    air_used = air or FibonacciSquareAIR()
    cold, _, cold_s, warm_s, peak, base, launches, peaks = timed_proves(
        cfg, air, dev)
    log(f"prove {name} ({air_used.name}, {PROVES[name][0]}): cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s, peak device memory "
        f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated before "
        f"it), {len(cold.proof)} messages, {cold.size_bytes()} bytes, "
        f"publics {cold.publics}")
    log(f"{name} cold prove's phases' peak device memory (MiB): "
        f"{json.dumps(peaks['peak_mib'])}; walls (ms, each phase synced): "
        f"{json.dumps(peaks['wall_ms'])}")
    log(f"launches during the cold {name} prove: {launches}; "
        f"{tree_launches_text(launches)}")
    digest = hashlib.sha256(b"".join(cold.proof)).hexdigest()
    if digest != TRANSCRIPT_SHA256[name]:
        raise AssertionError(f"{name} transcript sha256 {digest} differs "
                             f"from the pinned {TRANSCRIPT_SHA256[name]}")
    log(f"{name} transcript sha256 {digest}: as pinned")
    check_verifies(name, cfg, cold)
    log(f"{name} proof deterministic and accepted by the host verifier")
    want = expected_launches(cfg, air)
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{k} launched {launches[k]} times in the "
                                 f"{name} prove, expected {n}")
    if launches["K5"] == 0:
        raise AssertionError(f"kernel K5 never launched in the {name} prove")
    for k, count in launches.items():
        res.rows[k]["launches_by_prove"][name] = count
        if name == ROW_PATH.get(k, PATH):
            res.rows[k]["launches"] = count
    out = {"cold_s": round(cold_s, 3), "warm_s": round(warm_s, 3),
           "peak_mib": round(peak / 2**20, 1),
           "phase_peak_mib": peaks["peak_mib"],
           "cold_phase_ms": peaks["wall_ms"], "sha256": digest}
    del cold
    if name in UNPRUNED_TOO:
        out["unpruned"] = unpruned_prove(name, cfg, air, dev, digest,
                                         UNPRUNED_TOO[name])
    return out


def unpruned_prove(name, cfg, air, dev, digest: str, warm: bool) -> dict:
    """The `name` prove with pruning off (STARK_TPU_TORCH_NO_PRUNE): its
    transcript must equal the pruned prove's.  Returns its walls and
    peaks."""
    os.environ["STARK_TPU_TORCH_NO_PRUNE"] = "1"
    try:
        cold, _, cold_s, warm_s, peak, _, launches, peaks = timed_proves(
            cfg, air, dev, warm=warm)
        want = expected_launches(cfg, air)
    finally:
        del os.environ["STARK_TPU_TORCH_NO_PRUNE"]
    got = hashlib.sha256(b"".join(cold.proof)).hexdigest()
    if got != digest:
        raise AssertionError(f"{name} unpruned transcript sha256 {got} != "
                             f"the pruned prove's {digest}")
    if (launches["K3"] + launches["K3 row form"] + launches["K3 wide"]
            + launches["K3 wide row form"], launches["K4"],
            launches["K4 tail"]) != (
            want["K3"] + want["K3 row form"] + want["K3 wide"]
            + want["K3 wide row form"], want["K4"], want["K4 tail"]):
        raise AssertionError(f"unpruned {name} prove launched {launches}, "
                             f"expected {want}")
    warm_txt = f", warm {warm_s:.3f} s" if warm else ""
    log(f"prove {name} unpruned: {tree_launches_text(launches)}")
    log(f"prove {name} unpruned: cold {cold_s:.3f} s{warm_txt}, peak "
        f"device memory {peak / 2**20:.1f} MiB, phases' peaks (MiB) "
        f"{json.dumps(peaks['peak_mib'])}, walls (ms) "
        f"{json.dumps(peaks['wall_ms'])}; transcript equal to the pruned "
        "prove's")
    out = {"cold_s": round(cold_s, 3), "peak_mib": round(peak / 2**20, 1),
           "phase_peak_mib": peaks["peak_mib"],
           "cold_phase_ms": peaks["wall_ms"]}
    if warm:
        out["warm_s"] = round(warm_s, 3)
        out["warm_turns_s"] = warm_turns(cfg, air, dev)
        log(f"{name} warm walls in turns (s): "
            f"{json.dumps(out['warm_turns_s'])}")
    return out


def warm_turns(cfg, air, dev) -> dict:
    """WARM_TURNS warm walls each of the pruned and the unpruned prove,
    in turns (pruned, unpruned, unpruned, pruned, ...)."""
    from stark_tpu_torch.stark import prove

    walls = {"pruned": [], "unpruned": []}
    order = ["pruned", "unpruned", "unpruned", "pruned"]
    for turn in range(2 * WARM_TURNS):
        which = order[turn % 4]
        if which == "unpruned":
            os.environ["STARK_TPU_TORCH_NO_PRUNE"] = "1"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prove(cfg, air=air, device=dev)
            torch.cuda.synchronize()
            walls[which].append(round(time.perf_counter() - t0, 3))
        finally:
            os.environ.pop("STARK_TPU_TORCH_NO_PRUNE", None)
    return walls


def phase_kernel_batches(res: Results, dev) -> None:
    """The batched kernel forms of stark/batch.py, each exact against its
    plain version (a loop over the single plain version) and against B
    single launches: the tree batch (K3's subtree form, K4, the tail)
    over B trees of 2^22 leaves,
    K5's chain form on B mixed-flag streams, K5's query form on the B =
    16 plan of the 2^20 batch with seeded buffers."""
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_batch,
                                                      query_chain_plain)
    from stark_tpu_torch.hash.cuda_chain import (FIRST_HEX, FIRST_ROW,
                                                 sha_chain, sha_chain_batch,
                                                 sha_chain_plain)
    from stark_tpu_torch.hash.cuda_sha import (level_row, sha_nodes,
                                               sha_nodes_batch, sha_subtree,
                                               sha_subtree_batch, sha_tail,
                                               sha_tail_batch)
    from stark_tpu_torch.hash.sha256 import sha256_pairs
    from stark_tpu_torch.merkle import tree as mt
    from stark_tpu_torch.merkle.tree import build_tree, level_offsets
    from stark_tpu_torch.stark.batch import _batched_tree
    from stark_tpu_torch.stark.prover import query_plan

    b, n = BATCH_B, 1 << BATCH_TREE_LOG
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    vals = rand_u32_dev(gen, (b, n), P, dev)
    trees = torch.empty((b, 2 * n - 1, 8), dtype=torch.int32, device=dev)
    _batched_tree(vals, trees, rows=False, wide=False)
    s_log, f = mt.SUBTREE_LOG, mt.SUBTREE_LEVELS
    kw = dict(span_log=s_log, levels=f, tree_log=BATCH_TREE_LOG)
    top = level_row(BATCH_TREE_LOG, 0, f, n >> f)
    plain_ms = 0.0  # the plain subtree of the B trees, one run each
    for k in range(b):
        one = build_tree(vals[k])
        plain = torch.empty_like(one)
        plain_ms += timed_plain(lambda: sha_subtree.plain(
            vals[k], plain[:top], **kw))[1]
        offs = level_offsets(n)
        for (oc, sc), (op, sp) in zip(offs[f:], offs[f + 1:]):
            plain[op:op + sp] = sha256_pairs(plain[oc:oc + sc])
        what = f"tree {k} of {b} x 2^{BATCH_TREE_LOG} leaves"
        for row in ("K3 tree batch", "K4 tree batch", "K4 tail"):
            res.check(row, f"{what} (every level): single launches",
                      trees[k], one)
            res.check(row, f"{what} (every level): plain", trees[k], plain)
    del one, plain
    res.time("K3 tree batch", f"subtree B={b} x n=2^{BATCH_TREE_LOG}, {f} "
             "levels", lambda: sha_subtree_batch(vals, trees, **kw),
             plain_ms, subtree_bound(res.card, b * n, 1, False, f))
    single = cuda_ms(lambda: [sha_subtree(vals[k], trees[k], **kw)
                              for k in range(b)])
    log(f"K3 tree batch: {b} single launches {single:.4f} ms")
    m = n // 2
    kids, parents = trees[:, :n], trees[:, n:n + m]
    res.time("K4 tree batch", f"nodes B={b} x m=2^{BATCH_TREE_LOG - 1}",
             lambda: sha_nodes_batch(kids, parents),
             lambda: [sha256_pairs(kids[k]) for k in range(b)],
             res.card.bound(96 * b * m, (SHA_OPS + SHA_PAD_OPS) * b * m),
             plain_reps=1)
    single = cuda_ms(lambda: [sha_nodes(kids[k], out=parents[k])
                              for k in range(b)])
    log(f"K4 tree batch: {b} single launches {single:.4f} ms")
    tail_in = trees[:, 2 * n - 2048:2 * n - 1024]  # each tree's 2^10 level
    tail_out = trees[:, 2 * n - 1024:]
    ms = cuda_ms(lambda: sha_tail_batch(tail_in, tail_out))
    single = cuda_ms(lambda: [sha_tail(tail_in[k], tail_out[k])
                              for k in range(b)])
    log(f"K4 tail batch, B={b} x 2^10 nodes: {ms:.4f} ms; {b} single "
        f"launches {single:.4f} ms")
    del vals, trees, kids, parents, tail_in, tail_out

    rs = np.random.RandomState(SEED + 8)
    r = BATCH_STREAM
    first = rs.choice([0, 0, 0, 0, FIRST_HEX, FIRST_ROW], size=(b, r))
    last = rs.randint(0, 2, size=(b, r))
    fl = torch.from_numpy(np.stack([first, last], -1).astype(np.int32)).to(
        dev)
    stream = rand_u32(rs, (b, r, 16), 1 << 32, dev)
    chains = rand_u32(rs, (b, 8), 1 << 32, dev)
    got = sha_chain_batch(stream, fl, chains)
    for k in range(b):
        what = f"chain {k} of {b} ({r} blocks of mixed flags)"
        res.check("K5 chain batch", f"{what}: single launch", got[k],
                  sha_chain(stream[k], fl[k], chains[k]))
        res.check("K5 chain batch", f"{what}: plain", got[k],
                  sha_chain_plain(stream[k], fl[k], chains[k]))
    timed = res.time(
        "K5 chain batch", f"{b} chains of {r} blocks",
        lambda: sha_chain_batch(stream, fl, chains),
        lambda: [sha_chain_plain(stream[k], fl[k], chains[k])
                 for k in range(b)],
        res.card.chain_bound(r), plain_reps=1)
    single = cuda_ms(lambda: [sha_chain(stream[k], fl[k], chains[k])
                              for k in range(b)])
    log(f"K5 chain batch: {b} single launches {single:.4f} ms; "
        f"{res.card.chain_bounds_text(r, timed['ms'])}")
    del stream, fl

    cfg, air = prove_setup(BATCHES[0][0])
    tb = query_plan(cfg, air, pruned=False).pack(dev)
    n_f, n_td, n_fv, n_fd = tb.sizes
    args = (rand_u32(rs, (b, 8), 1 << 32, dev),
            rand_words_dev(gen, (b, n_f), dev),
            rand_words_dev(gen, (b, n_td, 8), dev),
            rand_words_dev(gen, (b, n_fv), dev),
            rand_words_dev(gen, (b, n_fd, 8), dev))
    got = query_chain_batch(*args, tb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = [query_chain_plain(*[a[k] for a in args], tb) for k in range(b)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for k in range(b):
        single = query_chain(*[a[k] for a in args], tb)
        for out, g, w, s1 in zip(("final chain", "idxs", "vals", "digs"),
                                 got, plain[k], single):
            what = f"proof {k} of {b}, {BATCHES[0][0]} plan: {out}"
            res.check("K5 query batch", f"{what}: single launch", g[k], s1)
            res.check("K5 query batch", f"{what}: plain", g[k], w)
    del plain
    blocks, comps = res.card.query_bound(tb)
    ms = cuda_ms(lambda: query_chain_batch(*args, tb))
    single = cuda_ms(lambda: [query_chain(*[a[k] for a in args], tb)
                              for k in range(b)])
    bound = res.card.chain_bound(comps)
    res.rows["K5 query batch"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
        shape=f"B={b} x the {BATCHES[0][0]} plan ({blocks} blocks a proof)")
    log(f"K5 query batch, B={b} x the {BATCHES[0][0]} plan: kernel "
        f"{ms:.4f} ms (median of {REPS}), plain loop {plain_ms:.4f} ms "
        f"(one run), {b} single launches "
        f"{single:.4f} ms; bound {bound[0]:.4f} ms (one proof's chain, "
        f"latency); kernel / bound {ms / bound[0]:.2f}")
    del args, got
    torch.cuda.empty_cache()


def batch_airs(name: str, b: int):
    """(config, b AIRs): statement 0 is the `name` prove's (its pinned
    digest), the others' secrets come from a seeded generator."""
    from stark_tpu_torch.stark import FibMulAIR, FibonacciSquareAIR

    cfg, air = prove_setup(name)
    rs = np.random.RandomState(SEED + 9)
    secrets = [int(x) for x in rs.randint(1, 2**31, size=b - 1)]
    if air is None:
        return cfg, [FibonacciSquareAIR()] + [FibonacciSquareAIR(a1=x)
                                              for x in secrets]
    return cfg, [air] + [FibMulAIR(a0=air.a0, b0=x) for x in secrets]


def phase_batch(res: Results, dev) -> dict:
    """prove_batch of each of BATCHES: every proof equal to its statement's
    prove, statement 0 to the pinned digest, all verified (and one
    tampered proof rejected), the kernels launched as often as one prove
    launches them; the batch's walls beside the sequential proves'."""
    from stark_tpu_torch.stark import prove, prove_batch, verify

    out = {}
    for name, b in BATCHES:
        cfg, airs = batch_airs(name, b)
        prove(cfg, air=airs[0], device=dev)  # warm (contexts, plans)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = [prove(cfg, air=a, device=dev) for a in airs]
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        single = read_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        proofs = prove_batch(cfg, airs, device=dev)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        again = prove_batch(cfg, airs, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for i, (got, want, rep) in enumerate(zip(proofs, seq, again)):
            if got.proof != want.proof or rep.proof != got.proof:
                raise AssertionError(f"{name} batch proof {i} differs from "
                                     "its statement's prove")
            if not verify(got, expected_config=cfg):
                raise AssertionError(f"{name} batch proof {i} rejected")
        digest = hashlib.sha256(b"".join(proofs[0].proof)).hexdigest()
        if digest != TRANSCRIPT_SHA256[name]:
            raise AssertionError(f"{name} batch statement 0 sha256 {digest}"
                                 f" != the pinned {TRANSCRIPT_SHA256[name]}")
        check_verifies(f"{name} batch proof {b - 1}", cfg, proofs[-1])
        # one prove's launches, over b proves; the batch's, once
        per_prove = {k: v // b for k, v in single.items()}
        want = {"K3 tree batch": per_prove["K3"] + per_prove["K3 row form"]
                + per_prove["K3 wide"] + per_prove["K3 wide row form"],
                "K4 tree batch": per_prove["K4"],
                "K4 tail": per_prove["K4 tail"],
                "K5 chain batch": (single["K5"] - single["K5 row messages"])
                // b,
                "K5 query batch": 1,
                "NTT": (per_prove["K1"] + per_prove["K2"]
                        + per_prove["NTT 64-bit"])}
        got = {k: counts[k] for k in want if k != "NTT"}
        got["NTT"] = counts["K1"] + counts["K2"] + counts["NTT 64-bit"]
        if got != want:
            raise AssertionError(f"{name} batch launched {got}, one prove "
                                 f"launches {want}")
        if name == BATCHES[0][0]:
            for k in ("K3 tree batch", "K4 tree batch", "K5 chain batch",
                      "K5 query batch"):
                res.rows[k]["launches"] = counts[k]
            split = batch_split(cfg, airs, dev, warm_s)
        for k in ("K3 tree batch", "K4 tree batch", "K4 tail",
                  "K5 chain batch", "K5 query batch"):
            res.rows[k]["launches_by_prove"][f"{name} batch of {b}"] = \
                counts[k]
        out[f"{name} x {b}"] = row = {
            "batch_cold_s": round(cold_s, 3), "batch_warm_s": round(warm_s, 3),
            "sequential_warm_s": round(seq_s, 3),
            "batch_proofs_per_s": round(b / warm_s, 3),
            "sequential_proofs_per_s": round(b / seq_s, 3),
            "batch_peak_mib": round(peak / 2**20, 1),
            "peak_mib_per_proof": round(peak / 2**20 / b, 1),
            "launches": got}
        if name == BATCHES[0][0]:
            row["split"] = split
        log(f"batch {name} x {b}: every proof equals its prove, statement 0 "
            f"as pinned, all verified; {json.dumps(row)}")
        del proofs, again, seq
        torch.cuda.empty_cache()
    return out


def batch_split(cfg, airs, dev, warm_s: float) -> dict:
    """Where a warm batch spends its wall: its host traces on their own,
    and one batch under torch.profiler (device busy = union of device
    event intervals; idle = 1 - busy / the warm wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stark_tpu_torch.stark import prove_batch

    t0 = time.perf_counter()
    for a in airs:
        a.host_trace(cfg)
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prove_batch(cfg, airs, device=dev)
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us(gpu) / 1e3
    out = {"host_traces_ms": round(host_ms, 3), "device_busy_ms":
           round(busy, 3), "device_events": len(gpu),
           "idle_share": round(1 - busy / (warm_s * 1e3), 4)}
    log(f"batch of {len(airs)}: {json.dumps(out)}")
    return out


def phase_resume(dev) -> dict:
    """prove_resumable of the RESUME prove: the per-phase prove's walls
    and peak beside the single-fetch prove's, then a stop after each
    phase, serialize, deserialize, resume: the pinned digest each time;
    a checkpoint with one changed message raises ResumeMismatch."""
    from stark_tpu_torch.stark import (ProverCheckpoint, StarkProof, prove,
                                       prove_resumable)
    from stark_tpu_torch.stark import prover as tprover
    from stark_tpu_torch.stark.checkpoint import PHASES, ResumeMismatch

    cfg, air = prove_setup(RESUME)
    pinned = TRANSCRIPT_SHA256[RESUME]

    def digest(pr):
        return hashlib.sha256(b"".join(pr.proof)).hexdigest()

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    drop_plans()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cold, cold_s = walled(lambda: prove_resumable(cfg, air=air, device=dev))
    peak = torch.cuda.max_memory_allocated() - base
    if tprover.LAST_PROVE_PATH != "per-phase" or digest(cold) != pinned:
        raise AssertionError(f"per-phase {RESUME} prove: path "
                             f"{tprover.LAST_PROVE_PATH}, sha256 "
                             f"{digest(cold)} != the pinned {pinned}")
    warm = [walled(lambda: prove_resumable(cfg, air=air, device=dev))[1]
            for _ in range(3)]
    single = [walled(lambda: prove(cfg, air=air, device=dev))[1]
              for _ in range(3)]
    out = {"per_phase_cold_s": round(cold_s, 3),
           "per_phase_warm_s": [round(x, 3) for x in warm],
           "single_fetch_warm_s": [round(x, 3) for x in single],
           "per_phase_peak_mib": round(peak / 2**20, 1), "stops": {}}
    for ph in PHASES:
        ckpt, stop_s = walled(lambda: prove_resumable(
            cfg, air=air, stop_after=ph, device=dev))
        if isinstance(ckpt, StarkProof):  # no boundary after the last one
            final, blob = ckpt, b""
        else:
            blob = ckpt.serialize()
            restored = ProverCheckpoint.deserialize(blob)
            if restored.serialize() != blob or restored.phase != ph:
                raise AssertionError(f"checkpoint after {ph} does not "
                                     "round-trip")
            final, _ = walled(lambda: prove_resumable(
                cfg, resume=restored, device=dev))
        if digest(final) != pinned:
            raise AssertionError(f"resumed after {ph}: sha256 "
                                 f"{digest(final)} != the pinned {pinned}")
        out["stops"][ph] = {"stop_s": round(stop_s, 3),
                            "checkpoint_bytes": len(blob)}
        log(f"resume {RESUME}: stopped after {ph} ({len(blob)} bytes "
            f"serialized), resumed to the pinned digest")
        if ph == "fri-commit":
            bad = ProverCheckpoint.deserialize(blob)
            m = bytearray(bad.proof[2])
            m[-1] ^= 1
            bad.proof[2] = bytes(m)
            try:
                prove_resumable(cfg, resume=bad, device=dev)
            except ResumeMismatch as e:
                log(f"a checkpoint with message 2 changed: ResumeMismatch "
                    f"({str(e)[:60]})")
            else:
                raise AssertionError("a corrupted checkpoint resumed")
    log(f"resume {RESUME}: {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


def phase_fri(dev) -> dict:
    """BASELINE config #3 as bench.py sets it up: fri_commit on a host
    channel and decommit_fri, FRI_RUNS times (walls of each part), the
    transcript accepted by verify_fri and refused with a byte flipped,
    the same under STARK_TPU_TORCH_HOST_QUERIES (the BatchGather loop);
    decommit_fri launches the query form exactly once."""
    from stark_tpu_torch.channel.channel import Channel, ChannelError
    from stark_tpu_torch.channel.device_query import query_chain
    from stark_tpu_torch.fields.fp import upload_u32
    from stark_tpu_torch.fri.commit import decommit_fri, fri_commit
    from stark_tpu_torch.fri.verify import FRIVerificationError, verify_fri
    from stark_tpu_torch.ntt.ntt import coset_evaluate

    n = FRI_BLOWUP << FRI_LOG_DEG
    rs = np.random.RandomState(SEED + 10)
    coeffs = upload_u32(rs.randint(0, P, size=1 << FRI_LOG_DEG,
                                   dtype=np.int64).astype(np.uint32), dev)
    evals = coset_evaluate(coeffs, P, n, FRI_OFFSET)

    def run():
        ch = Channel(P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pr = fri_commit(evals, P, FRI_OFFSET, ch, num_folds=FRI_LOG_DEG)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = query_chain.launches
        decommit_fri(FRI_QUERIES, n - 1, pr.fri_layers, pr.fri_merkles, ch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return ch, t1 - t0, t2 - t1, query_chain.launches - before

    first = run()
    runs = [run() for _ in range(FRI_RUNS)]
    for ch, _, _, launches in [first] + runs:
        if ch.proof != first[0].proof or launches != 1:
            raise AssertionError(f"FRI transcripts differ or the query form "
                                 f"launched {launches} times")
    proof = first[0].proof
    verify_fri(proof, P, n, FRI_OFFSET, FRI_LOG_DEG, FRI_QUERIES, n - 1)
    bad = list(proof)
    k = len(bad) // 2
    bad[k] = bytes([bad[k][0] ^ 1]) + bad[k][1:]
    try:
        verify_fri(bad, P, n, FRI_OFFSET, FRI_LOG_DEG, FRI_QUERIES, n - 1)
    except (FRIVerificationError, ChannelError) as e:
        log(f"FRI transcript with message {k} flipped rejected: "
            f"{type(e).__name__}")
    else:
        raise AssertionError("verify_fri accepted a tampered transcript")
    os.environ["STARK_TPU_TORCH_HOST_QUERIES"] = "1"
    try:
        host_ch, _, host_s, host_launches = run()
    finally:
        del os.environ["STARK_TPU_TORCH_HOST_QUERIES"]
    if host_ch.proof != proof or host_launches != 0:
        raise AssertionError("the BatchGather loop's FRI transcript differs")
    commit = sorted(r[1] * 1e3 for r in runs)
    decommit = sorted(r[2] * 1e3 for r in runs)
    out = {"commit_ms": [round(x, 3) for x in commit],
           "decommit_ms": [round(x, 3) for x in decommit],
           "commit_median_ms": round(statistics.median(commit), 3),
           "decommit_median_ms": round(statistics.median(decommit), 3),
           "commit_spread_ms": round(commit[-1] - commit[0], 3),
           "decommit_spread_ms": round(decommit[-1] - decommit[0], 3),
           "first_commit_ms": round(first[1] * 1e3, 3),
           "host_loop_decommit_ms": round(host_s * 1e3, 3),
           "messages": len(proof)}
    log(f"FRI config #3 (degree < 2^{FRI_LOG_DEG}, {n} points, blowup "
        f"{FRI_BLOWUP}, {FRI_QUERIES} queries): transcript verified, equal "
        f"on the BatchGather loop; {json.dumps(out)}")
    return out


def mesh_prove(name: str, mesh, dev, channel=None, peaks: bool = False):
    """One prove of `name` over `mesh` from dropped plans and contexts:
    (proof, wall s, launches, phases' {"peak_mib", "wall_ms"} when
    `peaks`, the mesh's copy counts), its transcript checked against the
    pinned single-device digest."""
    from stark_tpu_torch.stark import prove

    cfg, air = prove_setup(name)
    mx = phase_peaks() if peaks else None
    mesh.reset_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr = prove(cfg, air=air, mesh=mesh, metrics=mx, channel=channel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    digest = hashlib.sha256(b"".join(pr.proof)).hexdigest()
    if digest != TRANSCRIPT_SHA256[name]:
        raise AssertionError(f"{name} on {mesh.size} shards: sha256 "
                             f"{digest} != the pinned single-device "
                             f"{TRANSCRIPT_SHA256[name]}")
    phases = None if mx is None else {"peak_mib": mx.peaks, "wall_ms": {
        ph.name: round(ph.wall_s * 1e3, 3) for ph in mx.phases}}
    return pr, wall, launches, phases, {k: list(v) for k, v in
                                        mesh.stats.items()}


def phase_mesh(res: Results, dev, profile: bool) -> dict:
    """The sharded prove over a mesh of MESH_SHARDS logical shards on the
    card: the four-step NTT and INTT (dist_ntt / dist_intt) and the
    sharded tree (dist_merkle_tree) at 2^MESH_LOG points equal to the
    single-device K2 transform and the unpruned MerkleTree (root and
    MESH_PATHS paths), each timed beside it with the bytes the exchanges
    copied; K5's sharded query form on the MESH_PROVE mesh plan against
    its plain version; then MESH_PROVE proved on the mesh (the pinned
    single-device digest, "single-fetch-mesh", verified, a flipped byte
    rejected; cold and warm walls, phases' peaks, copies against
    dist.comm's model, every kernel of the path launched), MESH_OTHER on
    MESH_OTHER_SHARDS shards and one per-phase mesh prove of
    MESH_PER_PHASE.  With several cards, MESH_PROVE again on a mesh of
    the real devices; with one, a line says that it was not run."""
    from stark_tpu_torch.channel.channel import Channel
    from stark_tpu_torch.channel.device_query import (query_chain,
                                                      query_chain_plain)
    from stark_tpu_torch.dist import (dist_intt, dist_merkle_tree, dist_ntt,
                                      make_mesh, sharded)
    from stark_tpu_torch.dist.comm import prove_collectives, stats_bytes
    from stark_tpu_torch.fields.fp import Fp
    from stark_tpu_torch.merkle.tree import MerkleTree
    from stark_tpu_torch.ntt.cuda_ntt import ntt_k2
    from stark_tpu_torch.stark import FibonacciSquareAIR
    from stark_tpu_torch.stark import prover as tprover
    from stark_tpu_torch.stark.prover import query_plan

    t_phase = time.perf_counter()
    s = MESH_SHARDS
    mesh = make_mesh(devices=[dev] * s)
    out = {"shards": s}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    n = 1 << MESH_LOG

    # the four-step NTT against the single-device K2 transform
    x = rand_u32_dev(gen, (n,), P, dev)
    xs = sharded(mesh, x)
    for what, dist_fn, inverse in (("NTT", dist_ntt, False),
                                   ("INTT", dist_intt, True)):
        mesh.reset_stats()
        got = dist_fn(xs, P, mesh).join()
        copied = mesh.copied_bytes()
        # the four-step's row transforms are K1's batched form
        res.check("K1 batched", f"dist {what} 2^{MESH_LOG} on {s} shards "
                  "against the single-device K2 transform", got,
                  ntt_k2(x, P, inverse))
        del got
        ms = cuda_ms(lambda: dist_fn(xs, P, mesh))
        single = cuda_ms(lambda: ntt_k2(x, P, inverse))
        out[f"dist_{what.lower()}"] = {"ms": ms, "single_k2_ms": single,
                                       "copied_bytes": copied}
        log(f"mesh: dist {what} 2^{MESH_LOG} on {s} shards {ms:.4f} ms "
            f"against K2 {single:.4f} ms; {copied} bytes exchanged")
    del x, xs
    torch.cuda.empty_cache()

    # the sharded tree against the whole one
    v = rand_u32_dev(gen, (n,), P, dev)
    vs = sharded(mesh, v)
    mesh.reset_stats()
    dt = dist_merkle_tree(vs, mesh)
    st = MerkleTree(v)
    if dt.root() != st.root():
        raise AssertionError("dist tree root != the single tree's")
    rs = np.random.RandomState(SEED + 10)
    for idx in rs.randint(0, n, size=MESH_PATHS):
        if (dt.get_authentication_path(int(idx))
                != st.get_authentication_path(int(idx))):
            raise AssertionError(f"dist tree path of leaf {idx} differs")
    log(f"mesh: dist tree 2^{MESH_LOG} leaves on {s} shards: root and "
        f"{MESH_PATHS} paths equal the single tree's; "
        f"{mesh.copied_bytes()} bytes exchanged")
    del dt, st
    ms = cuda_ms(lambda: dist_merkle_tree(vs, mesh))
    single = cuda_ms(lambda: MerkleTree(v))
    out["dist_tree"] = {"ms": ms, "single_ms": single}
    log(f"mesh: dist tree {ms:.4f} ms against the single tree "
        f"{single:.4f} ms")
    del v, vs
    torch.cuda.empty_cache()

    # K5's query form over the sharded sources of the mesh plan
    cfg, air = prove_setup(MESH_PROVE)
    tb = query_plan(cfg, air, shards=s).pack(dev)
    chain = rand_u32(rs, 8, 1 << 32, dev)
    srcs = [[rand_words_dev(gen, (size, 8) if k % 2 else (size,), dev)
             for size in sizes] for k, sizes in enumerate(tb.entries)]
    got = query_chain(chain, *srcs, tb)
    want = query_chain_plain(chain, *srcs, tb)
    for what, a, b in zip(("final chain", "idxs", "vals", "digs"), got,
                          want):
        res.check("K5 sharded query", f"query form, {MESH_PROVE} plan on "
                  f"{s} shards ({sum(map(len, tb.entries))} source entries): "
                  f"{what}", a, b)
    blocks, comps = res.card.query_bound(tb)
    got = res.time("K5 sharded query", f"query form, {MESH_PROVE} plan on "
                   f"{s} shards, {tb.num_queries} queries ({blocks} blocks)",
                   lambda: query_chain(chain, *srcs, tb),
                   lambda: query_chain_plain(chain, *srcs, tb),
                   res.card.chain_bound(comps), plain_reps=1)
    unsharded = res.rows["K5"].get("query_form", {}).get(MESH_PROVE, {})
    bounds = res.card.chain_bounds_text(comps, got["ms"])
    log(f"K5 sharded query form: {bounds}; the unsharded {MESH_PROVE} plan "
        f"in this run {unsharded.get('ms')} ms")
    del srcs, got, want
    torch.cuda.empty_cache()

    # the prove at full size over the mesh: this slice's main path
    drop_plans()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cold, cold_s, launches, phases, stats = mesh_prove(MESH_PROVE, mesh,
                                                       dev, peaks=True)
    if tprover.LAST_PROVE_PATH != "single-fetch-mesh":
        raise AssertionError(f"mesh prove took {tprover.LAST_PROVE_PATH}")
    check_verifies(f"{MESH_PROVE} mesh", cfg, cold)
    for k in ("K1", "K2", "K3", "K4", "K5"):
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched in the mesh prove")
    if launches["K5 sharded query"] != 1:
        raise AssertionError(f"K5's sharded query form launched "
                             f"{launches['K5 sharded query']} times")
    tag = f"{MESH_PROVE} mesh ({s} shards)"
    for k, count in launches.items():
        res.rows[k]["launches_by_prove"][tag] = count
    res.rows["K5 sharded query"]["launches"] = launches["K5 sharded query"]
    use = air or FibonacciSquareAIR()
    model = stats_bytes(prove_collectives(
        cfg.log2_trace, cfg.blowup, s, use.num_folds(cfg),
        max(use.shifts) * cfg.blowup, use.num_columns,
        4 * Fp.get(cfg.modulus).width))
    got_bytes = {k: b for k, (_, b) in stats.items()}
    if got_bytes != model:
        raise AssertionError(f"mesh prove copied {got_bytes}, the model "
                             f"says {model}")
    warm = [mesh_prove(MESH_PROVE, mesh, dev)[1] for _ in range(MESH_WARM)]
    out["prove"] = {"cold_s": round(cold_s, 3),
                    "warm_s": [round(w, 3) for w in warm],
                    "peak_mib": max(phases["peak_mib"].values()),
                    "allocated_before_mib": round(base / 2**20, 1),
                    "phase_peak_mib": phases["peak_mib"],
                    "cold_phase_ms": phases["wall_ms"], "copies": stats,
                    "launches": launches}
    log(f"mesh prove {MESH_PROVE} on {s} shards: pinned digest, "
        f"single-fetch-mesh, verified; cold {cold_s:.3f} s, warm "
        f"{out['prove']['warm_s']} s; phases' peaks (MiB) "
        f"{json.dumps(phases['peak_mib'])}, walls (ms) "
        f"{json.dumps(phases['wall_ms'])}; copies {json.dumps(stats)} "
        f"(as dist.comm's model); launches {launches}")
    if profile:
        _, _, _, split, _ = mesh_prove(MESH_PROVE, mesh, dev, peaks=True)
        out["prove"]["warm_phase_ms"] = split["wall_ms"]
        log(f"mesh prove {MESH_PROVE} warm phase split (ms, synced): "
            f"{json.dumps(split['wall_ms'])}")
    del cold
    torch.cuda.empty_cache()

    # the other statements, and the per-phase mesh path
    small = make_mesh(devices=[dev] * MESH_OTHER_SHARDS)
    for name in MESH_OTHER:
        _, _, launches, _, _ = mesh_prove(name, small, dev)
        for k, count in launches.items():
            res.rows[k]["launches_by_prove"][
                f"{name} mesh ({MESH_OTHER_SHARDS} shards)"] = count
        log(f"mesh: {name} on {MESH_OTHER_SHARDS} shards equals its pinned "
            f"single-device digest ({tprover.LAST_PROVE_PATH}); launches "
            f"{launches}")
    ch = Channel(P)
    ch.phase_accurate = True
    mesh_prove(MESH_PER_PHASE, small, dev, channel=ch)
    if tprover.LAST_PROVE_PATH != "per-phase-mesh":
        raise AssertionError(f"phase-accurate mesh prove took "
                             f"{tprover.LAST_PROVE_PATH}")
    log(f"mesh: per-phase {MESH_PER_PHASE} on {MESH_OTHER_SHARDS} shards "
        "equals the single-fetch digest")

    cards = torch.cuda.device_count()
    if cards >= 2:
        real = make_mesh(1 << (cards.bit_length() - 1))
        _, wall, _, _, stats = mesh_prove(MESH_PROVE, real, dev)
        out["real_devices"] = {"cards": real.size, "wall_s": round(wall, 3)}
        log(f"mesh prove {MESH_PROVE} on {real.size} cards: pinned digest, "
            f"{wall:.3f} s cold")
    else:
        log("mesh: one card visible; the prove over distinct cards (peer "
            "access between them) was not run")
    torch.cuda.empty_cache()
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _spawn(target, nprocs: int, args: tuple, timeout: float,
           strict: bool = True) -> list:
    """Run target(rank, queue, *args) in `nprocs` spawned processes and
    return their results in rank order; a child that fails (its
    traceback is what it puts) or is not done within `timeout` seconds
    fails the run (without `strict`, for a probe whose answer may be a
    hang: None for each child that did not report), and every child is
    stopped before this returns."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, q) + args)
             for r in range(nprocs)]
    for pr in procs:
        pr.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            try:
                rank, ok, value = q.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue_mod.Empty:
                if not strict:
                    break
                raise AssertionError(
                    f"{len(got)} of {nprocs} processes reported within "
                    f"{timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for pr in procs:
            pr.join(timeout=30)
            if pr.is_alive():
                pr.kill()
                pr.join()
    return [got.get(r) for r in range(nprocs)]


def _child(rank: int, q, fn, *args) -> None:
    """A spawned child: fn(rank, *args) -> q, or its traceback."""
    import traceback

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        q.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the run
        q.put((rank, False, traceback.format_exc()))


def _cut_sources(tb, rank: int, ranks: int, full: bool, dev):
    """Seeded entries of the query sources of `tb` (one generator seed an
    entry, so every rank makes the same words): the block entries this
    rank would hold (the blocks and subtrees of a source run in shard
    order, MULTIPROC_SHARDS a rank) and the replicated ones, the rest
    None; with `full` every entry too (the one-launch form's sources)."""
    gen = torch.Generator(device=dev)
    mine, whole, run, e = [], [], 0, 0
    per = tb.shards // ranks
    for k, sizes in enumerate(tb.entries):
        m, w = [], []
        for size in sizes:
            rep = tb.replicated[e]
            own = rep or run // per == rank
            run = 0 if rep else (run + 1) % tb.shards
            t = None
            if own or full:
                gen.manual_seed(SEED + 300 + e)
                t = rand_words_dev(gen, (size, 8) if k % 2 else (size,), dev)
            m.append(t if own else None)
            w.append(t)
            e += 1
        mine.append(m)
        whole.append(w)
    return mine, whole


def _multiproc_rank(rank: int, port: int, backend: str) -> dict:
    """One rank of the process mesh on the card: K5's cut query form on
    the MESH_PROVE plan against its plain version (and, on rank 0, the
    one-launch form over every entry), then MESH_PROVE over the global
    mesh (cold with its phases' peaks, warm MESH_WARM times), checked,
    verified, counted.  Returns its numbers."""
    from stark_tpu_torch.channel.device_query import (
        query_chain, query_chain_cut, query_chain_cut_plain)
    from stark_tpu_torch.dist import (dist_ntt, distributed_initialize,
                                      make_mesh, multihost_prove)
    from stark_tpu_torch.dist.multihost import check_transcript_agreement
    from stark_tpu_torch.ntt.cuda_ntt import ntt_k2
    from stark_tpu_torch.stark import prover as tprover
    from stark_tpu_torch.stark.prover import query_plan

    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(dev)
    distributed_initialize(f"127.0.0.1:{port}", MULTIPROC_RANKS, rank,
                           backend=backend)
    shards = MULTIPROC_SHARDS if backend == "gloo" else 1
    mesh = make_mesh(devices=[dev] * shards, backend=backend)
    out = {"rank": rank, "mesh": repr(mesh)}
    cfg, air = prove_setup(MESH_PROVE)

    if backend == "gloo":
        # the four-step NTT at the LDE's size across the processes: this
        # rank's blocks of the single-device K2 transform, timed
        n = cfg.eval_domain_size
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 310)
        x = rand_u32_dev(gen, (n,), P, dev)
        want, k = ntt_k2(x, P, False), n // mesh.size
        mesh.reset_stats()
        got = dist_ntt(x, P, mesh)
        out["dist_ntt_bytes"] = mesh.copied_bytes()
        out["dist_ntt_err"] = max(max_abs_err(got.blocks[i],
                                              want[i * k:(i + 1) * k])
                                  for i in mesh.local)
        if out["dist_ntt_err"]:
            raise AssertionError("dist NTT across processes != K2's")
        out["dist_ntt_ms"] = cuda_ms(lambda: dist_ntt(x, P, mesh))
        del x, want, got
        # K5's cut query form against its plain version, exact
        tb = query_plan(cfg, air, shards=mesh.size).pack(dev)
        mine, whole = _cut_sources(tb, rank, MULTIPROC_RANKS, rank == 0,
                                   dev)
        chain = rand_u32(np.random.RandomState(SEED + 299), 8, 1 << 32, dev)
        got = query_chain_cut(chain, *mine, tb, mesh)
        want = query_chain_cut_plain(chain, *mine, tb, mesh)
        errs = [max_abs_err(a, b) for a, b in zip(got, want)]
        if any(errs):
            raise AssertionError(f"cut query form != plain version: {errs}")
        out["cut_err"] = max(errs)
        out["cut_blocks"] = tb.num_queries * int(tb.template.shape[0])
        if rank == 0:
            one = query_chain(chain, *whole, tb)
            errs = [max_abs_err(a, b) for a, b in zip(got, one)]
            if any(errs):
                raise AssertionError(f"cut form != one-launch form: {errs}")
        out["cut_ms"] = cuda_ms(
            lambda: query_chain_cut(chain, *mine, tb, mesh))
        t0 = time.perf_counter()
        query_chain_cut_plain(chain, *mine, tb, mesh)
        torch.cuda.synchronize()
        out["cut_plain_ms"] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            out["one_launch_ms"] = cuda_ms(
                lambda: query_chain(chain, *whole, tb))
        # its all-reduces alone: a query's slot words, summed Q times
        row = torch.zeros(tb.num_values + 8 * (int(tb.slots.shape[0])
                                               - tb.num_values),
                          dtype=torch.int32, device=dev)
        out["allreduce_ms"] = cuda_ms(lambda: [
            mesh.all_reduce_(row, None) for _ in range(tb.num_queries)])
        del mine, whole, got, want, chain, row
        torch.cuda.empty_cache()
        torch.distributed.barrier()

    # the main path: MESH_PROVE over the global mesh, counted
    base = torch.cuda.memory_allocated()
    mx = phase_peaks()
    mesh.reset_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr = multihost_prove(cfg, air=air, devices=[dev] * shards, metrics=mx,
                         check_agreement=True)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["path"] = tprover.LAST_PROVE_PATH
    out["digest"] = hashlib.sha256(b"".join(pr.proof)).hexdigest()
    if out["digest"] != TRANSCRIPT_SHA256[MESH_PROVE]:
        raise AssertionError(f"rank {rank}: sha256 {out['digest']} != the "
                             f"pinned {TRANSCRIPT_SHA256[MESH_PROVE]}")
    check_verifies(f"{MESH_PROVE} on rank {rank}", cfg, pr)
    check_transcript_agreement(pr.proof)
    # the counted prove of the model's check runs on this rank's mesh
    mesh.reset_stats()
    walls = []
    for _ in range(MESH_WARM):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = tprover.prove(cfg, air=air, mesh=mesh)
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t0, 3))
        if again.proof != pr.proof:
            raise AssertionError(f"rank {rank}: warm prove differs")
        if len(walls) == 1:
            out["stats"] = {k: list(v) for k, v in mesh.stats.items()}
    split = phase_peaks()  # one more warm prove, synced a phase at a time
    tprover.prove(cfg, air=air, mesh=mesh, metrics=split)
    out["warm_phase_ms"] = {ph.name: round(ph.wall_s * 1e3, 3)
                            for ph in split.phases}
    plan = query_plan(cfg, air, shards=mesh.size).pack(dev)
    out.update(
        cold_s=round(cold_s, 3), warm_s=walls,
        allocated_before_mib=round(base / 2**20, 1),
        phase_peak_mib=mx.peaks,
        cold_phase_ms={ph.name: round(ph.wall_s * 1e3, 3)
                       for ph in mx.phases},
        query_words=plan.num_values + 8 * (int(plan.slots.shape[0])
                                           - plan.num_values))
    torch.distributed.destroy_process_group()
    return out


def _nccl_probe_rank(rank: int, port: int) -> str:
    """One all-reduce under NCCL with both ranks on card 0: the message
    NCCL answers with (it refuses two ranks on one card)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return f"no error: all_reduce gave {float(t)}"
    except Exception as e:  # the answer is what the probe reports
        return f"{type(e).__name__}: {' '.join(str(e).split())[:400]}"


def phase_multiproc(res: Results, dev) -> dict:
    """The sharded prove across processes: MULTIPROC_RANKS spawned
    processes on the one card under gloo, MULTIPROC_SHARDS logical shards
    each (the kernels built here before they start): K5's cut query form
    on the MESH_PROVE mesh plan against its plain version and the
    one-launch sharded form (exact, timed), then MESH_PROVE over the
    global mesh on every rank: the pinned single-device digest, verified
    and tamper-rejected on each rank, agreement checked, every kernel of
    the path launched on each rank (the cut form Q + 1 times, the
    one-launch form not at all), the bytes that crossed processes summed
    over the ranks against dist.comm's model, cold and warm walls and
    each rank's phases' peaks.  Then NCCL with two ranks on the one card
    (a probe of what it answers) or, with several cards, MESH_PROVE again
    under NCCL one rank a card."""
    from stark_tpu_torch.dist.comm import prove_collectives, stats_bytes
    from stark_tpu_torch.fields.fp import Fp
    from stark_tpu_torch.stark import FibonacciSquareAIR

    t_phase = time.perf_counter()
    got = _spawn(_child, MULTIPROC_RANKS,
                 (_multiproc_rank, _free_port(), "gloo"), MULTIPROC_TIMEOUT)
    cfg, air = prove_setup(MESH_PROVE)
    use = air or FibonacciSquareAIR()
    tag = (f"{MESH_PROVE} multiproc ({MULTIPROC_RANKS} ranks x "
           f"{MULTIPROC_SHARDS} shards)")
    for r in got:
        log(f"multiproc rank {r['rank']}: {r['mesh']}; cold {r['cold_s']} "
            f"s, warm {r['warm_s']} s ({r['path']}, pinned digest, "
            f"verified, agreement checked); phases' peaks (MiB) "
            f"{json.dumps(r['phase_peak_mib'])} ({r['allocated_before_mib']} "
            f"MiB allocated before), walls (ms) "
            f"{json.dumps(r['cold_phase_ms'])}, warm walls (ms, synced) "
            f"{json.dumps(r['warm_phase_ms'])}; launches {r['launches']}; "
            f"crossed processes {json.dumps(r['stats'])}")
        launches = r["launches"]
        for k in ("K3", "K4", "K5 cut query"):
            if launches[k] == 0:
                raise AssertionError(f"{k} never launched on rank {r['rank']}")
        if launches["K1"] + launches["K2"] == 0:
            raise AssertionError(f"no NTT kernel on rank {r['rank']}")
        # "K5" counts every K5 form; the chain form is what the query
        # forms leave (the one-launch form, "K5 row messages", is 0 here)
        chain = (launches["K5"] - launches["K5 cut query"]
                 - launches["K5 row messages"])
        if chain == 0:
            raise AssertionError(f"K5's chain form never launched on rank "
                                 f"{r['rank']}")
        if (launches["K5 cut query"], launches["K5 row messages"]) != (
                cfg.num_queries + 1, 0):
            raise AssertionError(f"rank {r['rank']} launched the cut query "
                                 f"form {launches['K5 cut query']} times, "
                                 f"the one-launch form "
                                 f"{launches['K5 row messages']}")
        log(f"multiproc rank {r['rank']}: K5's chain form launched {chain} "
            f"times")
        if r["path"] != "single-fetch-mesh":
            raise AssertionError(f"rank {r['rank']} took {r['path']}")
    summed: dict = {}
    for r in got:
        for k, (_, b) in r["stats"].items():
            summed[k] = summed.get(k, 0) + b
    model = stats_bytes(prove_collectives(
        cfg.log2_trace, cfg.blowup, MESH_SHARDS, use.num_folds(cfg),
        max(use.shifts) * cfg.blowup, use.num_columns,
        4 * Fp.get(cfg.modulus).width, ranks=MULTIPROC_RANKS,
        query_words=got[0]["query_words"], num_queries=cfg.num_queries))
    if summed != model:
        raise AssertionError(f"bytes across processes {summed}, the model "
                             f"says {model}")
    log(f"multiproc: bytes that crossed processes by kind, summed over the "
        f"ranks: {json.dumps(summed)} (= dist.comm's model)")
    log(f"multiproc: dist NTT 2^{cfg.eval_domain_size.bit_length() - 1} "
        f"across the processes, each rank's blocks equal to K2's (max_abs_err "
        f"{max(r['dist_ntt_err'] for r in got)}): "
        f"{[round(r['dist_ntt_ms'], 4) for r in got]} ms on each rank, "
        f"{[r['dist_ntt_bytes'] for r in got]} bytes sent by each")
    row = res.rows["K5 cut query"]
    row["launches"] = got[0]["launches"]["K5 cut query"]
    for k in res.rows:
        res.rows[k]["launches_by_prove"][tag] = [r["launches"][k]
                                                for r in got]
    row["max_abs_err"] = max(r["cut_err"] for r in got)
    blocks = got[0]["cut_blocks"]
    bound = res.card.chain_bound(blocks)
    row.update(ms=got[0]["cut_ms"], plain_ms=got[0]["cut_plain_ms"],
               bound_ms=bound[0], bound_by=bound[1],
               shape=f"{MESH_PROVE} mesh plan on {MESH_SHARDS} shards over "
                     f"{MULTIPROC_RANKS} processes, {cfg.num_queries} "
                     f"queries ({blocks} blocks)")
    log(f"K5 cut query form: kernel on each rank "
        f"{[round(r['cut_ms'], 4) for r in got]} ms (median of {REPS}, "
        f"{cfg.num_queries + 1} launches and {cfg.num_queries} gloo "
        f"all-reduces through pinned host memory), plain "
        f"{[round(r['cut_plain_ms'], 1) for r in got]} ms, the one-launch "
        f"sharded form over every entry {got[0]['one_launch_ms']:.4f} ms, "
        f"its {cfg.num_queries} all-reduces alone "
        f"{[round(r['allreduce_ms'], 4) for r in got]} ms; "
        f"{res.card.chain_bounds_text(blocks, got[0]['cut_ms'])}")
    out = {"ranks": got, "bytes_across_processes": summed}

    cards = torch.cuda.device_count()
    if cards >= 2:
        nccl = _spawn(_child, MULTIPROC_RANKS,
                      (_multiproc_rank, _free_port(), "nccl"),
                      MULTIPROC_TIMEOUT)
        out["nccl"] = [{k: r[k] for k in ("cold_s", "warm_s",
                                          "phase_peak_mib", "stats")}
                       for r in nccl]
        log(f"multiproc under NCCL, one rank a card: pinned digest on every "
            f"rank; {json.dumps(out['nccl'])}")
    else:
        probe = _spawn(_child, 2, (_nccl_probe_rank, _free_port()),
                       NCCL_PROBE_TIMEOUT, strict=False)
        out["nccl_two_ranks_one_card"] = probe
        log(f"multiproc: one card visible, the NCCL prove (one rank a card) "
            f"was not run; NCCL with two ranks on the one card answers: "
            f"{probe}")
    log(f"multiproc phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _api_launches(res: Results, run: str, counts: dict,
                  path: str | None = None) -> None:
    """A run's launch counts in the rows' launches_by_prove.  A prove of
    `path` also gives its counts as the launches of the rows whose main
    path that is (ROW_PATH), where no prove has yet: in a run of the api
    phase alone."""
    for row, n in counts.items():
        if n:
            res.rows[row]["launches_by_prove"][run] = n
            if path is not None and ROW_PATH.get(row, PATH) == path and \
                    res.rows[row]["launches"] is None:
                res.rows[row]["launches"] = n


@contextlib.contextmanager
def native_host_hash():
    """The JAX package's wiring of its native host hash
    (stark_tpu/channel/channel.py:47-54, stark_tpu/merkle/tree.py:444-450)
    patched into the port for a measurement: the channel's absorb and the
    path check of an 8-byte leaf in C."""
    from stark_tpu_torch import native
    from stark_tpu_torch.channel import channel as chmod
    from stark_tpu_torch.merkle.tree import MerkleTree

    absorb, validate = chmod._absorb, MerkleTree.validate

    def native_validate(root_hex, proof, index, leaf_bytes, num_leaves):
        if len(leaf_bytes) == 8:
            return native.merkle_validate(root_hex.lower(), proof, index,
                                          leaf_bytes, num_leaves)
        return validate(root_hex, proof, index, leaf_bytes, num_leaves)

    chmod._absorb = native.channel_absorb
    MerkleTree.validate = staticmethod(native_validate)
    try:
        yield
    finally:
        chmod._absorb = absorb
        MerkleTree.validate = staticmethod(validate)


def phase_api(res: Results, dev) -> None:
    """The rest of the public API on the card: ``lde`` on both NTT routes
    against its plain version, ``CosetFri`` and ``Fp.inv``, the debug
    checks on the pinned 2^24 prove (its walls with the flag off and on,
    a planted non-canonical trace refused), ``profile_trace`` around a
    warm 2^24 prove, and the native host hash against hashlib with the
    2^24 proof's replay and verify timed both ways."""
    from stark_tpu_torch import native
    from stark_tpu_torch.channel import channel as chmod
    from stark_tpu_torch.fields.fp import Fp, upload_u32
    from stark_tpu_torch.fri import CosetFri
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch.ntt import lde
    from stark_tpu_torch.ntt.cuda_ntt import ntt_passes_plain
    from stark_tpu_torch.ntt.ntt import scale_pad
    from stark_tpu_torch.ntt.reference_ntt import root_of_unity
    from stark_tpu_torch.stark import FibonacciSquareAIR, prove, verify
    from stark_tpu_torch.utils import profile_trace

    t_phase = time.perf_counter()

    def at() -> str:
        return f"[api +{time.perf_counter() - t_phase:.1f} s]"

    card = card_smi()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blowup, offset = API_LDE_BLOWUP, API_LDE_OFFSET
    for log_n, row in API_LDE:
        n = 1 << log_n
        x = rand_u32_dev(gen, (n,), P, dev)
        reset_counts()
        got = lde(x, P, blowup, offset)
        torch.cuda.synchronize()
        counts = read_counts()
        if {k: v for k, v in counts.items() if v} != {row: 2}:
            raise AssertionError(f"lde 2^{log_n} launched {counts}, "
                                 f"expected {row} twice")
        _api_launches(res, f"lde 2^{log_n}", counts)

        def plain(x=x, n=n):
            coeffs = ntt_passes_plain(x, P, True)
            return ntt_passes_plain(scale_pad(coeffs, P, blowup * n, offset),
                                    P, False)

        what = f"lde 2^{log_n} -> 2^{log_n + 2}"
        res.check(row, f"{what} (blowup {blowup}, offset {offset})", got,
                  plain())
        b_inv = res.card.ntt_bound(n, True)
        b_fwd = res.card.ntt_bound(blowup * n, False)
        res.time(row, what, lambda x=x: lde(x, P, blowup, offset), plain,
                 (b_inv[0] + b_fwd[0], b_fwd[1]), row=False, other=True,
                 plain_reps=1)
        del x, got

    f = Fp.get(P)
    n = 1 << API_COSET_LOG
    w = root_of_unity(P, n)
    cf = CosetFri(P, offset, w, n, device=dev)
    dom = cf.generate_coset_domain()
    host = f.host_powers(w, n).astype(np.uint64) * np.uint64(offset) % \
        np.uint64(P)
    if not torch.equal(dom, upload_u32(host, dev)):
        raise AssertionError("CosetFri 2^26 domain != offset * w^i")
    half = host[: n // 2]
    if not torch.equal(cf.next_coset_domain(dom),
                       upload_u32(half * half % np.uint64(P), dev)):
        raise AssertionError("next_coset_domain != the first half squared")
    del dom, host, half
    x = rand_u32_dev(gen, (1 << API_INV_LOG,), P, dev)
    inv = f.inv(x)
    if not torch.equal(inv, f.pow(x, torch.full_like(inv, P - 2))) or \
            not bool((f.mul(inv, x) == (x != 0).to(torch.int64)).all()):
        raise AssertionError("Fp.inv != x^(p-2) over 2^20 values")
    log(f"{at()} CosetFri 2^{API_COSET_LOG} domain and its next domain equal "
        f"the host's; Fp.inv over 2^{API_INV_LOG} values equals "
        f"pow(x, p - 2) on the card")

    cfg, _ = prove_setup(PATH)
    was = os.environ.pop("STARK_TPU_TORCH_DEBUG", None)
    try:
        os.environ["STARK_TPU_TORCH_DEBUG"] = "1"
        reset_counts()
        t0 = time.perf_counter()
        pr = prove(cfg, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        for k, want in expected_launches(cfg, None).items():
            if counts[k] != want:
                raise AssertionError(f"{k} launched {counts[k]} times in the "
                                     f"debug {PATH} prove, expected {want}")
        _api_launches(res, f"debug {PATH}", counts, PATH)
        digest = hashlib.sha256(b"".join(pr.proof)).hexdigest()
        if digest != TRANSCRIPT_SHA256[PATH]:
            raise AssertionError(f"debug {PATH} prove: transcript sha256 "
                                 f"{digest} != {TRANSCRIPT_SHA256[PATH]}")
        check_verifies(f"debug {PATH}", cfg, pr)
        walls = {"off": [], "on": []}
        for _ in range(API_DEBUG_TURNS):
            for flag in ("off", "on", "on", "off"):
                if flag == "on":
                    os.environ["STARK_TPU_TORCH_DEBUG"] = "1"
                else:
                    os.environ.pop("STARK_TPU_TORCH_DEBUG", None)
                t0 = time.perf_counter()
                prove(cfg, device=dev)
                torch.cuda.synchronize()
                walls[flag].append(round(time.perf_counter() - t0, 4))
        os.environ["STARK_TPU_TORCH_DEBUG"] = "1"
        cfg20, _ = prove_setup("2^20")
        bad = FibonacciSquareAIR().build_trace(cfg20, device=dev)
        bad[5] = P - (1 << 32)  # the int32 storage word of p
        try:
            prove(cfg20, trace=bad, strict=False, device=dev)
        except AssertionError as e:
            if "non-canonical" not in str(e):
                raise
            log(f"{at()} planted p in the 2^20 trace refused: {e}")
        else:
            raise AssertionError("a trace holding p proved under the flag")
    finally:
        os.environ.pop("STARK_TPU_TORCH_DEBUG", None)
        if was is not None:
            os.environ["STARK_TPU_TORCH_DEBUG"] = was
    log(f"{at()} debug {PATH} prove (first, cold contexts) {first_s:.3f} s, "
        f"pinned digest, verified; launches {counts}; warm walls (s) "
        f"STARK_TPU_TORCH_DEBUG off {walls['off']} median "
        f"{statistics.median(walls['off']):.4f}, on {walls['on']} median "
        f"{statistics.median(walls['on']):.4f} ({card})")

    with profile_trace() as path:
        prove(cfg, device=dev)
        torch.cuda.synchronize()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    missing = [k for k in API_TRACE_KERNELS
               if not any(k in name for name in names)]
    if missing:
        raise AssertionError(f"the profile trace names no {missing}")
    log(f"{at()} profile_trace of a warm {PATH} prove: {path}, "
        f"{len(events)} events, naming {', '.join(API_TRACE_KERNELS)}")

    for msg in (b"", b"abc", bytes(range(256)) * 3):
        if native.sha256(msg) != hashlib.sha256(msg).digest():
            raise AssertionError(f"native sha256 of {len(msg)} bytes")
    state = ""
    for msg in pr.proof[:64]:
        nxt = native.channel_absorb(state, msg)
        if nxt != hashlib.sha256((state + msg.hex()).encode()).hexdigest():
            raise AssertionError("native channel_absorb != hashlib")
        state = nxt
    vals = np.random.RandomState(SEED).randint(
        0, P, size=1 << API_NATIVE_TREE_LOG, dtype=np.int64)
    tree = MerkleTree(upload_u32(vals, dev))
    if native.merkle_build_host(vals)[-1].hex() != tree.root():
        raise AssertionError("native merkle_build_host root != the tree's")

    def replay(absorb):
        state = ""
        for msg in pr.proof:
            state = absorb(state, msg)
        return state

    def verified():
        if not verify(pr, expected_config=cfg):
            raise AssertionError("verify rejected the proof")

    if replay(chmod._absorb) != replay(native.channel_absorb):
        raise AssertionError("native replay != hashlib replay")
    times = {"replay hashlib": [], "replay native": [],
             "verify hashlib": [], "verify native": []}
    for _ in range(API_HOST_TURNS):
        for route in ("hashlib", "native", "native", "hashlib"):
            t0 = time.perf_counter()
            replay(chmod._absorb if route == "hashlib"
                   else native.channel_absorb)
            times[f"replay {route}"].append(
                (time.perf_counter() - t0) * 1e3)
            ctx = native_host_hash() if route == "native" else \
                contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                verified()
                times[f"verify {route}"].append(
                    (time.perf_counter() - t0) * 1e3)
    log(f"{at()} native host hash equals hashlib (sha256, channel_absorb; "
        f"merkle_build_host at 2^{API_NATIVE_TREE_LOG} = the tree's root); "
        f"the {PATH} proof ({len(pr.proof)} messages) on the card's host, "
        f"ms medians: " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in times.items())
        + f" ({card})")
    log(f"api phase: {time.perf_counter() - t_phase:.1f} s")


def phase_gl_memory(dev, at_2e20: dict) -> None:
    """FibMul-GL's cold and warm walls and the cold prove's peak device
    memory at GL_MEMORY_LOGS rows and, from its prove above, 2^20: each
    deterministic and verified."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR

    table = {}
    for log2 in GL_MEMORY_LOGS:
        cfg = ProverConfig(log2_trace=log2, blowup=4, num_queries=16, **_GL)
        cold, _, cold_s, warm_s, peak, _, _, _ = timed_proves(
            cfg, FibMulAIR(**_FIBMUL), dev)
        check_verifies(f"FibMul-GL 2^{log2}", cfg, cold)
        table[f"2^{log2}"] = {"cold_s": round(cold_s, 3),
                              "warm_s": round(warm_s, 3),
                              "peak_mib": round(peak / 2**20, 1)}
    table["2^20"] = at_2e20
    log(f"FibMul-GL memory table (blowup 4, 16 queries; cold prove's peak): "
        f"{json.dumps(table)}")


def phase_anchors(dev) -> None:
    """The port's Goldilocks proves on the card against the transcript
    digests the JAX package made on a CPU (GL_ANCHORS)."""
    from stark_tpu_torch.config import ProverConfig
    from stark_tpu_torch.stark import FibMulAIR, FibonacciSquareAIR, prove

    airs = {"fib-sq-GL": FibonacciSquareAIR(a1=3141592),
            "FibMul-GL": FibMulAIR(**_FIBMUL)}
    for (statement, log2), want in GL_ANCHORS.items():
        cfg = ProverConfig(log2_trace=log2, blowup=4, num_queries=16, **_GL)
        got = hashlib.sha256(b"".join(
            prove(cfg, air=airs[statement], device=dev).proof)).hexdigest()
        if got != want:
            raise AssertionError(f"{statement} 2^{log2}: transcript sha256 "
                                 f"{got} != the JAX package's {want}")
        log(f"anchor {statement} 2^{log2}: transcript sha256 {got}, equal "
            "to the JAX package's")
    from stark_tpu_torch.stark.families import build_air

    for (statement, log2), want in FAMILY_ANCHORS.items():
        family = statement.removesuffix("-GL")
        cfg = ProverConfig(log2_trace=log2, num_queries=16,
                           blowup=8 if family.startswith("mimc5") else 4,
                           **(_GL if statement.endswith("-GL") else {}))
        air = build_air(family, family_secret(family))
        got = hashlib.sha256(b"".join(
            prove(cfg, air=air, device=dev).proof)).hexdigest()
        if got != want:
            raise AssertionError(f"{statement} 2^{log2}: transcript sha256 "
                                 f"{got} != the JAX package's {want}")
        log(f"anchor {statement} 2^{log2}: transcript sha256 {got}, equal "
            "to the JAX package's")


def phase_families(res: Results, dev) -> dict:
    """The declarative families at 2^20 rows (FAMILY_PROVES), each through
    phase_prove (cold and warm, pinned digest, verified, tamper-rejected,
    launches checked), then the Python host trace's wall on its own.
    Returns each prove's walls, peak and digest."""
    out = {}
    for name in FAMILY_PROVES:
        out[name] = phase_prove(res, dev, name)
        cfg, air = prove_setup(name)
        t0 = time.perf_counter()
        air.host_trace(cfg)
        out[name]["host_trace_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        log(f"{name}: Python AirSpec host trace {out[name]['host_trace_ms']}"
            f" ms ({cfg.trace_length} rows)")
    log(f"family proves: {json.dumps(out)}")
    return out


def _run(args, timeout=600, **kw) -> subprocess.CompletedProcess:
    """A child Python process of the port, from the checkout's root."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout,
                          **kw)


def phase_serve(families: dict) -> None:
    """The prover daemon on the card: ``python -m stark_tpu_torch serve``
    (no --cpu) as a child process, loading the kernels built above; ping,
    warm, the four family proves (one compressed) whose proofs must
    verify and equal the in-process digests, a client process that must
    not initialise CUDA, stats, shutdown (exit 0, socket removed).  The
    daemon is killed in any case."""
    import shutil
    import tempfile

    from stark_tpu_torch import serve
    from stark_tpu_torch.stark import verify

    drop_plans()  # leave the card's memory to the daemon
    tmp = tempfile.mkdtemp(prefix="stt")
    sock = os.path.join(tmp, "d.sock")
    if len(sock) > 100:  # AF_UNIX paths end at 108 bytes
        sock = os.path.relpath(sock)
    log_path = os.path.join(tmp, "daemon.log")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "stark_tpu_torch", "serve", "--socket",
             sock], env=dict(os.environ, PYTHONPATH=root), stdout=fh,
            stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while True:
            try:
                info = serve.ping(sock)
                break
            except (ConnectionError, OSError):
                if proc.poll() is not None:
                    raise AssertionError(
                        f"daemon exited rc={proc.returncode} before serving")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("daemon did not serve in 300 s")
                time.sleep(0.25)
        log(f"daemon up in {time.perf_counter() - t0:.3f} s: {info}")
        kind = torch.cuda.get_device_name(0)
        if info["platform"] != "gpu" or info["device"] != kind:
            raise AssertionError(f"daemon ping {info}: not the card {kind}")
        cfg, _ = prove_setup(FAMILY_PROVES[0])
        t0 = time.perf_counter()
        resp = serve.request({"op": "warm",
                              "config": serve._config_to_wire(cfg),
                              "air": PROVES[FAMILY_PROVES[0]][1],
                              "secret": family_secret("tribmul")}, sock)
        if not resp.get("ok") or "proof_b64" in resp:
            raise AssertionError(f"daemon warm: {resp}")
        log(f"daemon warm ({FAMILY_PROVES[0]}): {resp['wall_s']:.3f} s in "
            f"the daemon, {time.perf_counter() - t0:.3f} s round trip")
        for name in FAMILY_PROVES:
            cfg, _ = prove_setup(name)
            family = PROVES[name][1]
            t0 = time.perf_counter()
            proof = serve.daemon_prove(
                cfg, air=family, secret=family_secret(family),
                compress=name == SERVE_COMPRESSED, socket_path=sock)
            wall = time.perf_counter() - t0
            verify(proof, expected_config=cfg)
            digest = hashlib.sha256(b"".join(proof.proof)).hexdigest()
            if digest != families[name]["sha256"]:
                raise AssertionError(f"daemon {name}: transcript {digest} != "
                                     "the in-process prove's")
            packed = " (compressed container)" * (name == SERVE_COMPRESSED)
            log(f"daemon prove {name}{packed}: {wall:.3f} s round trip, "
                "verified, transcript equal to the in-process prove's")
        # a thin client: its prove verifies, and it never touches the card
        code = ("import hashlib, torch\n"
                "from stark_tpu_torch import serve\n"
                "from stark_tpu_torch.config import ProverConfig\n"
                "from stark_tpu_torch.stark import verify\n"
                f"pr = serve.daemon_prove(ProverConfig(**{_CFG20!r}), "
                f"air='tribmul', secret={family_secret('tribmul')}, "
                f"socket_path={os.path.abspath(sock)!r})\n"
                "verify(pr)\n"
                "print(hashlib.sha256(b''.join(pr.proof)).hexdigest(), "
                "torch.cuda.is_initialized())\n")
        res = _run(["-c", code])
        want = f"{families[FAMILY_PROVES[0]]['sha256']} False"
        if res.returncode != 0 or res.stdout.strip() != want:
            raise AssertionError(f"client process: rc {res.returncode}, "
                                 f"{res.stdout} {res.stderr[-2000:]}")
        log("client process: daemon prove verified, transcript equal, "
            "torch.cuda.is_initialized() False")
        stats = serve.request({"op": "stats"}, sock)
        names = {ph["name"] for ph in stats["metrics"]["phases"]}
        phases = ("trace-lde", "trace-commit", "composition", "fri-commit",
                  "queries")
        if not set(phases) <= names:
            raise AssertionError(f"daemon stats phases {sorted(names)}")
        log(f"daemon stats: {stats['proves']} proves, phases "
            f"{sorted(names)}, counters {stats['metrics']['counters']}")
        if not serve.request({"op": "shutdown"}, sock).get("ok"):
            raise AssertionError("daemon shutdown refused")
        rc = proc.wait(timeout=120)
        if rc != 0 or os.path.exists(sock):
            raise AssertionError(f"daemon exit {rc}; socket left: "
                                 f"{os.path.exists(sock)}")
        log("daemon shut down: exit 0, socket removed")
    except BaseException:
        with open(log_path) as fh:
            log("daemon log (tail):\n" + fh.read()[-4000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_cli(families: dict) -> None:
    """``python -m stark_tpu_torch prove`` on the card (no --cpu) of
    tribmul at 2^20 rows, ``verify`` of its file (exit 0) and of a copy
    with one byte flipped (exit 1, REJECTED)."""
    import shutil
    import tempfile

    from stark_tpu_torch.stark import StarkProof

    tmp = tempfile.mkdtemp(prefix="stt")
    try:
        out = os.path.join(tmp, "p.json")
        t0 = time.perf_counter()
        res = _run(["-m", "stark_tpu_torch", "prove", "--air", "tribmul",
                    "--log2-trace", "20", "--blowup", "4", "--secret",
                    str(family_secret("tribmul")), "-o", out])
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"CLI prove: rc {res.returncode}\n"
                                 f"{res.stderr[-3000:]}")
        proof = StarkProof.deserialize(open(out, "rb").read())
        digest = hashlib.sha256(b"".join(proof.proof)).hexdigest()
        if digest != families["tribmul 2^20"]["sha256"]:
            raise AssertionError(f"CLI proof transcript {digest} != the "
                                 "in-process prove's")
        log(f"CLI prove --air tribmul --log2-trace 20 --blowup 4: rc 0, "
            f"{wall:.3f} s (process included), transcript equal to the "
            f"in-process prove's; {res.stderr.strip().splitlines()[-1]}")
        res = _run(["-m", "stark_tpu_torch", "verify", out])
        if res.returncode != 0:
            raise AssertionError(f"CLI verify: rc {res.returncode}\n"
                                 f"{res.stderr[-3000:]}")
        k = len(proof.proof) // 2
        msg = bytearray(proof.proof[k])
        msg[0] ^= 1
        proof.proof[k] = bytes(msg)
        bad = os.path.join(tmp, "bad.json")
        with open(bad, "wb") as fh:
            fh.write(proof.serialize())
        res = _run(["-m", "stark_tpu_torch", "verify", bad])
        if res.returncode != 1 or "REJECTED" not in res.stderr:
            raise AssertionError(f"CLI verify of a tampered proof: rc "
                                 f"{res.returncode}\n{res.stderr[-3000:]}")
        log("CLI verify: rc 0; tampered copy (message "
            f"{k}): rc 1, REJECTED")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the phase split's step that a warm prove skips (its context is cached)
COLD_STEP = "AIR context build (cold: domain, inverses; not in a warm prove)"


def phase_split(cfg, air, dev) -> dict:
    """One prove's steps as ``prove()`` runs them, with the wall of each
    in ms (``torch.cuda.synchronize()`` after each step), then the cold
    build of the AIR's context (COLD_STEP), which a warm prove takes from
    its cache."""
    from stark_tpu_torch.channel.channel import Channel
    from stark_tpu_torch.channel.device_channel import DeviceFS, absorb_value
    from stark_tpu_torch.fields.fp import Fp, upload_u32
    from stark_tpu_torch.fri.commit import fri_commit
    from stark_tpu_torch.merkle.tree import MerkleTree
    from stark_tpu_torch.ntt import cuda_ntt
    from stark_tpu_torch.ntt.ntt import coset_evaluate
    from stark_tpu_torch.stark.air import FibonacciSquareAIR
    from stark_tpu_torch.stark.prover import (final_words, get_air_context,
                                              query_plan)
    from stark_tpu_torch.stark.trace import trace_polynomial

    wide = Fp.get(cfg.modulus).width == 2

    def kernel(n):
        if wide:
            return "torch ops"
        return "K1" if n <= 1 << cuda_ntt.MAX_LOG_N else "K2"

    out = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = round((now - t) * 1e3, 3)
        t = now

    air = air or FibonacciSquareAIR()
    p, h = cfg.modulus, cfg.offset
    plan = query_plan(cfg, air)
    host = air.host_trace(cfg)
    mark("host trace (" + ("Python AirSpec loop" if hasattr(air, "step")
                           else "native") + ")")
    trace = upload_u32(host, dev)
    mark("upload")
    coeffs = trace_polynomial(trace, p)
    mark(f"trace INTT ({kernel(cfg.trace_domain_size)}) + correction")
    lde = coset_evaluate(coeffs, p, cfg.eval_domain_size, h)
    mark(f"scale-pad + LDE NTT ({kernel(cfg.eval_domain_size)})")
    k3 = "K3 64-bit" if wide else "K3"
    if air.num_columns > 1:
        tree = MerkleTree.from_columns(lde, wide=wide,
                                       prune=plan.trace_prune)
        mark(f"trace tree ({k3} row form + K4 + tail, prune "
             f"{plan.trace_prune})")
    else:
        tree = MerkleTree(lde, wide=wide, prune=plan.trace_prune)
        mark(f"trace tree ({k3} + K4 + tail, prune {plan.trace_prune})")
    fs = DeviceFS(p, Channel(p).state, device=dev)
    fs.absorb_root(tree.root_digest)
    alphas = tuple(fs.draw() for _ in range(air.num_alphas))
    mark("FS absorb + draws (K5)")
    cp = get_air_context(air, cfg, dev).compose(
        lde, alphas, air.publics_from_host(cfg, host))
    mark("composition")
    fri = fri_commit(cp, p, h, Channel(p),
                     num_folds=len(plan.fri_lengths) - 1, fs=fs, defer=True)
    mark("FRI commit")
    last = fri.fri_layers[-1]
    fs.state = absorb_value(fs.state, *final_words(last, wide))
    dev_out = plan.run_device(fs.state, lde, tree.buffer, fri.values,
                              fri.digests)
    mark("query phase (K5 query form, pruned siblings recomputed)")
    torch.cat([x.reshape(-1).to(torch.int32)
               for x in (*fs.payloads(), last, *dev_out)]).cpu()
    mark("fetch")
    air.context(cfg, dev)
    mark(COLD_STEP)
    return out


def busy_us(events) -> float:
    """Length of the union of the events' time intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def phase_profile(dev, name: str) -> None:
    """Where a warm prove of the `name` configuration spends its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stark_tpu_torch.stark import prove

    cfg, air = prove_setup(name)
    prove(cfg, air=air, device=dev)
    for _ in range(3):
        split = phase_split(cfg, air, dev)
    warm_sum = sum(v for k, v in split.items() if k != COLD_STEP)
    log(f"{name} phase split ms (synced after each, third of 3 runs): "
        f"{json.dumps(split)}; sum of the warm steps {warm_sum:.3f}")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove(cfg, air=air, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    log(f"{name} warm prove walls ms: {[round(w, 3) for w in walls]}; "
        f"median {wall:.3f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove(cfg, air=air, device=dev)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not gpu:
        raise AssertionError("torch.profiler saw no device events")
    busy = busy_us(gpu) / 1e3
    ka = prof.key_averages()
    dev_sum = sum(e.self_device_time_total for e in ka
                  if e.device_type == DeviceType.CUDA) / 1e3
    all_sum = sum(e.self_device_time_total for e in ka) / 1e3
    log(f"{name} profiled prove: wall {prof_wall:.3f} ms; {len(gpu)} device "
        f"events; device busy {busy:.3f} ms (union of device event "
        f"intervals), sum of device rows {dev_sum:.3f} ms, sum of all rows "
        f"{all_sum:.3f} ms (host-op rows repeat their kernels' time); idle "
        f"share of the median warm wall {1 - busy / wall:.4f}")
    rows = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    for e in rows[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  "
            f"{e.key[:90]}")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    # profile_prove_2e24.txt (Fibonacci-square), _fibmul_2e24.txt, ...
    fname = "profile_prove_" + "_".join(
        ([air.name] if air else []) + ["gl"] * (cfg.modulus == GOLDILOCKS)
        + [f"2e{cfg.log2_trace}"]) + ".txt"
    with open(os.path.join(out, fname), "w") as fh:
        fh.write(ka.table(sort_by="self_device_time_total", row_limit=60,
                          max_name_column_width=90))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--profile", action="store_true",
                    help="also profile warm proves (" + ", ".join(PROFILED)
                    + ")")
    ap.add_argument("--phase", choices=("all", "multiproc", "api", "mega"),
                    default="all",
                    help="multiproc: the build, the latency probe and the "
                         "multi-process phase only; api / mega: the build "
                         "and the api / mega phase only")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs one CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import stark_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda:0")
    kind = phase_device()
    phase_build()
    card = Card()
    res = Results(card)
    for name, source, replaces in (
            ("K1", "stark_tpu_torch/csrc/ntt.cu",
             "stark_tpu/ntt/pallas_ntt.py:188 and :194"),
            ("K2", "stark_tpu_torch/csrc/ntt.cu",
             "stark_tpu/ntt/pallas_ntt.py:328 and :334 (and the XLA coarse "
             "stages :374-388)"),
            ("K3", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:100"),
            ("K4", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:124"),
            ("K4 tail", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:124 (:202, :294) for the levels "
             "of at most 2^10 nodes, which the JAX package runs as one XLA "
             "lax.scan, stark_tpu/merkle/tree.py:124 _tail_scan"),
            ("K5", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 (and, for the query form, "
             "the lax.scan of stark_tpu/channel/device_query.py:314)"),
            ("K1 batched", "stark_tpu_torch/csrc/ntt.cu",
             "stark_tpu/ntt/pallas_ntt.py:188 and :194 over (C, n) columns "
             "(stark_tpu/ntt/ntt.py:291-303)"),
            ("K2 batched", "stark_tpu_torch/csrc/ntt.cu",
             "stark_tpu/ntt/pallas_ntt.py:328 and :334 over (C, n) columns "
             "(stark_tpu/ntt/ntt.py:291-303)"),
            ("NTT 64-bit", "stark_tpu_torch/csrc/ntt64.cu",
             "no TPU kernel: the JAX package runs the Goldilocks NTT in "
             "XLA (stark_tpu/ntt/ntt.py:36-50, the four-step from 2^14); "
             "the port's torch-op ntt_limbs (stark_tpu_torch/ntt/ntt.py), "
             "its CPU route"),
            ("NTT 64-bit batched", "stark_tpu_torch/csrc/ntt64.cu",
             "no TPU kernel: the XLA four-step of stark_tpu/ntt/ntt.py:36-50 "
             "over (C, 2, n) columns (stark_tpu/ntt/ntt.py:291-303)"),
            ("K3 row form", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:100 (u32 mode) and the XLA "
             "sha256_row_leaves, stark_tpu/hash/sha256_jax.py:106"),
            ("K5 row messages", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 in the lax.scan of "
             "stark_tpu/channel/device_query.py:314 with num_columns > 1"),
            ("K3 wide", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:100 (wide=True, launched by "
             "_leaf_call :145, pallas_call :167)"),
            ("K3 wide row form", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:100 (64-bit mode) and the XLA "
             "sha256_row_leaves(..., wide=True), "
             "stark_tpu/hash/sha256_jax.py:106"),
            ("K5 pruned recompute", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 in the lax.scan of "
             "stark_tpu/channel/device_query.py:314 with the pruned trees' "
             "_subtree_sibs (:245-280)"),
            ("K3 tree batch", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:100 (:167), batched over B "
             "proofs' trees as stark_tpu/stark/batch.py:42-63 does"),
            ("K4 tree batch", "stark_tpu_torch/csrc/sha256_tree.cu",
             "stark_tpu/hash/pallas_sha.py:124 (:202, :294), batched over B "
             "proofs' trees as stark_tpu/stark/batch.py:42-63 does"),
            ("K5 chain batch", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 (:127), vmapped over B "
             "proofs in stark_tpu/stark/batch.py:165-172, 194-207"),
            ("K5 query batch", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 in the lax.scan of "
             "stark_tpu/channel/device_query.py:314, for B proofs (the JAX "
             "batch's per-proof BatchGather loops, "
             "stark_tpu/stark/batch.py:358-405)"),
            ("K5 sharded query", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 in the lax.scan of "
             "stark_tpu/channel/device_query.py:314 over a mesh's sharded "
             "sources (the JAX mesh prove ran that scan in XLA, "
             "stark_tpu/stark/prover.py:720-726)"),
            ("K5 cut query", "stark_tpu_torch/csrc/sha_chain.cu",
             "stark_tpu/hash/pallas_chain.py:80 in the lax.scan of "
             "stark_tpu/channel/device_query.py:314, cut at the query "
             "boundary for a process mesh (the JAX multi-host prove runs "
             "that scan under GSPMD, stark_tpu/dist/multihost.py:79)")):
        res.add(name, source, replaces)
    if args.phase == "api":
        phase_api(res, dev)
        return finish(res, kind, t_start, partial=True)
    if args.phase == "mega":
        phase_golden()
        phase_mega(res, dev)
        return finish(res, kind, t_start, partial=True)
    phase_latency(card, dev)
    if args.phase == "multiproc":
        phase_multiproc(res, dev)
        return finish(res, kind, t_start, partial=True)
    phase_ntt(res, dev)
    phase_ntt64(res, dev)
    phase_tree(res, dev)
    phase_tree_wide(res, dev)
    phase_tree_split(res, dev)
    phase_tree_times()
    phase_tree_chunked(res, dev)
    phase_chain(res, dev)
    phase_kernel_batches(res, dev)
    phase_golden()
    phase_mega(res, dev)
    walls = {name: phase_prove(res, dev, name) for name in PROVES
             if name not in FAMILY_PROVES}
    log("large-trace table (blowup 4, 16 queries; pruned unless named; "
        "cold prove's phases' peaks): " + json.dumps(
            {name: {k: v for k, v in walls[name].items() if k != "sha256"}
             for name in LARGE}))
    phase_api(res, dev)
    families = phase_families(res, dev)
    phase_batch(res, dev)
    phase_resume(dev)
    phase_fri(dev)
    phase_mesh(res, dev, args.profile)
    phase_multiproc(res, dev)
    phase_gl_memory(dev, {k: v for k, v in walls["FibMul-GL 2^20"].items()
                          if k != "sha256"})
    phase_anchors(dev)
    phase_serve(families)
    phase_cli(families)
    if args.profile:
        for name in PROFILED:
            phase_profile(dev, name)
    return finish(res, kind, t_start)


def finish(res: Results, kind: str, t_start: float,
           partial: bool = False) -> int:
    """The kernels line and the result line.  Every row must have been
    counted on a main path and compared with its plain version in this
    run; a `partial` run (one phase) prints only the rows it measured."""
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    rows = [r for r in res.rows.values()
            if r["launches"] is not None and r["max_abs_err"] is not None]
    left = [r["name"] for r in res.rows.values() if r not in rows]
    if left and not partial:
        raise AssertionError(f"rows neither counted on a main path nor "
                             f"compared in this run: {left}")
    if left:
        log(f"rows this phase did not measure, left out of the kernels "
            f"line: {left}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _subreaper() -> None:
    """Make this process the Linux child subreaper of what it starts, so
    that a process orphaned below it (a child's child whose parent ended)
    comes back to it and not to init, where stop_children finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):  # not Linux: children only
        pass


def _descendants() -> dict:
    """{pid: command line} of every live or unreaped process below this
    one, read from /proc."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), ()):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as fh:
                    cmd = fh.read().replace(b"\0", b" ").decode().strip()
            except OSError:
                cmd = ""
            out[pid] = cmd or "(exited, unreaped)"
            todo.append(pid)
    return out


def _reap() -> None:
    """Collect every child of this process that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_children(grace: float = 10.0) -> None:
    """Leave no process of this run behind: close the multiprocessing
    resource tracker as multiprocessing itself does (it then unlinks what
    it tracked and exits) and wait for it, then send every other process
    still below this one SIGTERM, after `grace` seconds SIGKILL, and reap
    each.  What it had to stop goes to stderr."""
    import gc
    import signal
    from multiprocessing import resource_tracker

    gc.collect()  # the spawned phases' queues: their semaphores unlinked
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        print(f"chip_smoke: closing the multiprocessing resource tracker "
              f"(pid {tracker._pid})", file=sys.stderr, flush=True)
        if hasattr(tracker, "_stop"):
            tracker._stop()
        else:  # Python 3.12 before the tracker could be stopped
            os.close(tracker._fd)
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None
    _reap()
    left = _descendants()
    if left:
        print(f"chip_smoke: stopping {len(left)} process(es) left below "
              f"this run: {left}", file=sys.stderr, flush=True)
    deadline, sig = time.monotonic() + grace, signal.SIGTERM
    while left:
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        time.sleep(0.1)
        _reap()
        left = _descendants()
        if time.monotonic() > deadline + grace:
            print(f"chip_smoke: processes that outlived SIGKILL: {left}",
                  file=sys.stderr, flush=True)
            break
        if time.monotonic() > deadline:
            sig = signal.SIGKILL


if __name__ == "__main__":
    _subreaper()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
