#!/usr/bin/env python3
"""SASS instructions of a SHA-256 round in the tree kernels K3 / K4,
beside the operation count of ``chip_smoke.py``'s bound.

    cuobjdump -sass build/stark_tpu_torch/libsha256_tree-*.so > sass.txt
    python3 scripts/sass_round_count.py sass.txt

The rounds are unrolled and the compiler hoists the round constants, so
rounds have no boundary in the listing.  So this counts each kernel's
32-bit integer instructions (funnel shifts and shifts, LOP3, the adds on
either pipe), divides them by its rounds (64 a compression: K3's leaf
one compression, a node two) and prints that beside the count the
bound uses for the same kernel over the same rounds: for a node
``chip_smoke.SHA_OPS`` for its data block and ``SHA_PAD_OPS`` for its
constant padding block, for a leaf of each form sha_subtree<C, WIDE> of
K3 ``sha_leaf_ops(C, WIDE)``, which leaves out what its constant message
words fold away.  K4's ``sha_nodes`` holds one node; each form of
``sha_subtree`` one leaf (none at C = 0, the tail's digest input) and
one node (its node levels), if the compiler copies neither.  One JSON
line a kernel.
"""

import json
import os
import re
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import SHA_OPS, SHA_PAD_OPS, sha_leaf_ops  # noqa: E402

FUNC = re.compile(r"Function : (\S+)")
LEAF = re.compile(r"sha_subtreeILi(\d)ELb([01])E")  # sha_subtree<C, WIDE>
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"[^;]*;")
# the 32-bit integer work of the rounds and the schedule
ALU = ("SHF.R.W.U32", "SHF.R.U32.HI", "LOP3.LUT", "IADD3", "IMAD.IADD",
       "IMAD.U32", "VIADD")


def kernels(lines) -> dict:
    """{mangled name: Counter of opcodes}."""
    out, name = {}, None
    for line in lines:
        m = FUNC.search(line)
        if m:
            name = m.group(1)
            out[name] = Counter()
        elif name is not None:
            m = INSN.search(line)
            if m:
                out[name][m.group(1)] += 1
    return out


def main() -> int:
    with open(sys.argv[1]) as fh:
        found = kernels(fh.readlines())
    for name, ops in found.items():
        if "sha_nodes" in name:
            compressions, model = 2, SHA_OPS + SHA_PAD_OPS
        elif LEAF.search(name):
            c, wide = LEAF.search(name).groups()
            leaf = int(c) > 0
            compressions = leaf + 2
            model = (leaf and sha_leaf_ops(int(c), wide == "1")) + (
                SHA_OPS + SHA_PAD_OPS)
        else:
            continue
        alu = sum(ops[k] for k in ALU)
        rounds = 64 * compressions
        print(json.dumps({
            "kernel": name, "instructions": sum(ops.values()),
            "integer_alu": alu, "alu_by_opcode": {k: ops[k] for k in ALU},
            "rounds": rounds, "alu_per_round": round(alu / rounds, 3),
            "bound_ops": model, "bound_ops_per_round":
                round(model / rounds, 3),
            "alu_over_bound_ops": round(alu / model, 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
