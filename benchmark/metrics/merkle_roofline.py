"""The prove's least Merkle hashing time (every leaf and node of the
trace tree and of each FRI layer's tree once, ``roofline.py``) over the
device time of the tree kernels (sha_subtree, sha_nodes), in %."""

from benchmark import roofline
from benchmark.readers import roofline_share


def read(run: dict):
    return roofline_share(run, ("sha_subtree", "sha_nodes"),
                          roofline.merkle_least_s)
