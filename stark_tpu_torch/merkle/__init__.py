"""Merkle commitment over field-element codewords (K3 leaves, K4 nodes)
and its host oracles."""

from stark_tpu_torch.merkle.tree import MerkleTree, merkle_root_host

__all__ = ["MerkleTree", "merkle_root_host"]
