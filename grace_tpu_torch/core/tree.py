"""BVH tree container (PyTorch counterpart of ``grace_tpu.core.tree``).

Flat SoA tensors padded to static capacities:

  children    i32[Cap, 2]        left/right child of each internal node. A
                                 child c >= 0 is an internal node index;
                                 c < 0 encodes leaf index ``~c``.
  child_aabbs f32[Cap, 2, 2, 3]  per (node, child, {min,max}, xyz) boxes.
  leaves      i32[CapL, 2]       (first_primitive, count) per leaf.
  root        i32[]              root node index (not necessarily 0).
  n_nodes     i32[]              number of valid internal nodes (<= Cap).
  n_leaves    i32[]              number of valid leaves (<= CapL).
  max_per_leaf int               max primitives per leaf.

Padding nodes/leaves have empty AABBs ([+inf, -inf]) and count 0.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class Tree:
    children: torch.Tensor      # i32[Cap, 2]
    child_aabbs: torch.Tensor   # f32[Cap, 2, 2, 3]
    leaves: torch.Tensor        # i32[CapL, 2]
    root: torch.Tensor          # i32[]
    n_nodes: torch.Tensor       # i32[]
    n_leaves: torch.Tensor      # i32[]
    max_per_leaf: int

    @property
    def capacity(self) -> int:
        """Static capacity of the internal-node arrays."""
        return self.children.shape[0]

    @property
    def leaf_capacity(self) -> int:
        return self.leaves.shape[0]

    def replace(self, **kw) -> "Tree":
        return replace(self, **kw)

    def to(self, device) -> "Tree":
        return Tree(self.children.to(device), self.child_aabbs.to(device),
                    self.leaves.to(device), self.root.to(device),
                    self.n_nodes.to(device), self.n_leaves.to(device),
                    self.max_per_leaf)


def is_leaf_child(child: torch.Tensor) -> torch.Tensor:
    """True where an entry of ``Tree.children`` refers to a leaf."""
    return child < 0


def leaf_index(child: torch.Tensor) -> torch.Tensor:
    """Decode a leaf child entry (c < 0) to its leaf-array index."""
    return torch.bitwise_not(child)


def encode_leaf_child(leaf_idx: torch.Tensor) -> torch.Tensor:
    """Encode leaf index as a ``Tree.children`` entry."""
    return torch.bitwise_not(leaf_idx)
