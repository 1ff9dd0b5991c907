"""Checkpoint and resume of built scenes (PyTorch counterpart of
``grace_tpu.io.checkpoint``).

The sorted particle array and the built Tree go to a compressed .npz, so a
renderer can restart without the build pass. The format is
``grace_tpu``'s, version 1, with the same keys and dtypes, so a file
either package writes loads in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from grace_tpu_torch import convert
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.core.types import creation_device

_FORMAT_VERSION = 1


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_scene(path: str, sorted_spheres, tree: Tree, weights=None) -> None:
    arrays = dict(
        version=np.int32(_FORMAT_VERSION),
        spheres=_host(sorted_spheres),
        children=_host(tree.children),
        child_aabbs=_host(tree.child_aabbs),
        leaves=_host(tree.leaves),
        root=_host(tree.root),
        n_nodes=_host(tree.n_nodes),
        n_leaves=_host(tree.n_leaves),
        max_per_leaf=np.int32(tree.max_per_leaf),
    )
    if weights is not None:
        arrays["weights"] = _host(weights)
    np.savez_compressed(path, **arrays)


def load_scene(path: str, device=None) -> Tuple[torch.Tensor, Tree, Optional[torch.Tensor]]:
    """Returns (sorted_spheres, tree, weights-or-None) on ``device``
    (default the CUDA card)."""
    device = creation_device(device)
    data = np.load(path)
    version = int(data["version"])
    if version != _FORMAT_VERSION:
        raise IOError(f"unsupported checkpoint version {version}")
    tree = convert.tree_from_numpy(
        data["children"], data["child_aabbs"], data["leaves"], data["root"],
        data["n_nodes"], data["n_leaves"], int(data["max_per_leaf"]), device=device)
    weights = torch.from_numpy(data["weights"]).to(device) if "weights" in data else None
    return convert.spheres_from_numpy(data["spheres"], device=device), tree, weights
