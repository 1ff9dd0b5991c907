"""Multi-process bring-up (PyTorch counterpart of
``grace_tpu.parallel.multihost``).

One process a card. The pieces a multi-process run needs:

  1. ``initialize``: ``torch.distributed.init_process_group``, NCCL on the
     card; gloo only when the caller asks for the CPU. Without a card and
     without that request it raises: it never falls back.
  2. ``global_mesh``: the ("rays", "space") mesh of the sharding module
     over every process of the group.
  3. ``host_local_to_global`` / ``global_to_host_local``: between a global
     tensor and this rank's block of it, in the order of JAX's
     ``PartitionSpec`` over the mesh axes (rays-major for
     ``P(("rays", "space"))``).
  4. ``process_allgather``: small per-process values from every process.
  5. ``load_gadget_shard_for_process``: this process's contiguous range of
     a Gadget-2 snapshot's gas particles.

Testing recipe (no card needed): N processes on the CPU, each calling
``initialize("file:///<dir>/store", N, i, backend="gloo")`` (or a
``localhost:<port>``), then ``global_mesh(n_rays, n_space,
device_type="cpu")``; see tests/helper/parallel_worker.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.io.gadget import read_gadget_gas_shard
from grace_tpu_torch.parallel.sharding import AXES, make_mesh


class P(tuple):
    """The sharding of a tensor's leading axis over mesh axes, as JAX's
    ``PartitionSpec``: ``P(("rays", "space"))`` (blocks in rays-major
    order), ``P("space")``, ``P("rays")`` or ``P()`` (replicated)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    @property
    def axes(self) -> tuple:
        first = self[0] if self else None
        if first is None:
            return ()
        axes = (first,) if isinstance(first, str) else tuple(first)
        if any(a not in AXES for a in axes) or list(axes) != sorted(axes, key=AXES.index):
            raise ValueError(f"unsupported partition spec {self!r}")
        return axes


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_ids: Optional[list] = None, backend: Optional[str] = None) -> None:
    """Bring up the process group (once a process; a second call with the
    same world and rank does nothing).

    ``coordinator_address`` is "host:port" (TCP rendezvous) or a URL such
    as "file:///path/store". ``backend`` None means NCCL on the card this
    process drives: ``local_device_ids[0]`` if given, else ``process_id``
    modulo the cards present; it raises when no card is present. Pass
    ``backend="gloo"`` to run the ranks on the CPU."""
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: no CUDA card for NCCL; pass "
                               "backend='gloo' to run the ranks on the CPU")
        backend = "nccl"
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) == (num_processes, process_id):
            return
        raise RuntimeError("multihost.initialize: the process group is already up with "
                           f"world {dist.get_world_size()}, rank {dist.get_rank()}")
    kwargs = {}
    if backend == "nccl":
        card = local_device_ids[0] if local_device_ids else process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
        kwargs["device_id"] = torch.device("cuda", card)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, **kwargs)


def global_mesh(n_rays_axis: int, n_space_axis: int = 1, device_type: str = "cuda"):
    """("rays", "space") mesh over every process of the group (one card
    each; ``make_mesh`` over the group, which raises ValueError when the
    mesh needs more processes than the group has). Lay "space" over ranks
    of one host where possible: the ring's shifts then stay on the host's
    links and only the wrap-around crosses hosts."""
    return make_mesh(n_rays_axis, n_space_axis, device_type)


def _map(fn, spec, tree):
    """``fn(spec, leaf)`` over the tensors of ``tree`` (tensors, Rays,
    tuples, lists); ``spec`` is a ``P`` for every leaf or a tuple/list of
    them matching ``tree``'s top level, as JAX's spec prefixes."""
    if not isinstance(spec, P):
        return type(tree)(_map(fn, s, t) for s, t in zip(spec, tree, strict=True))
    if isinstance(tree, Rays):
        return Rays(*(fn(spec, t) for t in (tree.origins, tree.directions, tree.lengths)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, spec, t) for t in tree)
    return fn(spec, torch.as_tensor(tree))


def _gather_axis(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.size(AXES.index(axis)))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts)


def _block_of(mesh, axes) -> tuple:
    """(this rank's block, the number of blocks) along ``axes``."""
    coord = dict(zip(AXES, mesh.get_coordinate()))
    k, n = 0, 1
    for a in axes:
        size = mesh.size(AXES.index(a))
        k, n = k * size + coord[a], n * size
    return k, n


def host_local_to_global(mesh, spec, local_pytree):
    """The global tensors from every rank's block (equal blocks; gathered
    over "space", then over "rays", so ``P(("rays", "space"))`` comes out
    rays-major). Replicated leaves (``P()``) are returned as they are."""
    def gather(sp, x):
        for axis in reversed(sp.axes):
            x = _gather_axis(mesh, x, axis)
        return x

    return _map(gather, spec, local_pytree)


def global_to_host_local(mesh, spec, global_pytree):
    """This rank's block of each global tensor (the inverse of
    ``host_local_to_global``); replicated leaves whole."""
    def block(sp, x):
        if not sp.axes:
            return x
        k, n = _block_of(mesh, sp.axes)
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not split into {n} blocks")
        per = x.shape[0] // n
        return x[k * per:(k + 1) * per]

    return _map(block, spec, global_pytree)


def process_allgather(pytree):
    """Every process's value of each tensor, stacked on a new leading axis
    in rank order (small values: the result-check path)."""
    def gather(_, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts)

    return _map(gather, P(), pytree)


def load_gadget_shard_for_process(path: str, process_id: Optional[int] = None,
                                  num_processes: Optional[int] = None) -> np.ndarray:
    """This process's contiguous gas-particle shard of a Gadget-2 snapshot
    (``io.gadget.read_gadget_gas_shard``), f32[n_local, 4]; rank and world
    size default to the process group's. Concatenated in rank order the
    shards are the whole snapshot."""
    pid = dist.get_rank() if process_id is None else process_id
    n = dist.get_world_size() if num_processes is None else num_processes
    return read_gadget_gas_shard(path, pid, n)
