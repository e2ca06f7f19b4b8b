"""The 1-D batch "mesh": scenario-batch sharding over processes (port of
``robot_mpcs_tpu.parallel.mesh``).

Solves are independent across scenarios, so the layout is the JAX package's
``('batch',)`` mesh: every batched array is split on its leading axis, rank
``r`` of ``W`` holding the contiguous rows ``[r*B/W, (r+1)*B/W)`` on its own
device. Here a mesh is one process per device (``parallel/distributed.py``),
not one process over many devices, so a rank's arrays are ordinary tensors
of the local batch and the only cross-rank traffic is what callers reduce
or gather explicitly.

Every rank builds the same host arrays (e.g. a scenario from a shared seed)
and keeps its slice, as the JAX package's ``make_global_array`` assumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from robot_mpcs_tpu_torch.utils.devices import resolve_device


@dataclass(frozen=True)
class Mesh:
    """World size, this process's rank and device, and the process group
    (None: no group, so nothing crosses processes)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def local_slice(self, batch: int) -> slice:
        if batch % self.world:
            raise ValueError(f"batch {batch} not divisible by mesh size {self.world}")
        b = batch // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def make_mesh(device=None) -> Mesh:
    """A mesh over the initialized process group (its world size, this
    rank, the rank's device), or of world 1 on ``device`` (the card by
    default) when no group exists."""
    if dist.is_available() and dist.is_initialized():
        from robot_mpcs_tpu_torch.parallel.distributed import rank_device

        dev = resolve_device(device) if device is not None else rank_device()
        return Mesh(dist.get_world_size(), dist.get_rank(), dev, dist.group.WORLD)
    return Mesh(1, 0, resolve_device(device if device is not None else "cuda"))


def _map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's shard of a pytree (NamedTuple, dict, list) of
    host-replicated ``[B, ...]`` arrays or tensors, on the mesh's device.
    0-d leaves (e.g. a step counter) are replicated."""

    def shard(a):
        t = torch.as_tensor(a)
        if t.dim() == 0:
            return t.to(mesh.device)
        return t[mesh.local_slice(t.shape[0])].to(mesh.device)

    return _map(shard, tree)


def gather_batch(mesh: Mesh, tree):
    """The full batch of a pytree of ``[B/W, ...]`` shards, as numpy arrays
    on every rank (rank order is batch order). 0-d leaves are taken from
    this rank. Without a process group it is the local arrays in numpy."""

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    local = _map(host, tree)
    if mesh.group is None:
        return local
    # objects, not tensors: gloo gathers no CUDA tensors and NCCL no CPU ones
    parts = [None] * mesh.world
    dist.all_gather_object(parts, local, group=mesh.group)
    leaves = [_leaves(p) for p in parts]
    it = iter(
        a if a.ndim == 0 else np.concatenate([p[i] for p in leaves], 0)
        for i, a in enumerate(leaves[mesh.rank])
    )
    return _map(lambda _: next(it), local)


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def pad_batch_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the mesh size."""
    n = mesh.world
    return ((batch_size + n - 1) // n) * n
