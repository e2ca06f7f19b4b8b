"""Multi-process initialization over ``torch.distributed`` (port of
``robot_mpcs_tpu.parallel.distributed``).

The fleet scales by sharding its scenario batch over processes, one process
per card (``parallel/mesh.py``). Every process calls :func:`initialize` once;
after it, ``make_mesh()`` spans the process group and ``FleetRunner(...,
mesh=mesh)`` steps this process's shard. Only the step's two metric
reductions cross processes.

Rendezvous variables, in precedence order:

* ``ROBOT_MPCS_COORDINATOR`` (``host:port``), ``ROBOT_MPCS_NUM_PROCESSES``,
  ``ROBOT_MPCS_PROCESS_ID`` — the JAX package's explicit rendezvous;
* torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` (the
  analog of JAX's cluster auto-detection);
* none — single process: :func:`initialize` returns False.

A rank's device is ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` defaults to the
process id), unless the caller names one. A rank never shares a card
silently and never drops to the CPU: with fewer cards than local ranks it
raises. The backend is ``nccl`` on a CUDA device and ``gloo`` on the CPU,
unless the caller names one (``gloo`` also carries CUDA tensors for the
all-reduces the fleet runs, which lets two ranks share one card in a test).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from robot_mpcs_tpu_torch.utils.devices import resolve_device

#: this process's device once :func:`initialize` has run
_DEVICE: Optional[torch.device] = None


def _rendezvous(coordinator_address, num_processes, process_id):
    """(address, world, rank) from the arguments and the environment, or
    None when nothing names a rendezvous."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("ROBOT_MPCS_COORDINATOR")
    if num_processes is None and "ROBOT_MPCS_NUM_PROCESSES" in env:
        num_processes = int(env["ROBOT_MPCS_NUM_PROCESSES"])
    if process_id is None and "ROBOT_MPCS_PROCESS_ID" in env:
        process_id = int(env["ROBOT_MPCS_PROCESS_ID"])
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None and "RANK" in env:
            process_id = int(env["RANK"])
    if coordinator_address is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"rendezvous at {coordinator_address} needs the number of processes "
            f"and this process's id (got {num_processes}, {process_id})"
        )
    return coordinator_address, int(num_processes), int(process_id)


def _rank_device(device, process_id: int) -> torch.device:
    if device is not None:
        return resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    resolve_device("cuda")  # raises without CUDA: no silent CPU rank
    n_cards = torch.cuda.device_count()
    if local_rank >= n_cards:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({n_cards} visible); "
            f"start one process per card or pass device= explicitly"
        )
    return torch.device("cuda", local_rank)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group named by the arguments or the environment.

    Returns True once this process is in a group (also when it already was),
    False when nothing names a rendezvous (single process).
    """
    global _DEVICE
    if dist.is_initialized():
        return True
    rv = _rendezvous(coordinator_address, num_processes, process_id)
    if rv is None:
        return False
    address, world, rank = rv
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world, rank=rank
    )
    _DEVICE = dev
    barrier(dev)
    return True


def barrier(device: Optional[torch.device] = None, group=None) -> None:
    """One all-reduce of a one-element tensor on ``device`` (this process's
    device by default).

    Run right after init for the reason of the JAX package's ``_barrier``: the
    transport's context (NCCL communicators, gloo pairs) is created at the
    first collective, and pinning that to start-up, where the ranks are
    seconds apart, keeps it out of the first fleet step. Also the
    checkpoint writer's barrier, on any backend (NCCL has no CPU tensors).
    """
    if not dist.is_initialized():
        return
    one = torch.ones((1,), dtype=torch.float32, device=device or rank_device())
    dist.all_reduce(one, group=group)
    if int(one.item()) != dist.get_world_size(group):
        raise RuntimeError(f"barrier all-reduce returned {float(one.item())}")


def rank_device() -> torch.device:
    """This process's device (``initialize`` must have joined a group)."""
    if _DEVICE is None:
        raise RuntimeError("parallel.distributed.initialize() has not joined a process group")
    return _DEVICE


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
