"""The traced run's readings: one step (or solve) of the cell's own work,
timed graphed and profiled eagerly.

CUPTI cannot trace the kernels inside a CUDA graph's conditional WHILE
nodes, so the profile runs the same call under the port's eager switch
(``solver/units._eager``: the same kernels, launched one by one, with the
host's dispatch and loop-flag reads back between them). Its device busy
time and kernel times are the device's; its idle gaps are the eager host's,
not the graphed path's. The graphed call is timed by the host clock around
a synchronize, from the same input, and the idle share is 1 - eager busy /
graphed wall, as ``chip_smoke.program_record`` (:2936-2960) takes it: it may
read below 0 when the profiler's busy time passes the graphed wall.

While the eager call runs, the four hand-written kernels' wrappers record
each launch's shape, and ``bounds.py`` gives its least time.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Dict

import numpy as np
import torch

from mpcbench import bounds

#: the hand-written kernels: wrapper (module, attribute), profiler name
KERNELS = {
    "riccati_packed": ("robot_mpcs_tpu_torch.ops.riccati_packed", "riccati_backward_packed", "riccati_packed_kernel"),
    "riccati_batched": ("robot_mpcs_tpu_torch.ops.riccati_batched", "riccati_backward_batched", "riccati_batched_kernel"),
    "fk_walk": ("robot_mpcs_tpu_torch.ops.fk_walk", "fk_walk", "fk_walk_kernel"),
    "gn_assemble": ("robot_mpcs_tpu_torch.ops.gn_assemble", "gn_assemble", "gn_assemble_kernel"),
}


def _fk_kinds(table):
    return [int(v) for v in table.define("FK_NODE")[3::3]][: table.define("FK_S")]


def _launch_bound(name: str, args, kwargs) -> float:
    """The least time (ms) of one launch, from its arguments' shapes."""
    if name == "riccati_packed":
        return bounds.sweep_bound(args[0].shape[0], kwargs["N"], kwargs["nx"], kwargs["nw"], "packed")[0]
    if name == "riccati_batched":
        A = args[5]
        return bounds.sweep_bound(args[0].shape[0], kwargs["N"], kwargs["nx"], kwargs["nw"],
                                  "batched" if A.dim() == 4 else "constant")[0]
    if name == "fk_walk":
        from robot_mpcs_tpu_torch.ops.fk_walk import walk_table

        kin, q, links, want_jac = args[:4]
        table = walk_table(kin, links)
        M = int(np.prod(q.shape[:-1]))
        return bounds.fk_bound(M, _fk_kinds(table), table.n, table.n_links, bool(want_jac))[0]
    lay = kwargs["layout"]
    B, N = args[0].shape[:2]
    nnz = (lay.S != 0).sum(1).tolist()
    return bounds.gn_bound(B, N, lay.q_seg, lay.aff_seg, lay.nx, lay.nw, lay.n_q, lay.ns, nnz)[0]


def iteration_flops(problem) -> float:
    """The flops one inner iteration needs for one lane, counted from the
    problem's shapes: the expansion (the walk with Jacobians and the
    Gauss-Newton assembly at every stage), the Riccati sweep, and one
    line-search probe's walk of positions. A lower bound of the work: the
    rows, the rollout and the multiplier updates are left out."""
    from robot_mpcs_tpu_torch.ops.fk_walk import walk_table

    d = problem.dims
    nw = d.ns + d.nu
    sweep = bounds.sweep_stage(d.nx, nw, "packed" if d.base_type == "holonomic" else "batched")[1]
    split = problem.split_callbacks()
    S = np.asarray(split["S_aff"], np.float32)
    gn = bounds.gn_stage(split["q_seg"], split["aff_seg"], d.nx, nw, split["n_q"], d.ns, (S != 0).sum(1).tolist())[1]
    table = walk_table(problem.kin, problem.walk_links)
    kinds = _fk_kinds(table)
    fk = (bounds.fk_row(kinds, table.n, table.n_links, True)[1]
          + bounds.fk_row(kinds, table.n, table.n_links, False)[1])
    return float(d.N * (sweep + gn + fk))


class _Recorder:
    """Wraps the kernel wrappers' launches while the block runs."""

    def __init__(self):
        self.bound_ms = collections.Counter()
        self._saved = []

    def __enter__(self):
        import importlib

        for name, (mod, attr, _) in KERNELS.items():
            obj = getattr(importlib.import_module(mod), attr)
            inner = obj.__wrapped__

            def wrapped(*args, _inner=inner, _name=name, **kwargs):
                out = _inner(*args, **kwargs)
                if args[0 if _name != "fk_walk" else 1].is_cuda:
                    self.bound_ms[_name] += _launch_bound(_name, args, kwargs)
                return out

            obj.__wrapped__ = wrapped
            self._saved.append((obj, inner))
        return self

    def __exit__(self, *exc):
        for obj, inner in self._saved:
            obj.__wrapped__ = inner


def _short(name: str) -> str:
    return "".join(c if c.isalnum() or c in "_:." else "_" for c in name)[:64]


def profile_call(call: Callable[[], object], device, repeats: int = 3) -> Dict:
    """Time ``call`` graphed (median of ``repeats``, host clock around a
    synchronize) and profile it once eagerly; returns the record the
    per-layer readers take."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robot_mpcs_tpu_torch.solver import units

    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        call()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t)
    with units._eager(), _Recorder() as rec, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize(device)
        eager_wall = time.perf_counter() - t
    events = list(prof.profiler.kineto_results.events())
    dev = [(e.name(), e.start_ns(), e.duration_ns()) for e in events if e.device_type() == DeviceType.CUDA]
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in events if e.device_type() == DeviceType.CPU]
    busy_ns = sum(d for _, _, d in dev)
    kernel_ms = {k: sum(d for n, _, d in dev if spec[2] in n) / 1e6 for k, spec in KERNELS.items()}
    by_name = collections.Counter()
    for n, _, d in dev:
        by_name[_short(n)] += d / 1e9
    gaps = []
    order = sorted(dev, key=lambda e: e[1])
    for (_, s0, d0), (_, s1, _) in zip(order, order[1:]):
        if s1 > s0 + d0:
            gaps.append((s1 - (s0 + d0), s0 + d0))
    gaps.sort(reverse=True)
    named = []
    if host:
        hs = np.array([h[1] for h in host])
        he = np.array([h[2] for h in host])
        for length, start in gaps[:10]:
            mid = start + length / 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            who = _short(host[cover[np.argmax(hs[cover])]][0]) if len(cover) else "no_host_operation"
            named.append([who, length / 1e9])
    return {
        "graphed_ms": statistics.median(walls) * 1e3,
        "eager_wall_ms": eager_wall * 1e3, "busy_ms": busy_ns / 1e6, "device_events": len(dev),
        "kernel_ms": kernel_ms, "kernel_bound_ms": dict(rec.bound_ms),
        "breakdown": {"device_ops": [[n, s] for n, s in by_name.most_common(10)], "idle_gaps": named},
    }
