"""Tracing / profiling utilities (port of ``robot_mpcs_tpu.utils.profiling``).

* :func:`trace` — context manager writing a ``torch.profiler`` Chrome trace
  (viewable in Perfetto or ``chrome://tracing``) of any region, e.g. one
  fleet step or one planner solve.
* :class:`StepTimer` — wall-clock percentiles for a steady-state loop.
* :func:`timed` — one-shot timer for microbenchmarks that waits for the
  card (``torch.cuda.synchronize``) once the process has used CUDA.

Per-solve iteration counts ride the metrics path instead:
``SolveResult.iterations`` and ``FleetMetrics.mean_iterations`` /
``max_iterations``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, List

import torch

__all__ = ["trace", "timed", "StepTimer"]


def _wait() -> None:
    """Wait for queued device work (the ``block_until_ready`` of the JAX
    version) once the process has used CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the enclosed region (CPU, and CUDA where available) and write
    a Chrome trace to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _wait()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed(fn: Callable, *args, reps: int = 1, **kwargs):
    """Run ``fn`` once for warmup, then time ``reps`` calls.

    Returns ``(last_result, seconds_per_call)``. Waits for the device once
    the process has used CUDA, so device work is fully attributed.
    """
    out = fn(*args, **kwargs)
    _wait()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    _wait()
    return out, (time.perf_counter() - t0) / max(reps, 1)


class StepTimer:
    """Wall-clock percentile tracker for a steady-state control loop. Once the
    process has used CUDA, each interval ends with ``torch.cuda.synchronize()``
    so that queued device work is counted in its own step."""

    def __init__(self) -> None:
        self._samples: List[float] = []
        self._t0: float | None = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        _wait()
        self._samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    def _quantile(self, q: float) -> float:
        if not self._samples:
            return float("nan")
        s = sorted(self._samples)
        idx = min(int(q * (len(s) - 1) + 0.5), len(s) - 1)
        return s[idx]

    @property
    def count(self) -> int:
        return len(self._samples)

    def summary(self) -> dict:
        """p50/p95/max/mean step latency in milliseconds."""
        if not self._samples:
            return {"count": 0}
        return {
            "count": len(self._samples),
            "p50_ms": 1000.0 * self._quantile(0.5),
            "p95_ms": 1000.0 * self._quantile(0.95),
            "max_ms": 1000.0 * max(self._samples),
            "mean_ms": 1000.0 * sum(self._samples) / len(self._samples),
        }
