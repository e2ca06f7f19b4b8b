"""Arithmetic shared by the per-layer readers of ``metrics/``.

A reader gets the run's record: ``kind`` ("fleet" or "planner"),
``times_s`` (each step's or solve's host time in the window), ``enqueue_s``
(the fleet's step calls, to their return), ``totals`` (attempted,
converged, failed, iterations: the program's counts over the window),
``profile`` (``trace.profile_call``'s record of one step or solve, traced
runs only) and ``iteration_flops`` (``trace.iteration_flops``). A reader
that finds nothing to read returns None, and the metric is left out.
"""

from __future__ import annotations

import statistics

from mpcbench import bounds


def _profile(rec):
    return rec.get("profile")


def roofline(rec, kernel: str):
    """A kernel's share of its roofline, %: the least time of its launches
    in the profiled call over their device time."""
    p = _profile(rec)
    if not p or not p["kernel_ms"].get(kernel) or not p["kernel_bound_ms"].get(kernel):
        return None
    return 100.0 * p["kernel_bound_ms"][kernel] / p["kernel_ms"][kernel]


def hand_kernel_busy_share(rec):
    p = _profile(rec)
    if not p or not p["busy_ms"]:
        return None
    return 100.0 * sum(p["kernel_ms"].values()) / p["busy_ms"]


def idle_share(rec):
    p = _profile(rec)
    if not p or not p["device_events"]:
        return None
    return 100.0 * (1.0 - p["busy_ms"] / p["graphed_ms"])


def device_events(rec):
    p = _profile(rec)
    return float(p["device_events"]) if p and p["device_events"] else None


def iterations_per_solve(rec):
    t = rec["totals"]
    if t.get("iterations") is None or not t["attempted"]:
        return None
    return t["iterations"] / t["attempted"]


def step_mfu(rec):
    """The profiled call's share of the card's float32 peak, %: the solver's
    iterations in it (the window's mean per solve, times the lanes) times
    ``iteration_flops``, over the graphed call's wall."""
    p, its = _profile(rec), iterations_per_solve(rec)
    if not p or its is None or not rec.get("iteration_flops"):
        return None
    flops = rec["batch"] * its * rec["iteration_flops"]
    return 100.0 * flops / (p["graphed_ms"] * 1e-3 * bounds.FP32_FLOPS)


def median_ms(values):
    return 1e3 * statistics.median(values) if values else None


def percentile_ms(values, q: float):
    """The q-th percentile (numpy's linear one) of every value, in ms."""
    import numpy as np

    return 1e3 * float(np.percentile(np.asarray(values, float), q)) if len(values) else None
