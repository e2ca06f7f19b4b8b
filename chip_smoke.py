#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``robot_mpcs_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit from ``nvidia-smi``; no CUDA
   device (or no port package beside this script) exits non-zero.
2. build: both CUDA sources (``csrc/riccati_packed.cu``,
   ``csrc/riccati_batched.cu``, each including ``csrc/riccati_common.cuh``)
   compiled at once, one ``nvcc`` each, with each instantiation's
   registers, spills and shared memory (``-Xptxas -v``) printed.
3. kernels, each held against its plain PyTorch version on the same CUDA
   tensors, the structured sweep at rtol 2e-3 / atol 2e-5, the general one
   at rtol 2e-3 / atol 2e-4 (``tests/test_riccati_pallas.py:70-75``):

   * at every shape the main paths launch them at (``PACKED_SHAPES``:
     panda's and pointRobot's phase 1 and rescue tier, alone and in the
     group, and their planners' B=1; ``GENERAL_SHAPES``: boxer's phase 1,
     planner (B=1) and rescue tier, boxer at
     B=4096 with per-lane and batch-constant A/B, (14, 7, 20) at B=4096),
     each also timed and printed as a ``kernel_shape`` line;
   * the structured sweep at the test dims (3, 0, 6), (3, 1, 5) and panda
     with a slack column (nw=8); a NaN-poisoned lane must be the only
     failed lane;
   * the general sweep at (nx, nw, N, B) = (6, 3, 5, 5), (14, 7, 20, 64)
     and (8, 3, 10, 64); a lane with negative-definite ``lww`` and a
     NaN-poisoned lane must each fail alone, the first with all-zero gains.

   A kernel's time (``ms``) is its device time per launch from
   ``torch.profiler`` over 20 launches; ``call_ms`` and ``plain_ms`` are
   CUDA events around one wrapper call (host launch path included), median
   after warm-up. Each kernel's bound is the larger of its bytes over
   3.35 TB/s and its fp32 flops over 67 TFLOP/s. The kernels line carries
   each kernel at its phase-1 shape (panda B=4096; boxer B=1024).
4. panda path: the panda fleet (``examples/config/pandaMpc.yaml`` with the
   fleet benchmark's repulsion weight), B=4096 random scenarios from seed 0,
   through ``FleetRunner(..., device="cuda")`` for 6 closed-loop steps with
   the default rescue tier and kick. The structured kernel's launch count
   must grow, every metric must be finite and the last step's converged
   fraction must be >= 0.9 (a floor under the 0.956-0.971 the JAX package
   reaches). Launches per step are printed by kernel and batch size. Two
   more steps then split the step's wall time into phase-1 solve,
   rescue-tier solve and the rest, and one step under ``torch.profiler``
   gives the device's busy time, kernel count and idle share.
5. group path: ``FleetGroup`` of pointRobot 1024, panda 2048 and boxer 1024
   lanes (``mixed_fleet_scenarios(seed=0)`` with bench.py's per-class
   samplers and weights) for 5 closed-loop steps (launches per step printed
   by kernel and batch size). Both kernels' launch counts must grow (the
   structured one from panda and pointRobot, the general one from boxer),
   every per-class metric must be finite and each class's last-step
   converged fraction >= 0.9. Prints each class's
   synchronized wall time per step, one profiled group step, and one
   profiled call of the solver's diff-drive Jacobians (forward-mode
   autodiff, ``dynamics_jacobians``).
6. planner path: the single-robot receding-horizon planner (``MPCPlanner``
   with ``KinematicSim``, ``FreeSpaceDecomposition``, ``GlobalPlanner``) on
   the card, each run read with its own launch counts (set to 0 before it):
   panda reaching a workspace goal (<= 150 solves, goal within 0.05 m),
   pointRobot around a sphere (<= 250 solves, goal within 0.15 m, clearance
   > -0.05 m) and boxer through lidar free-space half-planes (40 solves);
   every exit flag >= 0, every launch at B=1. Prints per-solve wall ms (p50 /
   p90 / max of solves 2..., the first apart), launches per solve
   (``planner_launches``) and one profiled solve each. The first 10 solves
   of each run are repeated by a ``device="cpu"`` planner
   from the same observations, half-planes and warm starts: flags equal,
   actions within 1e-3 (2 x tol_stationarity where the two solves took a
   different number of inner iterations, see ``PLANNER_ATOL``), converged
   true costs within 1e-5 relative. ``solve_batch`` of 64 perturbed panda
   observations equals 64 B=1 solves (flags, z under the same bars). The
   global planner's obstacle enlargement on the card equals the CPU's on a
   seeded 128 x 128 map, and A* finds a path on it.
7. reference: 64 lanes solved on the card and on the CPU (plain Riccati
   versions), for panda and for boxer: exit flags agree on >= 60 of 64,
   true costs of lanes both converge within 1e-4 relative, converged
   violation <= 1e-4.

Output: the kernels JSON line (each kernel's ``launches`` from the panda
fleet and the group), then the card's ``name, power.limit`` line, then the
result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 4096
STEPS = 6
GROUP_STEPS = 5
PANDA_SAMPLER = dict(
    goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 1.0)),
    obstacle_box=((-0.8, -0.8, 0.2), (0.8, 0.8, 1.0)),
    reachable_goals=True,
)
#: bench.py:48-77 per-class samplers (the weights are in the config dicts)
GROUP_SAMPLERS = {
    "pointRobot": dict(
        goal_box=((-2.0, -2.0, 0.05), (2.0, 2.0, 0.05)),
        obstacle_box=((-1.5, -1.5, 0.05), (1.5, 1.5, 0.05)),
    ),
    "panda": PANDA_SAMPLER,
    "boxer": dict(
        goal_box=((-2.0, -2.0, 0.0), (2.0, 2.0, 0.0)),
        obstacle_box=((5.0, 5.0, 0.0), (6.0, 6.0, 0.0)),
    ),
}
GROUP_SIZES = {"pointRobot": 1024, "panda": 2048, "boxer": 1024}
#: the shapes the main paths launch the structured kernel at, (B, N, n, ns):
#: each fleet's phase 1 at full width and its rescue tier at 1/8 width, and
#: the single-robot planner's B=1
PACKED_SHAPES = {
    "panda phase 1": (BATCH, 20, 7, 0),
    "panda planner": (1, 20, 7, 0),
    "pointRobot planner": (1, 20, 3, 0),
    "panda rescue": (BATCH // 8, 20, 7, 0),
    "group panda phase 1": (GROUP_SIZES["panda"], 20, 7, 0),
    "group panda rescue": (GROUP_SIZES["panda"] // 8, 20, 7, 0),
    "group pointRobot phase 1": (GROUP_SIZES["pointRobot"], 20, 3, 0),
    "group pointRobot rescue": (GROUP_SIZES["pointRobot"] // 8, 20, 3, 0),
}
#: ... and the general kernel, (B, N, nx, nw, per-lane A/B): boxer's phase 1,
#: its planner (B=1) and rescue tier, then boxer at B=4096 with per-lane and batch-constant
#: A/B, and (14, 7) with per-lane A/B (no robot model runs it)
GENERAL_SHAPES = {
    "group boxer phase 1": (GROUP_SIZES["boxer"], 10, 8, 2, True),
    "boxer planner": (1, 10, 8, 2, True),
    "group boxer rescue": (GROUP_SIZES["boxer"] // 8, 10, 8, 2, True),
    "boxer B=4096": (BATCH, 10, 8, 2, True),
    "boxer B=4096 batch-constant": (BATCH, 10, 8, 2, False),
    "(14, 7) B=4096": (BATCH, 20, 14, 7, True),
}
RTOL, ATOL = 2e-3, 2e-5
GEN_RTOL, GEN_ATOL = 2e-3, 2e-4
#: H100 SXM datasheet peaks: HBM bytes/s, fp32 flop/s
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def random_sweep_inputs(B, N, nx, nw, seed=0):
    """Random SPD stage data (tests/test_riccati_packed.py:34-46)."""
    rng = np.random.default_rng(seed)

    def spd(sz, scale):
        M = rng.normal(size=(B, N, sz, sz)).astype(np.float32)
        return scale * (M @ M.transpose(0, 1, 3, 2)) + np.eye(sz, dtype=np.float32)

    lx = rng.normal(size=(B, N, nx)).astype(np.float32)
    lw = rng.normal(size=(B, N, nw)).astype(np.float32)
    lxx, lww = spd(nx, 0.1), spd(nw, 0.1)
    lxw = 0.1 * rng.normal(size=(B, N, nx, nw)).astype(np.float32)
    reg = np.full((B,), 1e-6, np.float32)
    return lx, lw, lxx, lxw, lww, reg


def random_general_inputs(B, N, nx, nw, batched_dyn=True, seed=0):
    """Random LQR data with dynamics Jacobians (tests/test_riccati_pallas.py:18-37):
    ``(lx, lw, lxx, lxw, lww, A, Bm, reg)``, A/Bm per lane or, with
    ``batched_dyn=False``, one (N, ...) block for the batch; stage N-1 has
    A = B = 0."""
    lx, lw, lxx, lxw, lww, reg = random_sweep_inputs(B, N, nx, nw, seed)
    rng = np.random.default_rng(seed + 1)
    lead = (B, N) if batched_dyn else (N,)
    A = np.eye(nx, dtype=np.float32) + 0.05 * rng.normal(size=lead + (nx, nx)).astype(np.float32)
    Bm = 0.1 * rng.normal(size=lead + (nx, nw)).astype(np.float32)
    A[..., -1, :, :] = 0.0
    Bm[..., -1, :, :] = 0.0
    return lx, lw, lxx, lxw, lww, A, Bm, reg


def sweep_bound(B, N, nx, nw, dyn):
    """(bound_ms, bound_by) of one Riccati sweep: each input read once, each
    output written once, against the flops of the kernel's arithmetic.
    ``dyn``: "packed" (A/B baked in), "batched" (per-lane A/B) or "constant"
    (one (N, ...) A/B block)."""
    words = nx + nw + nx * nx + nx * nw + nw * nw + nw + nw * nx  # stage in + gains out
    m = 1 + nx
    solve = 2 * nw ** 3 // 3 + 2 * nw * nw * m
    if dyn == "packed":
        n = nx // 2
        flops = 3 * nx * nx + 5 * nx * n + 3 * n * n + solve + nx * (nx + 1) * nw + 2 * nx * nw
    else:
        words += (nx * nx + nx * nw) if dyn == "batched" else 0
        flops = (
            4 * nx ** 3 + 4 * nx * nx * nw + 2 * nx * nw * nw + 2 * nx * nx + 2 * nx * nw
            + solve + 2 * nw * nw * m + 6 * nx * nw + 6 * nw * nx * (nx + 1)
        )
    nbytes = 4 * B * N * words + 5 * B
    if dyn == "constant":
        nbytes += 4 * N * (nx * nx + nx * nw)
    t_bytes, t_ops = nbytes / HBM_BPS, B * N * flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_device_ms(torch, fn, kernel_name, reps=20, windows=3):
    """Device time of one launch of the kernel whose name contains
    ``kernel_name``: its CUDA time summed by ``torch.profiler`` over ``reps``
    calls of ``fn``, over ``reps``. Unlike CUDA events around a call, this
    leaves out the host's launch path, which a kernel of tens of
    microseconds is shorter than. A window in which the profiler recorded
    no device event at all (seen once in ~400 windows on an H100) is taken
    again, up to ``windows`` times."""
    fn()
    for _ in range(windows):
        _, total = profile_windows(torch, {kernel_name: lambda: [fn() for _ in range(reps)]}, [kernel_name])
        if total["device_events"]:
            break
    ms = total[f"{kernel_name}_ms"] / reps
    check(ms > 0, f"the profiler saw no {kernel_name} launches")
    return ms


def time_ms(fn, torch, reps=20, warmup=3):
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_kernel_shapes(torch, rp, rb, plain=True):
    """Each kernel at each of its main-path shapes (``PACKED_SHAPES``,
    ``GENERAL_SHAPES``): held against its plain version on the same CUDA
    tensors (rtol 2e-3, atol 2e-5 structured / 2e-4 general), then timed:
    ``ms`` device time per launch (``torch.profiler``, 20 launches),
    ``call_ms`` CUDA events around one wrapper call, ``plain_ms`` the plain
    version (skipped with ``plain=False``), ``bound_ms`` from
    ``sweep_bound``. Prints and returns one record per shape."""
    a, b1, b2 = 0.05, 0.00125, 0.05  # panda's dt = 0.05 double integrator

    def cases():  # (module, label, inputs, keywords, dynamics), inputs made one shape at a time
        for label, (B, N, n, ns) in PACKED_SHAPES.items():
            yield (rp, label, random_sweep_inputs(B, N, 2 * n, ns + n, seed=1),
                   dict(N=N, nx=2 * n, nw=ns + n, ns=ns, a=a, b1=b1, b2=b2), "packed")
        for label, (B, N, nx, nw, per_lane) in GENERAL_SHAPES.items():
            yield (rb, label, random_general_inputs(B, N, nx, nw, per_lane, seed=1),
                   dict(N=N, nx=nx, nw=nw), "batched" if per_lane else "constant")

    records = []
    for module, label, arrays, kw, dyn in cases():
        name = "riccati_backward_packed" if module is rp else "riccati_backward_batched"
        sweep, reference = getattr(module, name), getattr(module, f"{name}_reference")
        kernel, atol = ("riccati_packed_kernel", ATOL) if module is rp else ("riccati_batched_kernel", GEN_ATOL)
        args = [torch.as_tensor(v, device="cuda") for v in arrays]
        B = args[0].shape[0]
        k, K, f = sweep(*args, **kw)
        k_ref, K_ref, f_ref = reference(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((k - k_ref).abs().max()), float((K - K_ref).abs().max()))
        check(torch.allclose(k, k_ref, rtol=RTOL, atol=atol) and torch.allclose(K, K_ref, rtol=RTOL, atol=atol),
              f"{name} differs from its plain version at {label}, B={B}: max abs err {err:.3e}")
        check(not bool(f.any()) and not bool(f_ref.any()), f"{name}: spurious failed lanes at {label}")
        call = lambda: sweep(*args, **kw)  # noqa: E731
        bound_ms, bound_by = sweep_bound(B, kw["N"], kw["nx"], kw["nw"], dyn)
        rec = {
            "kernel": name, "shape": label, "B": B, "N": kw["N"], "nx": kw["nx"], "nw": kw["nw"],
            "dyn": dyn, "max_abs_err": err, "ms": kernel_device_ms(torch, call, kernel),
            "call_ms": time_ms(call, torch),
            "plain_ms": time_ms(lambda: reference(*args, **kw), torch, reps=10) if plain else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(json.dumps({"kernel_shape": rec}), flush=True)
        records.append(rec)
    return records


def build_phase():
    """Compile both kernel sources at once (one nvcc each) and print what
    ``-Xptxas -v`` says about each instantiation."""
    from robot_mpcs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    stems = ("riccati_packed", "riccati_batched")
    with concurrent.futures.ThreadPoolExecutor(len(stems)) as pool:
        results = dict(zip(stems, pool.map(_build.build_library, stems)))
    print(f"kernel build (parallel): {time.perf_counter() - t0:.1f} s", flush=True)
    for stem, (path, log) in results.items():
        print(f"{stem}: {path.name}", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)


def kernel_record(name, source, replaces, shapes, label):
    """The kernels-line entry of one kernel: its numbers at ``label`` (the
    phase-1 shape), its largest error over every shape it was compared at."""
    rec = next(r for r in shapes if r["kernel"] == name and r["shape"] == label)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in shapes if r["kernel"] == name),
        "ms": rec["ms"],
        "kernel_ms": rec["ms"],
        "call_ms": rec["call_ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a Riccati sweep
    }


def packed_kernel_phase(torch, rp, shapes):
    """The structured Riccati kernel at the test dims and with a slack column
    (the main path's shapes are compared in ``time_kernel_shapes``) and its
    NaN-lane contract; returns its kernels-line record."""
    a, b1, b2 = 0.05, 0.00125, 0.05  # panda's dt = 0.05 double integrator
    for n, ns, N, B in ((3, 0, 6, 5), (3, 1, 5, 5), (7, 1, 20, 64)):
        nx, nw = 2 * n, ns + n
        args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(B, N, nx, nw)]
        kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=a, b1=b1, b2=b2)
        k, K, f = rp.riccati_backward_packed(*args, **kw)
        k_ref, K_ref, f_ref = rp.riccati_backward_packed_reference(*args, **kw)
        torch.cuda.synchronize()
        for name, got, want in (("k_ff", k, k_ref), ("K", K, K_ref)):
            err = float((got - want).abs().max())
            check(
                torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                f"packed kernel {name} differs from the plain version at dims {(n, ns, N)}, "
                f"B={B}: max abs err {err:.3e}",
            )
        check(not bool(f.any()) and not bool(f_ref.any()), f"spurious failed lanes at {(n, ns, N)}")
        print(f"packed kernel vs plain at (n, ns, N, B)={(n, ns, N, B)}: max abs err "
              f"k_ff {float((k - k_ref).abs().max()):.3e}, K {float((K - K_ref).abs().max()):.3e}",
              flush=True)
    # NaN-poisoned lane: only that lane fails, healthy lanes stay finite
    args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(4, 4, 6, 3, seed=3)]
    args[2][2, 1] = float("nan")
    k, K, f = rp.riccati_backward_packed(*args, N=4, nx=6, nw=3, ns=0, a=0.1, b1=0.005, b2=0.1)
    check(f.tolist() == [False, False, True, False], f"NaN lane contract: failed = {f.tolist()}")
    check(bool(torch.isfinite(k[[0, 1, 3]]).all()), "NaN lane leaked into healthy lanes")
    print("packed NaN-lane contract: only lane 2 failed", flush=True)
    return kernel_record("riccati_backward_packed", "robot_mpcs_tpu_torch/csrc/riccati_packed.cu",
                         "robot_mpcs_tpu/ops/riccati_packed.py:238", shapes, "panda phase 1")


def batched_kernel_phase(torch, rb, shapes):
    """The general Riccati kernel at the test dims and with a slack column
    (the main path's shapes are compared in ``time_kernel_shapes``) and its
    bad-lane contracts; returns its kernels-line record."""
    for nx, nw, N, B in ((6, 3, 5, 5), (14, 7, 20, 64), (8, 3, 10, 64)):
        args = [torch.as_tensor(v, device="cuda") for v in random_general_inputs(B, N, nx, nw)]
        kw = dict(N=N, nx=nx, nw=nw)
        k, K, f = rb.riccati_backward_batched(*args, **kw)
        k_ref, K_ref, f_ref = rb.riccati_backward_batched_reference(*args, **kw)
        torch.cuda.synchronize()
        for name, got, want in (("k_ff", k, k_ref), ("K", K, K_ref)):
            err = float((got - want).abs().max())
            check(
                torch.allclose(got, want, rtol=GEN_RTOL, atol=GEN_ATOL),
                f"general kernel {name} differs from the plain version at "
                f"(nx, nw, N, B)={(nx, nw, N, B)}: max abs err {err:.3e}",
            )
        check(not bool(f.any()) and not bool(f_ref.any()),
              f"spurious failed lanes at {(nx, nw, N, B)}")
        print(f"general kernel vs plain at (nx, nw, N, B)={(nx, nw, N, B)}, per-lane A/B: max abs err "
              f"k_ff {float((k - k_ref).abs().max()):.3e}, K {float((K - K_ref).abs().max()):.3e}",
              flush=True)
    # a negative-definite lww lane fails alone with zero gains; so does a NaN lane
    for bad_lane, poison in ((1, "negdef"), (2, "nan")):
        args = [torch.as_tensor(v, device="cuda") for v in random_general_inputs(4, 4, 8, 2, seed=5)]
        if poison == "negdef":
            args[4][bad_lane] = -10.0 * torch.eye(2, device="cuda")
        else:
            args[2][bad_lane, 1] = float("nan")
        k, K, f = rb.riccati_backward_batched(*args, N=4, nx=8, nw=2)
        want = [i == bad_lane for i in range(4)]
        check(f.tolist() == want, f"general {poison} lane contract: failed = {f.tolist()}")
        good = [i for i in range(4) if i != bad_lane]
        check(bool(torch.isfinite(k[good]).all() and torch.isfinite(K[good]).all()),
              f"{poison} lane leaked into healthy lanes")
        if poison == "negdef":
            check(bool((k[bad_lane] == 0).all() and (K[bad_lane] == 0).all()),
                  "negative-definite lane has non-zero gains")
        print(f"general {poison}-lane contract: only lane {bad_lane} failed", flush=True)
    return kernel_record("riccati_backward_batched", "robot_mpcs_tpu_torch/csrc/riccati_batched.cu",
                         "robot_mpcs_tpu/ops/riccati_pallas.py:189", shapes, "group boxer phase 1")


@contextlib.contextmanager
def launches_by_batch(steps):
    """Tally the solver's kernel launches by kernel and batch size while the
    block runs (its references to both wrappers are wrapped, and restored
    after), and print them per step."""
    from robot_mpcs_tpu_torch.solver import al_ilqr

    tally = collections.Counter()
    originals = {n: getattr(al_ilqr, n) for n in ("riccati_backward_packed", "riccati_backward_batched")}

    def tallied(name, fn):
        def wrapped(lx, *args, **kw):
            before = fn.launches
            out = fn(lx, *args, **kw)
            tally[(name, lx.shape[0])] += fn.launches - before
            return out
        return wrapped

    for name, fn in originals.items():
        setattr(al_ilqr, name, tallied(name, fn))
    try:
        yield tally
    finally:
        for name, fn in originals.items():
            setattr(al_ilqr, name, fn)
    per_step = collections.defaultdict(dict)
    for (name, B), count in sorted(tally.items()):
        per_step[name][str(B)] = count / steps
    print(json.dumps({"launches_per_step_by_batch": per_step}), flush=True)


def profile_windows(torch, fns, kernel_names):
    """Run each of ``fns`` under its own ``torch.profiler`` window; returns
    per-window and total (wall ms, device events, device busy ms, per-kernel
    ms) and the idle share over all windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out, total = {}, {"wall_ms": 0.0, "device_events": 0, "device_busy_ms": 0.0}
    total.update({f"{k}_ms": 0.0 for k in kernel_names})
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        rec = {
            "wall_ms": wall_ms,
            "device_events": len(device),
            "device_busy_ms": float(sum(e.time_range.elapsed_us() for e in device)) / 1e3,
        }
        for k in kernel_names:
            rec[f"{k}_ms"] = float(sum(
                e.time_range.elapsed_us() for e in device if k in e.name
            )) / 1e3
        out[name] = rec
        for k in total:
            total[k] += rec[k]
    total["idle_share"] = (
        1.0 - total["device_busy_ms"] / total["wall_ms"] if total["device_events"] else None
    )
    if not total["device_events"]:
        print("profiler recorded no device events: device time not measured", flush=True)
    return out, total


def path_phase(torch, rp):
    """Drive the panda fleet on the card; returns (problem, scenario, launches)."""
    from robot_mpcs_tpu_torch.config import Setup, panda_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

    t0 = time.perf_counter()
    problem = MpcProblem(Setup.from_dict(panda_setup()))
    scenario = random_fleet_scenario(problem, BATCH, seed=0, **PANDA_SAMPLER)
    runner = FleetRunner(problem, BATCH, device="cuda")
    scen = runner.to_device(scenario)
    state = runner.init_state(scen)
    torch.cuda.synchronize()
    print(f"path set-up: {time.perf_counter() - t0:.1f} s", flush=True)

    rp.riccati_backward_packed.launches = 0
    step_s = []
    metrics = None
    with launches_by_batch(STEPS):
        for i in range(STEPS):
            t1 = time.perf_counter()
            state, metrics = runner.step(state, scen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            m = {k: float(v) for k, v in metrics._asdict().items()}
            print(f"step {i}: {step_s[-1] * 1e3:.1f} ms, converged {m['converged_fraction']:.4f}, "
                  f"max_violation_converged {m['max_violation_converged']:.3e}, "
                  f"mean_goal_distance {m['mean_goal_distance']:.4f}, "
                  f"mean_iterations {m['mean_iterations']:.2f}", flush=True)
            check(all(np.isfinite(v) for v in m.values()), f"non-finite metrics at step {i}: {m}")
    launches = rp.riccati_backward_packed.launches
    check(launches > 0, "the fleet step never launched the Riccati kernel")
    check(tuple(state.z_warm.shape) == (BATCH, problem.dims.N, problem.dims.nz), "state shape")
    check(bool(torch.isfinite(state.x).all()), "non-finite plant state")
    m = {k: float(v) for k, v in metrics._asdict().items()}
    check(m["converged_fraction"] >= 0.9, f"converged_fraction {m['converged_fraction']} < 0.9")
    steady = float(np.median(step_s[1:]))
    print(json.dumps({
        "fleet": "panda", "batch": BATCH, "steps": STEPS, "kernel_launches": launches,
        "step_ms": [s * 1e3 for s in step_s], "steady_step_ms": steady * 1e3,
        "solves_per_s": BATCH / steady, **m,
    }), flush=True)
    step_breakdown(torch, runner, state, scen)
    return problem, scenario, launches


def step_breakdown(torch, runner, state, scen, steps=2):
    """Where a fleet step's time goes, from further steps after the counted
    run: the host wall time of the phase-1 solve and of the rescue tier's
    solve (synchronized around each), the rest of the step (gather/merge of
    stragglers, post-step, kick, metrics), then one step under
    ``torch.profiler`` for the device's busy time and kernel count, with the
    idle share taken within that same profiled step."""

    def timed(fn, key, acc):
        def wrapped(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t
            return out
        return wrapped

    solve, tiers = runner._solve, runner._tiers
    for i in range(steps):
        acc = {"phase1": 0.0, "rescue": 0.0}
        runner._solve = timed(solve, "phase1", acc)
        runner._tiers = [(k, timed(fn, "rescue", acc)) for k, fn in tiers]
        t = time.perf_counter()
        state, _ = runner.step(state, scen)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        print(json.dumps({
            "breakdown_step": i, "step_ms": total * 1e3, "phase1_solve_ms": acc["phase1"] * 1e3,
            "rescue_solve_ms": acc["rescue"] * 1e3,
            "rest_ms": (total - acc["phase1"] - acc["rescue"]) * 1e3,
        }), flush=True)
    runner._solve, runner._tiers = solve, tiers

    _, total = profile_windows(
        torch, {"panda": lambda: runner.step(state, scen)}, ["riccati_packed_kernel"]
    )
    print(json.dumps({
        "profiled_step_ms": total["wall_ms"], "device_events": total["device_events"],
        "device_busy_ms": total["device_busy_ms"],
        "riccati_kernel_ms": total["riccati_packed_kernel_ms"],
        "idle_share_in_profiled_step": total["idle_share"],
    }), flush=True)


def group_phase(torch, rp, rb):
    """Drive the mixed fleet on the card; returns (boxer problem, boxer
    scenario, packed launches, batched launches)."""
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel import FleetGroup, mixed_fleet_scenarios

    t0 = time.perf_counter()
    setups = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}
    problems = {k: (MpcProblem(Setup.from_dict(setups[k]())), b) for k, b in GROUP_SIZES.items()}
    scenarios = mixed_fleet_scenarios(problems, seed=0, sampler_kwargs=GROUP_SAMPLERS)
    group = FleetGroup(problems, device="cuda")
    scen = group.to_device(scenarios)
    states = group.init_states(scen)
    torch.cuda.synchronize()
    print(f"group set-up: {time.perf_counter() - t0:.1f} s", flush=True)

    # per-class synchronized wall time: each class's step, timed on its own
    class_s = {k: [] for k in group.runners}
    steps = {k: r.step for k, r in group.runners.items()}

    def timed_step(name):
        def fn(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = steps[name](*args)
            torch.cuda.synchronize()
            class_s[name].append(time.perf_counter() - t)
            return out
        return fn

    for name, runner in group.runners.items():
        runner.step = timed_step(name)
    rp.riccati_backward_packed.launches = 0
    rb.riccati_backward_batched.launches = 0
    metrics = None
    with launches_by_batch(GROUP_STEPS):
        for i in range(GROUP_STEPS):
            states, metrics = group.step(states, scen)
            per = {k: {f: float(v) for f, v in m._asdict().items()} for k, m in metrics.per_class.items()}
            print(json.dumps({
                "group_step": i,
                **{f"{k}_step_ms": class_s[k][-1] * 1e3 for k in group.runners},
                **{f"{k}_converged": per[k]["converged_fraction"] for k in per},
                **{f"{k}_mean_goal_distance": per[k]["mean_goal_distance"] for k in per},
                "overall_converged": float(metrics.overall.converged_fraction),
            }), flush=True)
            for k, m in per.items():
                check(all(np.isfinite(v) for v in m.values()),
                      f"non-finite {k} metrics at group step {i}: {m}")
    packed_launches = rp.riccati_backward_packed.launches
    batched_launches = rb.riccati_backward_batched.launches
    for name, runner in group.runners.items():
        runner.step = steps[name]
    check(packed_launches > 0, "the group step never launched the structured Riccati kernel")
    check(batched_launches > 0, "the group step never launched the general Riccati kernel")
    for k, m in metrics.per_class.items():
        cf = float(m.converged_fraction)
        check(cf >= 0.9, f"{k}: last-step converged_fraction {cf} < 0.9")
    last = {k: {f: float(v) for f, v in m._asdict().items()} for k, m in metrics.per_class.items()}
    print(json.dumps({
        "group": GROUP_SIZES, "steps": GROUP_STEPS,
        "packed_launches": packed_launches, "batched_launches": batched_launches,
        **{f"{k}_median_step_ms": float(np.median(class_s[k][1:])) * 1e3 for k in group.runners},
        "group_median_step_ms": float(np.median(
            [sum(class_s[k][i] for k in group.runners) for i in range(1, GROUP_STEPS)]
        )) * 1e3,
        "last_step": last,
    }), flush=True)

    # one profiled group step, one window per class
    per_win, total = profile_windows(
        torch,
        {k: (lambda k=k: group.runners[k].step(states[k], scen[k])) for k in group.runners},
        ["riccati_packed_kernel", "riccati_batched_kernel"],
    )
    print(json.dumps({"profiled_group_step": total, "per_class": per_win}), flush=True)
    # one profiled call of the solver's diff-drive Jacobians at the group
    # shape (forward-mode autodiff of the dynamics, models.dynamics_jacobians)
    nx = group.runners["boxer"].dims.nx
    z = states["boxer"].z_warm
    jac = problems["boxer"][0].build_solver(device="cuda")._internals["all_dyn_jacobians"]
    jac(z[..., :nx], z[..., nx:])  # warm-up
    _, jt = profile_windows(torch, {"jac": lambda: jac(z[..., :nx], z[..., nx:])}, [])
    print(json.dumps({"boxer_dyn_jacobians_call": jt}), flush=True)
    return problems["boxer"][0], scenarios["boxer"], packed_launches, batched_launches


#: closed-loop solve caps of the planner runs, and the number of their first
#: observations replayed on a CPU planner
PLANNER_CAPS = {"panda": 150, "pointRobot": 250, "boxer": 40}
PLANNER_REPLAY = 10
SOLVE_BATCH = 64
#: goal radius (m) of each planner run: panda's end effector
#: (tests/test_planner_behavior.py), pointRobot's base (the verify recipe),
#: boxer's end effector (examples/boxer_example.py)
PLANNER_GOAL_TOL = {"panda": 0.05, "pointRobot": 0.15, "boxer": 0.4}
#: card-vs-CPU control bar (tests/test_parity.py) and solve_batch lane bar,
#: for two solves that took the same number of inner iterations. A solve
#: stops once its Newton step falls below tol_stationarity (1e-3, control
#: units) and the f32 merit test finds no gain; where one side takes one
#: more such step than the other, the two differ by that step, so solves
#: whose iteration counts differ are held to 2 x tol_stationarity instead.
PLANNER_ATOL = 1e-3
#: true-cost bar of converged card-vs-CPU solves (tests/test_torch_fleet.py)
PLANNER_COST_RTOL = 1e-5


class Sphere:
    """A sphere obstacle in the planner's ``position()``/``radius()`` API."""

    def __init__(self, position, radius):
        self._position, self._radius = list(position), float(radius)

    def position(self):
        return self._position

    def radius(self):
        return self._radius

    def dimension(self):
        return 3


def simulate_lidar(pose, obstacles, n_rays=64, max_range=10.0):
    """Raycast circles from the lidar mount (0.4 m ahead of the base), as
    examples/boxer_example.py:24-51. Returns (n_hits, 3) world points."""
    x, y, theta = pose
    origin = np.array([x + 0.4 * np.cos(theta), y + 0.4 * np.sin(theta)])
    angles = theta + np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    dirs = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    points = []
    for d in dirs:
        best = max_range
        for obst in obstacles:
            c = np.asarray(obst.position()[:2]) - origin
            proj = float(c @ d)
            if proj <= 0:
                continue
            perp2 = float(c @ c) - proj * proj
            r2 = obst.radius() ** 2
            if perp2 > r2:
                continue
            t = proj - np.sqrt(r2 - perp2)
            if 0 < t < best:
                best = t
        if best < max_range:
            hit = origin + best * d
            points.append([hit[0], hit[1], 0.0])
    return np.array(points, np.float32).reshape(-1, 3)


def planner_scenario(kind, device):
    """The planner, sim, initial state, goal and obstacles of one scenario,
    through the port's entry points on ``device``:

    * panda: tests/test_planner_behavior.py::test_panda_reaches_goal
      (pandaMpc.yaml with wconstr = [0.05, 0, 0, 0], one sphere, self
      collision, the URDF's joint limits, inputs +-5);
    * pointRobot: the verify recipe (pointRobotMpc.yaml with wconstr =
      [0.005, 0, 0, 0], a sphere on the line to the goal);
    * boxer: examples/boxer_example.py (boxerMpc.yaml, two spheres seen only
      through the lidar's free-space half-planes, r_body 0.6).
    """
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.perception import FreeSpaceDecomposition
    from robot_mpcs_tpu_torch.planner import MPCPlanner
    from robot_mpcs_tpu_torch.sim import KinematicSim

    setup = Setup.from_dict({"panda": panda_setup, "pointRobot": point_robot_setup,
                             "boxer": boxer_setup}[kind]())
    problem = MpcProblem(setup)
    planner = MPCPlanner(problem, device=device)
    dims = problem.dims
    x0 = np.zeros(dims.nx, np.float32)
    sc = {"kind": kind, "problem": problem, "planner": planner,
          "sim": KinematicSim(dims, setup.mpc.time_step, device=device), "x0": x0}
    if kind == "panda":
        sc.update(goal=[0.4, 0.3, 0.6], obstacles=[Sphere([0.2, -0.4, 0.8], 0.15)], r_body=0.1)
        x0[: dims.n] = [0.0, -0.8, 0.0, -2.0, 0.0, 1.5, 0.0]
        lim = problem.kin.joint_limits
        limits, limits_u, r_self = (lim[:, 0], lim[:, 1]), ([-5.0] * 7, [5.0] * 7), 0.05
    elif kind == "pointRobot":
        sc.update(goal=[3.0, 0.5, 0.0], obstacles=[Sphere([1.5, 0.25, 0.05], 0.4)], r_body=0.2)
        limits, limits_u, r_self = ([-10.0] * 3, [10.0] * 3), ([-5.0] * 3, [5.0] * 3), 0.2
    else:
        sc.update(goal=[7.2, -2.2], obstacles=[Sphere([4.0, -1.5, 0.0], 1.0), Sphere([2.4, -0.7, 0.0], 0.3)],
                  r_body=0.6, fsd=FreeSpaceDecomposition(dims.n_obst, max_radius=5.0, device=device))
        limits, limits_u, r_self = ([-10.0] * 3, [10.0] * 3), ([-10.0] * 2, [10.0] * 2), 0.6
    planner.setGoalReaching(sc["goal"])
    planner.setConstraintAvoidance()
    if kind != "boxer":
        planner.setRadialConstraints(sc["obstacles"], sc["r_body"])
    planner.setSelfCollisionAvoidanceConstraints(r_self)
    planner.setJointLimits(limits)
    planner.setInputLimits(limits_u)
    planner.concretize()
    return sc


def boxer_halfplanes(sc, q, exitflag, output):
    """Per-stage half-planes from one lidar scan (examples/boxer_example.py
    :70-89): one decomposition around each stage of the previous plan when
    the last solve succeeded, else around the current pose."""
    planner, fsd = sc["planner"], sc["fsd"]
    cloud = simulate_lidar(q, sc["obstacles"])
    lin = []
    for j in range(planner._N):
        if exitflag >= 0 and output:
            stage = output[planner._stage_key(j + 1)]
            fsd.set_position(np.array([stage[0], stage[1], 0.0]))
        else:
            fsd.set_position(np.array([q[0], q[1], 0.0]))
        if cloud.size:
            fsd.compute_constraints(cloud)
            lin.append(fsd.aslist())
        else:
            lin.append(np.tile(np.array([1.0, 0.0, 0.0, -100.0]), (planner._dims.n_obst, 1)))
    return lin


def goal_distance(sc, state):
    """Distance (m) of the scenario's tracked point from its goal."""
    import torch

    if sc["kind"] == "panda":
        q = torch.from_numpy(np.asarray(state[: sc["problem"].dims.n], np.float32))
        ee = sc["problem"].kin.fk_pos(q).numpy()
        return float(np.linalg.norm(ee - np.asarray(sc["goal"])))
    if sc["kind"] == "pointRobot":
        return float(np.linalg.norm(state[:2] - np.asarray(sc["goal"][:2])))
    ee = state[:2] + 0.4 * np.array([np.cos(state[2]), np.sin(state[2])])
    return float(np.linalg.norm(ee - np.asarray(sc["goal"])))


def planner_run(kind, device, cap, replay=PLANNER_REPLAY):
    """One closed loop of the scenario ``kind`` on ``device`` for at most
    ``cap`` solves, stopping at the goal (panda, pointRobot). Every exit flag
    must be >= 0. Returns the scenario and a record: per-solve wall ms (the
    whole ``computeAction``, its host copies included), FSD ms per step
    (boxer), the steps to the goal, the final distance, the pointRobot's
    least clearance, and the first ``replay`` solves: observation,
    half-planes, the planner's warm start before the solve, and the solve's
    action, flag, inner iterations and true cost."""
    sc = planner_scenario(kind, device)
    planner, sim = sc["planner"], sc["sim"]
    state = sim.reset(sc["x0"])
    rec = {"solve_ms": [], "fsd_ms": [], "flags": [], "replay": [], "reached_at": None,
           "min_clearance": None}
    exitflag, output = -1, {}
    for step in range(cap):
        obs = tuple(np.array(o) for o in sim.observation())
        lin = None
        if kind == "boxer":
            t = time.perf_counter()
            lin = boxer_halfplanes(sc, obs[0], exitflag, output)
            rec["fsd_ms"].append((time.perf_counter() - t) * 1e3)
            planner.setLinearConstraints(lin, sc["r_body"])
        if step < replay:  # the warm start this solve starts from
            warm = (planner._lam.copy(), np.array(getattr(planner, "_z_prev", planner._x0)),
                    planner._initial_step)
        t = time.perf_counter()
        action, output, exitflag = planner.computeAction(*obs)
        rec["solve_ms"].append((time.perf_counter() - t) * 1e3)
        rec["flags"].append(exitflag)
        check(exitflag >= 0, f"{kind} planner on {device}: exitflag {exitflag} at step {step}")
        check(bool(np.all(np.isfinite(action))), f"{kind} planner: non-finite action at step {step}")
        if step < replay:
            info = planner._last_info
            rec["replay"].append((obs, lin, warm, np.array(action), exitflag, int(info.iterations),
                                  float(info.cost)))
        state = sim.step(action)
        if kind == "pointRobot":
            obst = sc["obstacles"][0]
            clear = (np.linalg.norm(np.array([state[0], state[1], 0.05]) - np.asarray(obst.position()))
                     - obst.radius() - sc["r_body"])
            rec["min_clearance"] = clear if rec["min_clearance"] is None else min(rec["min_clearance"], clear)
        if goal_distance(sc, state) < PLANNER_GOAL_TOL[kind] and kind != "boxer":
            rec["reached_at"] = step
            break
    rec["final_distance"] = goal_distance(sc, state)
    return sc, rec


def solve_bar(problem, iterations_a, iterations_b):
    """Control bar between two solves of the same inputs (``PLANNER_ATOL``)."""
    if iterations_a == iterations_b:
        return PLANNER_ATOL
    return 2.0 * problem.setup.solver.tol_stationarity


def replay_on(kind, device, rec):
    """The recorded solves of a run repeated by a fresh planner on
    ``device``: the same observations and half-planes, each from the
    recorded planner's warm start (the closed loop's history is the card's,
    so each solve is compared from the same inputs). Returns one record per
    solve: |action difference|, its bar, both flags, both iteration counts,
    the relative true-cost difference, and the solve's wall ms."""
    sc = planner_scenario(kind, device)
    planner = sc["planner"]
    out = []
    for obs, lin, (lam, z_prev, initial), action, flag, iters, cost in rec["replay"]:
        if lin is not None:
            planner.setLinearConstraints(lin, sc["r_body"])
        planner._lam, planner._z_prev, planner._initial_step = lam.copy(), z_prev.copy(), initial
        t = time.perf_counter()
        a, _, f = planner.computeAction(*obs)
        ms = (time.perf_counter() - t) * 1e3
        info = planner._last_info
        out.append({"diff": float(np.abs(a - action).max()),
                    "bar": solve_bar(sc["problem"], iters, int(info.iterations)),
                    "flags": (flag, f), "iterations": (iters, int(info.iterations)),
                    "cost_rel": abs(float(info.cost) - cost) / max(abs(cost), 1e-6), "ms": ms})
    return out


def percentiles(ms):
    """p50 / p90 / max of solves 2... and the first solve, in ms."""
    rest = ms[1:] or ms
    return {"first_ms": ms[0], "p50_ms": float(np.percentile(rest, 50)),
            "p90_ms": float(np.percentile(rest, 90)), "max_ms": float(max(rest)), "solves": len(ms)}


def planner_phase(torch, rp, rb):
    """Drive the port's single-robot planner on the card (panda, pointRobot,
    boxer with lidar and free-space half-planes), replay their first
    observations on a CPU planner, check ``solve_batch`` against single
    solves and the global planner against the CPU."""
    counters = {"riccati_backward_packed": rp.riccati_backward_packed,
                "riccati_backward_batched": rb.riccati_backward_batched}
    needs = {"panda": "riccati_backward_packed", "pointRobot": "riccati_backward_packed",
             "boxer": "riccati_backward_batched"}
    per_solve, runs = {}, {}
    for kind, cap in PLANNER_CAPS.items():
        for fn in counters.values():
            fn.launches = 0
        with launches_by_batch(1) as tally:
            sc, rec = planner_run(kind, "cuda", cap)
        launches = {name: fn.launches for name, fn in counters.items()}
        solves = len(rec["solve_ms"])
        check(launches[needs[kind]] > 0, f"{kind} planner never launched {needs[kind]}")
        check(all(B == 1 for _, B in tally), f"{kind} planner launched at B != 1: {dict(tally)}")
        per_solve[kind] = {name: n / solves for name, n in launches.items() if n}
        if kind != "boxer":
            check(rec["reached_at"] is not None,
                  f"{kind} planner did not reach its goal in {cap} solves: {rec['final_distance']:.3f} m")
        if kind == "pointRobot":
            check(rec["min_clearance"] > -0.05, f"pointRobot clearance {rec['min_clearance']:.3f} m")
        # one profiled solve from the final state
        planner = sc["planner"]
        obs = np.concatenate([np.asarray(o) for o in sc["sim"].observation()])
        _, prof = profile_windows(torch, {"solve": lambda: planner.solve(obs)},
                                  ["riccati_packed_kernel", "riccati_batched_kernel"])
        runs[kind] = (sc, rec)
        print(json.dumps({
            "planner": kind, "device": "cuda", "steps_to_goal": rec["reached_at"],
            "final_distance_m": rec["final_distance"], "min_clearance_m": rec["min_clearance"],
            **percentiles(rec["solve_ms"]),
            "fsd_ms_per_step": float(np.median(rec["fsd_ms"])) if rec["fsd_ms"] else None,
            "launches_per_solve": per_solve[kind], "flags": collections.Counter(rec["flags"]),
            "profiled_solve": prof,
        }), flush=True)
    print(json.dumps({"planner_launches": per_solve}), flush=True)

    # the first solves of each run, repeated on the CPU
    for kind in PLANNER_CAPS:
        rec = runs[kind][1]
        rows = replay_on(kind, "cpu", rec)
        same_it = [r for r in rows if r["iterations"][0] == r["iterations"][1]]
        conv = [r for r in rows if r["flags"] == (1, 1)]
        print(json.dumps({
            "planner_card_vs_cpu": kind, "solves": len(rows),
            "max_action_diff": max(r["diff"] for r in rows),
            "max_action_diff_same_iterations": max((r["diff"] for r in same_it), default=None),
            "solves_with_other_iteration_count": len(rows) - len(same_it),
            "flags_equal": all(a == b for a, b in (r["flags"] for r in rows)),
            "max_cost_rel_converged": max((r["cost_rel"] for r in conv), default=None),
            "card_ms": percentiles(rec["solve_ms"][: len(rows)]), "cpu_ms": percentiles([r["ms"] for r in rows]),
            "per_solve": [{k: r[k] for k in ("diff", "flags", "iterations", "cost_rel")} for r in rows],
        }), flush=True)
        for i, r in enumerate(rows):
            check(r["flags"][0] == r["flags"][1], f"{kind} planner solve {i}: exit flags {r['flags']} (card, CPU)")
            check(r["diff"] <= r["bar"], f"{kind} planner solve {i}: card and CPU actions differ by "
                  f"{r['diff']:.3e} > {r['bar']:.0e} (iterations {r['iterations']})")
            if r["flags"] == (1, 1):
                check(r["cost_rel"] <= PLANNER_COST_RTOL,
                      f"{kind} planner solve {i}: true costs differ by {r['cost_rel']:.2e} relative")

    solve_batch_phase(runs["panda"])
    global_planner_phase()


def solve_batch_phase(run):
    """``solve_batch`` of SOLVE_BATCH perturbed panda observations at once
    against a B=1 solve of each: exit flags equal, z within ``solve_bar``."""
    sc, rec = run
    planner, dims = sc["planner"], sc["problem"].dims
    rng = np.random.default_rng(0)
    base = np.concatenate(rec["replay"][-1][0])
    B = SOLVE_BATCH
    xinit = np.repeat(base[None], B, 0).astype(np.float32)
    xinit[:, : dims.n] += rng.normal(0.0, 0.02, size=(B, dims.n)).astype(np.float32)
    params = np.repeat(planner.params[None], B, 0)
    z0 = np.zeros((B, dims.N, dims.nz), np.float32)
    z0[:, :, : dims.nx] = xinit[:, None]
    lam0 = np.repeat(planner._lam[None], B, 0)
    t = time.perf_counter()
    batch = planner.solve_batch(xinit, params, z0, lam0)
    flags, z = batch.exitflag.cpu().numpy(), batch.z.cpu().numpy()
    batch_ms = (time.perf_counter() - t) * 1e3
    iters = batch.iterations.cpu().numpy()
    err, same_err, differ, over = 0.0, 0.0, [], []
    for i in range(B):
        one = planner.solve_batch(xinit[i : i + 1], params[i : i + 1], z0[i : i + 1], lam0[i : i + 1])
        if int(one.exitflag[0]) != int(flags[i]):
            differ.append(i)
        d = float(np.abs(one.z[0].cpu().numpy() - z[i]).max())
        err = max(err, d)
        if int(one.iterations[0]) == int(iters[i]):
            same_err = max(same_err, d)
        if d > solve_bar(sc["problem"], int(one.iterations[0]), int(iters[i])):
            over.append(i)
    print(json.dumps({"solve_batch": B, "batch_ms": batch_ms, "flags": collections.Counter(flags.tolist()),
                      "lanes_with_other_flag": differ, "max_z_diff": err,
                      "max_z_diff_same_iterations": same_err, "lanes_over_bar": over}), flush=True)
    check(not differ, f"solve_batch: lanes {differ} end with another exit flag than their B=1 solve")
    check(not over, f"solve_batch: lanes {over} differ from their B=1 solves beyond the bar (max {err:.3e})")


def global_planner_phase():
    """``GlobalPlanner`` on a seeded random 128x128 occupancy map with a wall:
    the obstacle enlargement on the card equals the CPU's exactly (0/1 map:
    a blurred cell is a count, no rounding reaches the threshold), and A*
    (native library when built, else the Python fallback) finds a path."""
    from robot_mpcs_tpu_torch.global_planner import GlobalPlanner
    from robot_mpcs_tpu_torch.global_planner import astar
    from robot_mpcs_tpu_torch.global_planner.global_planner import enlarge_obstacles

    gp = GlobalPlanner([128, 128, 1], [-6.4, -6.4, 0.0], [6.4, 6.4, 1.0], device="cuda")
    occ = (np.random.default_rng(0).random((128, 128, 1)) < 0.1).astype(np.float32)
    occ[30:100, 62:66, 0] = 1.0
    gp.get_occupancy_map(None, occ)
    t = time.perf_counter()
    card = gp.get_enlarged_obstacles()
    card_ms = (time.perf_counter() - t) * 1e3
    k = int(np.ceil(0.4 / gp.cell_size))
    cpu = enlarge_obstacles(gp.occupancy_map_2d / max(gp.occupancy_map_2d.max(), 1e-6), k, gp.threshold,
                            device="cpu")
    check(np.array_equal(card, cpu), f"enlarge_obstacles: card and CPU differ in {int((card != cpu).sum())} cells")
    t = time.perf_counter()
    path, _ = gp.get_global_path_astar(np.array([-5.0, -5.0, 0.0]), np.array([5.0, 5.0, 0.0]))
    astar_ms = (time.perf_counter() - t) * 1e3
    check(len(path) > 0, "global planner found no path")
    print(json.dumps({"global_planner": "128x128", "enlarge_ms_card": card_ms, "occupied_after_enlarge":
                      int(card.sum()), "path_nodes": len(path), "astar_ms": astar_ms,
                      "astar": "native" if astar._NATIVE is not None else "python fallback"}), flush=True)


def reference_phase(torch, label, problem, scenario):
    """One batched solve of 64 lanes on the card vs the same solve on the CPU."""
    B = 64
    dims = problem.dims
    xinit, params = scenario.xinit[:B], scenario.params[:B]
    z0 = torch.zeros((B, dims.N, dims.nz))
    z0[:, :, : dims.nx] = xinit[:, None, :]
    lam0 = torch.zeros((B, dims.N, problem.n_con))
    res_gpu = problem.build_solver(device="cuda")(xinit, params, z0, lam0)
    res_cpu = problem.build_solver(device="cpu")(xinit, params, z0, lam0)
    check(tuple(res_gpu.z.shape) == (B, dims.N, dims.nz), f"{label}: solve output shape")
    check(bool(torch.isfinite(res_gpu.z).all()), f"{label}: non-finite solve output")
    flag_gpu, flag_cpu = res_gpu.exitflag.cpu(), res_cpu.exitflag
    agree = int((flag_gpu == flag_cpu).sum())
    both = (flag_gpu == 1) & (flag_cpu == 1)
    check(bool(both.any()), f"{label}: no lane converged on both card and CPU")
    rel = ((res_gpu.cost.cpu() - res_cpu.cost).abs() / res_cpu.cost.abs().clamp(min=1e-6))[both]
    viol = res_gpu.violation.cpu()[flag_gpu == 1]
    print(f"{label} card vs CPU solve (B={B}): exit flags agree {agree}/{B}, converged on both "
          f"{int(both.sum())}, max rel cost diff {float(rel.max()):.3e}, "
          f"max violation (converged) {float(viol.max()):.3e}", flush=True)
    # f32 sums in another order can flip a borderline line-search accept
    check(agree >= B - 4, f"{label}: exit flags agree on only {agree}/{B} lanes")
    check(float(rel.max()) <= 1e-4, f"{label}: true costs of converged lanes disagree")
    check(float(viol.max()) <= 1e-4, f"{label}: converged lanes violate constraints")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from robot_mpcs_tpu_torch.ops import riccati_batched as rb
        from robot_mpcs_tpu_torch.ops import riccati_packed as rp
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()

    build_phase()
    shapes = time_kernel_shapes(torch, rp, rb)
    packed = packed_kernel_phase(torch, rp, shapes)
    batched = batched_kernel_phase(torch, rb, shapes)
    print(f"kernel phases done at {time.perf_counter() - t0:.1f} s", flush=True)
    panda, panda_scenario, packed["launches"] = path_phase(torch, rp)
    print(f"panda path done at {time.perf_counter() - t0:.1f} s", flush=True)
    boxer, boxer_scenario, _, batched["launches"] = group_phase(torch, rp, rb)
    print(f"group path done at {time.perf_counter() - t0:.1f} s", flush=True)
    planner_phase(torch, rp, rb)
    print(f"planner path done at {time.perf_counter() - t0:.1f} s", flush=True)
    reference_phase(torch, "panda", panda, panda_scenario)
    reference_phase(torch, "boxer", boxer, boxer_scenario)
    print(f"all phases done at {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": [packed, batched]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
