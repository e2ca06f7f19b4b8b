#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``robot_mpcs_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit from ``nvidia-smi``; no CUDA
   device (or no port package beside this script) exits non-zero.
2. kernel: builds the structured Riccati CUDA kernel from
   ``robot_mpcs_tpu_torch/csrc/riccati_packed.cu`` and holds it against its
   plain PyTorch version on the same CUDA tensors at the test dims (3, 0, 6),
   (3, 1, 5), the panda fleet shape (B=4096, N=20, nx=14, nw=7) and panda
   with a slack column (nw=8), at
   rtol 2e-3 / atol 2e-5; a NaN-poisoned lane must be the only failed lane.
   Times both at the panda shape (CUDA events, median after warm-up).
3. path: the panda fleet (``examples/config/pandaMpc.yaml`` with the fleet
   benchmark's repulsion weight), B=4096 random scenarios from seed 0,
   through ``FleetRunner(..., device="cuda")`` for 6 closed-loop steps with
   the default rescue tier and kick. The kernel's launch count must grow,
   every metric must be finite and the last step's converged fraction must
   be >= 0.9 (a floor under the 0.956-0.971 the JAX package reaches).
   Two more steps then split the step's wall time into phase-1 solve,
   rescue-tier solve and the rest, and one step under ``torch.profiler``
   gives the device's busy time, kernel count and idle share.
4. reference: one batched solve of 64 of those scenarios on the card against
   the same solve on the CPU (the plain Riccati version): exit flags and
   true costs must agree.

Output: the kernels JSON line, then the card's ``name, power.limit`` line,
then the result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 4096
STEPS = 6
PANDA_SAMPLER = dict(
    goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 1.0)),
    obstacle_box=((-0.8, -0.8, 0.2), (0.8, 0.8, 1.0)),
    reachable_goals=True,
)
RTOL, ATOL = 2e-3, 2e-5


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


def kernel_phase(torch, rp):
    """Build, compare and time the Riccati kernel; returns its record."""
    t0 = time.perf_counter()
    rp.build_kernel()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    a, b1, b2 = 0.05, 0.00125, 0.05  # panda's dt = 0.05 double integrator
    max_err = 0.0
    # the test dims, the panda fleet shape, and panda with a slack column
    for n, ns, N, B in ((3, 0, 6, 5), (3, 1, 5, 5), (7, 0, 20, BATCH), (7, 1, 20, 64)):
        nx, nw = 2 * n, ns + n
        args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(B, N, nx, nw)]
        kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=a, b1=b1, b2=b2)
        k, K, f = rp.riccati_backward_packed(*args, **kw)
        k_ref, K_ref, f_ref = rp.riccati_backward_packed_reference(*args, **kw)
        torch.cuda.synchronize()
        for name, got, want in (("k_ff", k, k_ref), ("K", K, K_ref)):
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(
                torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                f"kernel {name} differs from the plain version at dims {(n, ns, N)}, B={B}: "
                f"max abs err {err:.3e}",
            )
        check(not bool(f.any()) and not bool(f_ref.any()), f"spurious failed lanes at {(n, ns, N)}")
        print(f"kernel vs plain at (n, ns, N, B)={(n, ns, N, B)}: max abs err "
              f"k_ff {float((k - k_ref).abs().max()):.3e}, K {float((K - K_ref).abs().max()):.3e}",
              flush=True)
    # NaN-poisoned lane: only that lane fails, healthy lanes stay finite
    args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(4, 4, 6, 3, seed=3)]
    args[2][2, 1] = float("nan")
    k, K, f = rp.riccati_backward_packed(*args, N=4, nx=6, nw=3, ns=0, a=0.1, b1=0.005, b2=0.1)
    check(f.tolist() == [False, False, True, False], f"NaN lane contract: failed = {f.tolist()}")
    check(bool(torch.isfinite(k[[0, 1, 3]]).all()), "NaN lane leaked into healthy lanes")
    print("NaN-lane contract: only lane 2 failed", flush=True)
    # time both at the panda shape
    args = [torch.as_tensor(v, device="cuda") for v in random_sweep_inputs(BATCH, 20, 14, 7, seed=1)]
    kw = dict(N=20, nx=14, nw=7, ns=0, a=a, b1=b1, b2=b2)
    ms = time_ms(lambda: rp.riccati_backward_packed(*args, **kw), torch)
    plain_ms = time_ms(lambda: rp.riccati_backward_packed_reference(*args, **kw), torch, reps=10)
    print(f"riccati sweep at B={BATCH}, N=20, nx=14, nw=7: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return {
        "name": "riccati_backward_packed",
        "route": "cuda",
        "source": "robot_mpcs_tpu_torch/csrc/riccati_packed.cu",
        "replaces": "robot_mpcs_tpu/ops/riccati_packed.py:238",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
    }


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = runner.step(state, scen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = float(sum(e.time_range.elapsed_us() for e in device))
    riccati_us = float(sum(
        e.time_range.elapsed_us() for e in device if "riccati_packed_kernel" in e.name
    ))
    print(json.dumps({
        "profiled_step_ms": wall_us / 1e3, "device_events": len(device),
        "device_busy_ms": busy_us / 1e3, "riccati_kernel_ms": riccati_us / 1e3,
        "idle_share_in_profiled_step": 1.0 - busy_us / wall_us if device else None,
    }), flush=True)
    if not device:
        print("profiler recorded no device events: device time not measured", flush=True)


def reference_phase(torch, problem, scenario):
    """One batched solve of 64 lanes on the card vs the same solve on the CPU."""
    B = 64
    dims = problem.dims
    xinit, params = scenario.xinit[:B], scenario.params[:B]
    z0 = torch.zeros((B, dims.N, dims.nz))
    z0[:, :, : dims.nx] = xinit[:, None, :]
    lam0 = torch.zeros((B, dims.N, problem.n_con))
    res_gpu = problem.build_solver(device="cuda")(xinit, params, z0, lam0)
    res_cpu = problem.build_solver(device="cpu")(xinit, params, z0, lam0)
    check(tuple(res_gpu.z.shape) == (B, dims.N, dims.nz), "solve output shape")
    check(bool(torch.isfinite(res_gpu.z).all()), "non-finite solve output")
    flag_gpu, flag_cpu = res_gpu.exitflag.cpu(), res_cpu.exitflag
    agree = int((flag_gpu == flag_cpu).sum())
    both = (flag_gpu == 1) & (flag_cpu == 1)
    rel = ((res_gpu.cost.cpu() - res_cpu.cost).abs() / res_cpu.cost.abs().clamp(min=1e-6))[both]
    viol = res_gpu.violation.cpu()[flag_gpu == 1]
    print(f"card vs CPU solve (B={B}): exit flags agree {agree}/{B}, converged on both "
          f"{int(both.sum())}, max rel cost diff {float(rel.max()):.3e}, "
          f"max violation (converged) {float(viol.max()):.3e}", flush=True)
    # f32 sums in another order can flip a borderline line-search accept
    check(agree >= B - 4, f"exit flags agree on only {agree}/{B} lanes")
    check(float(rel.max()) <= 1e-4, "true costs of converged lanes disagree")
    check(float(viol.max()) <= 1e-4, "converged lanes violate constraints")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
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

    record = kernel_phase(torch, rp)
    problem, scenario, launches = path_phase(torch, rp)
    record["launches"] = launches
    reference_phase(torch, problem, scenario)

    print(json.dumps({"kernels": [record]}), flush=True)
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
