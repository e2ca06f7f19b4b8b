"""Headline benchmark of the port: batched panda MPC solves/s per card.

    python -m robot_mpcs_tpu_torch.bench [--device cuda|cpu]

Port of the JAX package's ``bench.py``. It measures the closed-loop
receding-horizon fleet step (batched AL-iLQR solve with shift-horizon and
multiplier warm starts, the rescue tier, plant integration, metric
reduction) on the panda problem (7-dof arm, H=20, radial, self-collision,
joint and input limit constraints), with the same scenario classes,
samplers and weight overrides. It runs on the CUDA card unless
``--device cpu`` asks for the CPU (a rehearsal: the Riccati sweeps then run
their plain versions, and no number of such a run is a card's).

Output contract (the last JSON line on stdout is the result):

1. the headline JSON line is printed as soon as the panda measurement ends,
   before any extra, so that no extra can lose it;
2. the extras (panda latency at B=1 and 64 on one card; the pointRobot and
   boxer classes at ``min(1024, batch)``) run only while the wall clock,
   from this module's import, is under ``BENCH_TIME_BUDGET`` seconds
   (default 420). One skipped for want of time leaves ``latency_skipped`` /
   ``multiclass_skipped`` and is not an error. One that raises leaves
   ``latency_error`` / ``multiclass_error`` and makes the exit code 1;
3. a final enriched line (the headline's fields, the extras, ``bench_wall_s``)
   is printed last.

The headline's fields are ``bench.py``'s, less ``vs_baseline``: that ratio
divides by a per-chip target set for a TPU v5e-16, which says nothing of a
card. In its place ``extra`` carries ``device`` (the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them, ``"cpu"`` on the CPU) and ``riccati_launches``: each Riccati
wrapper's launch counter over each timed window, by window (``panda``,
``panda_b1``, ``panda_b64``, ``pointRobot``, ``boxer``).

Timing on the card:

* the kernel library that a problem launches is built (or loaded from the
  kernel cache, ``utils/compile_cache.py``) before its first warm step, so
  no timed step compiles; the build lands in ``setup_s``;
* warm-up runs at least 3 steps and stops when the last two are each within
  1.25x of the fastest so far, or at ``BENCH_WARMUP_MAX`` steps, or after
  240 s (``warmup_truncated``);
* the timed window is ``BENCH_STEPS`` steps behind one synchronize and one
  scalar pull; it is measured again once (``remeasured``) when its mean
  step exceeds 5x the last warm step.

Several cards: with a process group (``parallel/distributed.initialize``:
the ``ROBOT_MPCS_*`` or torchrun variables), the fleet is sharded over
``make_mesh()``, the batch rounded up to a multiple of the world size, and
the rate reported per card (total / world size, the window being the
slowest rank's). Only rank 0 prints. The latency extra runs at world 1 on
rank 0's card while the other ranks wait at a barrier; the classes run on
the mesh. Every decision that could differ between ranks (a warm-up's end,
its budget, a remeasure, a class's failed set-up, the exit code) is reduced
over the ranks before it is taken, so that their collectives stay paired. A
step that raises on one rank only leaves its peers in that step's
collective: that rank then makes no collective any more, and its exit ends
the peers' wait (gloo at once, NCCL at the group's timeout).

Environment knobs: BENCH_BATCH (4096), BENCH_STEPS (30), BENCH_WARMUP_MAX
(8), BENCH_TIME_BUDGET (420), BENCH_LATENCY=0, BENCH_MULTICLASS=0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup  # noqa: E402
from robot_mpcs_tpu_torch.models.problem import MpcProblem  # noqa: E402
from robot_mpcs_tpu_torch.ops import _build, riccati_batched, riccati_packed  # noqa: E402
from robot_mpcs_tpu_torch.parallel import distributed  # noqa: E402
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario  # noqa: E402
from robot_mpcs_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_batch_to_mesh  # noqa: E402
from robot_mpcs_tpu_torch.utils import aot  # noqa: E402
from robot_mpcs_tpu_torch.utils.compile_cache import enable_compile_cache  # noqa: E402
from robot_mpcs_tpu_torch.utils.devices import resolve_device  # noqa: E402


def _elapsed() -> float:
    return time.perf_counter() - T0


#: per-class scenario samplers (goal/obstacle boxes sized to each robot's
#: workspace) and weight overrides, as ``bench.py:48-77``: the stock
#: N-scaled repulsion parks robots off their goals (see
#: ``objectives.ConstraintAvoidance``). ``config`` names the YAML file that
#: ``_SETUPS`` holds as a dict.
CLASS_SPECS = {
    "panda": dict(
        config="pandaMpc.yaml",
        weights={"wconstr": [0.05, 0.0, 0.0, 0.0]},
        sampler=dict(
            goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 1.0)),
            obstacle_box=((-0.8, -0.8, 0.2), (0.8, 0.8, 1.0)),
            # goals are FK images of random configurations: box-sampled
            # goals often lie outside the ~0.85 m panda workspace
            reachable_goals=True,
        ),
    ),
    "pointRobot": dict(
        config="pointRobotMpc.yaml",
        weights={"wconstr": [0.005, 0.0, 0.0, 0.0]},
        sampler=dict(
            goal_box=((-2.0, -2.0, 0.05), (2.0, 2.0, 0.05)),
            obstacle_box=((-1.5, -1.5, 0.05), (1.5, 1.5, 0.05)),
        ),
    ),
    "boxer": dict(
        config="boxerMpc.yaml",
        weights={},
        sampler=dict(
            goal_box=((-2.0, -2.0, 0.0), (2.0, 2.0, 0.0)),
            obstacle_box=((5.0, 5.0, 0.0), (6.0, 6.0, 0.0)),
        ),
    ),
}
#: the headline's ``extra`` fields: ``bench.py``'s, less ``vs_baseline``
#: (beside ``extra`` there), plus ``device`` and ``riccati_launches``; the
#: warm-up's ``warmup_truncated`` and ``remeasured`` follow only when set
HEADLINE_FIELDS = (
    "batch", "steps", "n_chips", "elapsed_s", "total_solves_per_s", "converged_fraction",
    "max_violation", "max_violation_converged", "max_violation_unconverged",
    "rescue_overflow_fraction", "mean_goal_distance", "reset_fraction", "mean_iterations",
    "throughput_step_ms", "dt_budget_ms", "setup_s", "warmup_steps", "warmup_s",
    "device", "riccati_launches",
)
#: the fields that the enriched line adds when both extras run to their end
EXTRA_FIELDS = (
    "p50_solve_latency_ms_b1", "realtime_ok_b1", "p50_solve_latency_ms_b64", "realtime_ok_b64",
    "pointRobot_solves_per_s_per_chip", "pointRobot_converged_fraction",
    "boxer_solves_per_s_per_chip", "boxer_converged_fraction", "bench_wall_s",
)
#: each class's configuration file as a dict (no PyYAML on the card's host)
_SETUPS = {"panda": panda_setup, "pointRobot": point_robot_setup, "boxer": boxer_setup}
#: the Riccati wrappers whose launch counters the result line carries
KERNELS = {
    "riccati_backward_packed": riccati_packed.riccati_backward_packed,
    "riccati_backward_batched": riccati_batched.riccati_backward_batched,
}


def _load_problem(name):
    spec = CLASS_SPECS[name]
    setup = Setup.from_dict(_SETUPS[name]())
    setup.mpc.weights.update(spec["weights"])
    return MpcProblem(setup), setup


def _scenario_for(problem, b, spec_name, seed=0):
    """The class's random scenario of ``b`` lanes (CPU tensors)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return random_fleet_scenario(problem, b, seed=seed, **CLASS_SPECS[spec_name]["sampler"])


def _build_kernels(problem, device) -> None:
    """Build (one ``nvcc`` per shape, in parallel), or load from the kernel
    cache, the kernel libraries that the problem's solve launches on the
    card at its shape, so that no timed step calls nvcc."""
    if device.type == "cuda":
        kernels = aot.libraries(problem)
        _build.build_libraries(kernels)
        for stem, shape in kernels:
            _build.load_library(stem, shape)


def _sync(metrics, device) -> float:
    """Wait for the device, then pull one scalar to the host: a barrier that
    cannot return before the step's work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return float(metrics.converged_fraction)


def _launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _launches_since(before):
    return {name: fn.launches - before[name] for name, fn in KERNELS.items()}


def _slowest(values, mesh: Mesh) -> list:
    """The largest over the ranks of each of ``values`` (these themselves
    without a group)."""
    if mesh.group is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


def _any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is true on any (so that every rank
    takes the same branch before a collective)."""
    return _slowest([flag], mesh)[0] > 0.0


def _warm_and_measure(runner, state, scenario, steps, warmup_max, note, warmup_budget_s=240.0):
    """Warm a fleet to steady state, then time ``steps`` steps behind one
    synchronize and pull. Returns (state, metrics, seconds, launches over the
    timed window).

    Warm-up steps are synchronized one by one: at least 3, stopping when the
    last two are each within 1.25x of the fastest so far (steady state on
    this device), at ``warmup_max`` steps, or after ``warmup_budget_s``
    seconds. A window whose mean step exceeds 5x the last warm step caught a
    stray slow step: it is measured once more and the second kept.

    With a process group every time that a decision reads is the slowest
    rank's, so that all ranks take the same number of steps and their
    collectives (two in each step) stay paired.
    """
    device, mesh = runner.device, runner.mesh
    warm_times = []
    metrics = None
    t_warm = time.perf_counter()
    for _ in range(max(3, warmup_max)):
        t1 = time.perf_counter()
        state, metrics = runner.step(state, scenario)
        _sync(metrics, device)
        now = time.perf_counter()
        step_s, warm_s = _slowest((now - t1, now - t_warm), mesh)
        warm_times.append(step_s)
        if len(warm_times) >= 3 and max(warm_times[-2:]) <= 1.25 * min(warm_times):
            break
        if warm_s > warmup_budget_s:
            note["warmup_truncated"] = True
            break

    def _measure():
        before = _launch_counts()
        t1 = time.perf_counter()
        st, m = state, metrics
        for _ in range(steps):
            st, m = runner.step(st, scenario)
        _sync(m, device)
        (elapsed,) = _slowest([time.perf_counter() - t1], mesh)
        return st, m, elapsed, _launches_since(before)

    state, metrics, elapsed, launches = _measure()
    if elapsed / steps > 5.0 * warm_times[-1]:
        note["remeasured"] = True
        state, metrics, elapsed, launches = _measure()
    note["warmup_steps"] = len(warm_times)
    note["warmup_s"] = round(sum(warm_times), 1)
    return state, metrics, elapsed, launches


def measure_latency(prob, b, spec_name, device):
    """p50 step time in ms at batch ``b`` on one device at world 1, less the
    median time of a scalar pull of a finished result (the sync floor), and
    the launches over the 15 timed steps."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = FleetRunner(prob, batch_size=b, mesh=Mesh(1, 0, device))
    sc = r.shard_scenario(_scenario_for(prob, b, spec_name))
    st = r.init_state(sc)
    m = None
    for _ in range(4):
        st, m = r.step(st, sc)
        _sync(m, device)
    floors = []
    for _ in range(5):
        t1 = time.perf_counter()
        _sync(m, device)
        floors.append(time.perf_counter() - t1)
    floor = sorted(floors)[len(floors) // 2]
    before = _launch_counts()
    times = []
    for _ in range(15):
        t1 = time.perf_counter()
        st, m = r.step(st, sc)
        _sync(m, device)
        times.append(time.perf_counter() - t1)
    times.sort()
    p50 = max(0.0, times[len(times) // 2] - floor)
    return 1000.0 * p50, _launches_since(before)


def device_label(device) -> str:
    """The card's ``name, power.limit`` from nvidia-smi; ``"cpu"`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(device)}, power.limit not read ({e!r})"[:200]
    return out.splitlines()[0]


def _parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="python -m robot_mpcs_tpu_torch.bench",
        description="Panda fleet solves/s per card, with latency and multi-class extras.",
    )
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default: this rank's card) or 'cpu' (a rehearsal)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    steps = int(os.environ.get("BENCH_STEPS", "30"))
    warmup_max = int(os.environ.get("BENCH_WARMUP_MAX", "8"))
    budget = float(os.environ.get("BENCH_TIME_BUDGET", "420"))

    device = resolve_device(args.device)  # raises without CUDA: no CPU fallback
    enable_compile_cache()
    # a group's rank takes cuda:{LOCAL_RANK} unless a device was named
    grouped = distributed.initialize(device=None if args.device == "cuda" else device)
    mesh = make_mesh() if grouped else make_mesh(device)
    rank0 = mesh.rank == 0
    n_chips = mesh.world
    batch = pad_batch_to_mesh(batch, mesh)

    problem, setup = _load_problem("panda")
    runner = FleetRunner(problem, batch_size=batch, mesh=mesh)
    scenario = runner.shard_scenario(_scenario_for(problem, batch, "panda"))
    state = runner.init_state(scenario)
    _build_kernels(problem, mesh.device)

    note = {}
    state, metrics, elapsed, launches = _warm_and_measure(
        runner, state, scenario, steps, warmup_max, note
    )
    riccati_launches = {name: {"panda": n} for name, n in launches.items()}

    solves = batch * steps
    solves_per_s = solves / elapsed
    per_chip = solves_per_s / n_chips
    dt_budget_ms = 1000.0 * setup.mpc.time_step
    result = {
        "metric": "panda_H20_mpc_solves_per_s_per_chip",
        "value": round(per_chip, 1),
        "unit": "solves/s/chip",
        "extra": {
            "batch": batch,
            "steps": steps,
            "n_chips": n_chips,
            "elapsed_s": round(elapsed, 3),
            "total_solves_per_s": round(solves_per_s, 1),
            #: fraction of solves with exitflag 1 (feasible to tol_constraint
            #: and stationary); 1 - reset_fraction is "did not fail"
            "converged_fraction": float(metrics.converged_fraction),
            "max_violation": float(metrics.max_violation),
            #: violation per exit-flag class: converged lanes sit at or below
            #: tol_constraint; the unconverged number sizes the tail
            "max_violation_converged": float(metrics.max_violation_converged),
            "max_violation_unconverged": float(metrics.max_violation_unconverged),
            #: unconverged lanes the rescue tier had no slot for
            "rescue_overflow_fraction": float(metrics.rescue_overflow_fraction),
            "mean_goal_distance": float(metrics.mean_goal_distance),
            "reset_fraction": float(metrics.reset_fraction),
            "mean_iterations": round(float(metrics.mean_iterations), 2),
            "throughput_step_ms": round(1000.0 * elapsed / steps, 2),
            "dt_budget_ms": round(dt_budget_ms, 2),
            "setup_s": round(_elapsed() - elapsed - note.get("warmup_s", 0), 1),
            **note,
            "device": device_label(mesh.device) if rank0 else None,
            "riccati_launches": riccati_launches,
        },
    }
    # ---- headline out first: nothing below may lose this line ------------
    if rank0:
        print(json.dumps(result), flush=True)

    def remaining():
        return budget - _elapsed()

    failed = False
    broken = False  # a rank's step raised: the group's collectives no longer pair
    latency = {}
    if os.environ.get("BENCH_LATENCY", "1") != "0":
        if rank0:
            for b in (1, 64):
                if remaining() < 150.0:
                    latency["latency_skipped"] = "time budget"
                    break
                try:
                    p50, counts = measure_latency(problem, b, "panda", mesh.device)
                except Exception as e:  # noqa: BLE001 - recorded, and the exit code says so
                    traceback.print_exc()
                    latency["latency_error"] = repr(e)[:200]
                    failed = True
                    break
                latency[f"p50_solve_latency_ms_b{b}"] = round(p50, 2)
                latency[f"realtime_ok_b{b}"] = bool(p50 <= dt_budget_ms)
                for name, n in counts.items():
                    riccati_launches[name][f"panda_b{b}"] = n
        distributed.barrier(mesh.device)

    # ---- the other two problem classes, against their own dt budgets -----
    multiclass = {}
    if os.environ.get("BENCH_MULTICLASS", "1") != "0":
        for name in ("pointRobot", "boxer"):
            if _any_rank(remaining() < 180.0, mesh):
                multiclass["multiclass_skipped"] = "time budget"
                break
            # the set-up makes no collective: a failure on any rank ends the
            # extra on every rank
            try:
                prob_c, _ = _load_problem(name)
                b_c = pad_batch_to_mesh(min(1024, batch), mesh)
                runner_c = FleetRunner(prob_c, batch_size=b_c, mesh=mesh)
                sc = runner_c.shard_scenario(_scenario_for(prob_c, b_c, name))
                st = runner_c.init_state(sc)
                _build_kernels(prob_c, mesh.device)
            except Exception as e:  # noqa: BLE001 - recorded, and the exit code says so
                traceback.print_exc()
                multiclass["multiclass_error"] = repr(e)[:200]
            if _any_rank("multiclass_error" in multiclass, mesh):
                multiclass.setdefault("multiclass_error", f"{name} set-up failed on another rank")
                failed = True
                break
            try:
                _, m, dt_c, counts = _warm_and_measure(runner_c, st, sc, 10, warmup_max, {})
            except Exception as e:  # noqa: BLE001 - recorded, and the exit code says so
                # a peer may wait in this step's collective, which only this
                # process's exit ends: this rank makes no collective any more
                traceback.print_exc()
                multiclass["multiclass_error"] = repr(e)[:200]
                broken = grouped
                failed = True
                break
            multiclass[f"{name}_solves_per_s_per_chip"] = round(b_c * 10 / dt_c / n_chips, 1)
            multiclass[f"{name}_converged_fraction"] = round(float(m.converged_fraction), 4)
            for kernel, n in counts.items():
                riccati_launches[kernel][name] = n

    if grouped and not broken:
        failed = _any_rank(failed, mesh)  # every rank's exit code says it
    result["extra"].update(latency)
    result["extra"].update(multiclass)
    result["extra"]["bench_wall_s"] = round(_elapsed(), 1)
    # final enriched line: the last JSON line is the result
    if rank0:
        print(json.dumps(result), flush=True)
    if grouped and not broken:
        distributed.shutdown()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
