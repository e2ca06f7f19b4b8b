"""The benchmark's window at the benchmark's width, both packages on the CPU:
a fleet of the bench (the panda by default, or the bench's pointRobot extra)
with ``bench.py``'s runner defaults (the 1/8 rescue tier, the kick), stepped
lane for lane.

    PYTHONPATH=. python tests/torch_bench_window.py [--robot panda|pointRobot] [--batch 1024]
                                                    [--steps 38] [--threads 4] [--kick-after 25]

Both fleets start from ``bench._scenario_for(..., robot)`` (the JAX
package's draw, handed to the port through ``interop``) and take
``--steps`` steps: ``bench.py``'s window is up to 8 warm-up steps, then 30
timed. One JSON line per step with each package's converged fraction, mean
iterations, mean goal distance, rescue overflow fraction and kicked lanes,
and, for the lanes both kick at that step, the largest difference of the
two noises: each package's warm start less its unkicked shift (the port's
from its step, the JAX fleet's from a second JAX runner without the kick,
stepped from the same state). The last line sums up the window
(``WINDOW``: steps 8-37): its means per package, the largest per-step gaps
and the kicked counts' largest difference.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import warnings

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

import bench
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.fleet import FleetState as JaxState
from robot_mpcs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from robot_mpcs_tpu_torch import bench as tbench
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner

#: ``bench.py``'s window: 8 warm-up steps at most, then the 30 timed
WINDOW = (8, 38)
FIELDS = ("converged_fraction", "mean_iterations", "mean_goal_distance", "rescue_overflow_fraction")
PLATEAU = np.float32(5e-3)  # robot_mpcs_tpu/parallel/fleet.py:309


def kicked(prev, new, kick_after):
    """Lanes kicked by the step from ``prev`` to ``new`` (numpy state dicts):
    ``no_improve`` reached ``kick_after`` and fell to 0 without an
    improvement of the best goal distance (fleet.py:309-319)."""
    improved = new["best_gdist"] < prev["best_gdist"] - PLATEAU
    return (prev["no_improve"] + 1 >= kick_after) & (new["no_improve"] == 0) & ~improved


def _numpy_state(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def jax_fleet(problem, batch, scenario, n_devices=1, **runner_kw):
    """A JAX ``FleetRunner`` on ``n_devices`` CPU devices with ``scenario``;
    returns its initial state (numpy) and ``step(runner_kw, state) ->
    (state, metrics)`` on numpy states of the whole batch (the step donates
    its input). The step counter is replicated as the step returns it, so
    the step compiles once per ``runner_kw``."""
    mesh = jax_make_mesh(devices=jax.devices()[:n_devices])
    runners = {}

    def runner(kw):
        key = tuple(sorted(kw.items()))
        if key not in runners:
            runners[key] = JaxRunner(problem, batch, mesh=mesh, **kw)
        return runners[key]

    first = runner(runner_kw)
    sc = first.shard_scenario(scenario)
    state = first.init_state(sc)
    state = state._replace(step=jax.device_put(state.step, NamedSharding(mesh, PartitionSpec())))
    shardings = {k: v.sharding for k, v in state._asdict().items()}

    def step(kw, state):
        args = JaxState(**{k: jax.device_put(v, shardings[k]) for k, v in state.items()})
        new, m = runner(kw).step(args, sc)
        return _numpy_state(new), {k: float(v) for k, v in m._asdict().items()}

    return _numpy_state(state), step


def record_shifts(runner):
    """Make the port's ``runner`` keep, for each step, its shifted warm start
    before the kick's noise and its kick flags (numpy); returns that list."""
    post_step, shifts = runner._post_step, []

    def recording_post_step(*args):
        out = post_step(*args)
        shifts.append((out[1].cpu().numpy(), out[-1].cpu().numpy()))
        return out

    runner._post_step = recording_post_step
    return shifts


def run(batch: int, steps: int, kick_after: int = 25, robot: str = "panda", jax_riccati: str = "auto"):
    """Yield one record per step of ``robot``'s fleet (see the module
    docstring); the JAX solver's Riccati backward is ``jax_riccati``
    (``"auto"``: the scan on the CPU; ``"pallas"``: the Pallas kernels its
    fleet runs on its accelerator, in interpret mode on the CPU)."""
    warnings.simplefilter("ignore")
    jp, _ = bench._load_problem(robot)
    jp.setup.solver = dataclasses.replace(jp.setup.solver, riccati_backend=jax_riccati)
    scen = bench._scenario_for(jp, batch, robot)
    kick_kw, plain_kw = dict(kick_after=kick_after), dict(kick_after=kick_after, kick_scale=0.0)
    jax_state, jax_step = jax_fleet(jp, batch, scen, **kick_kw)
    tp, _ = tbench._load_problem(robot)
    tr = FleetRunner(tp, batch, device="cpu", kick_after=kick_after)
    shifts = record_shifts(tr)
    tsc = interop.scenario_from_numpy(np.asarray(scen.xinit), np.asarray(scen.params), device="cpu")
    ts = tr.init_state(tsc)
    port_state = interop.state_to_numpy(ts)
    nx = tp.dims.nx

    for t in range(steps):
        t0 = time.perf_counter()
        jax_new, jm = jax_step(kick_kw, jax_state)
        t1 = time.perf_counter()
        ts, m = tr.step(ts, tsc)
        port_new = interop.state_to_numpy(ts)
        t2 = time.perf_counter()
        kj = kicked(jax_state, jax_new, kick_after)
        kp = kicked(port_state, port_new, kick_after)
        both = kj & kp
        noise_err = None
        if both.any():  # the JAX fleet's unkicked shift: its step without the kick
            jax_shift = jax_step(plain_kw, jax_state)[0]["z_warm"]
            jax_noise = (jax_new["z_warm"] - jax_shift)[both][..., nx:]
            port_noise = (port_new["z_warm"] - shifts[-1][0])[both][..., nx:]
            noise_err = float(np.abs(jax_noise - port_noise).max())
        yield {
            "step": t, "jax": {**{k: jm[k] for k in FIELDS}, "kicked": int(kj.sum())},
            "port": {**{k: float(getattr(m, k)) for k in FIELDS}, "kicked": int(kp.sum())},
            "kicked_both": int(both.sum()), "noise_max_abs_diff": noise_err,
            "jax_step_s": t1 - t0, "port_step_s": t2 - t1,
        }
        jax_state, port_state = jax_new, port_new


def summary(records):
    """The window's means per package and the largest gaps."""
    win = [r for r in records if WINDOW[0] <= r["step"] < WINDOW[1]]
    out = {"window": list(WINDOW), "steps_in_window": len(win)}
    for pkg in ("jax", "port"):
        out[pkg] = {k: float(np.mean([r[pkg][k] for r in win])) if win else None for k in FIELDS}
    out["largest_step_gap"] = {
        k: max((abs(r["jax"][k] - r["port"][k]) for r in records), default=None) for k in FIELDS}
    out["kicked_largest_diff"] = max((abs(r["jax"]["kicked"] - r["port"]["kicked"]) for r in records), default=0)
    errs = [r["noise_max_abs_diff"] for r in records if r["noise_max_abs_diff"] is not None]
    out["noise_max_abs_diff"] = max(errs) if errs else None
    out["kicked_both"] = sum(r["kicked_both"] for r in records)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--robot", choices=("panda", "pointRobot"), default="panda")
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=WINDOW[1])
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--kick-after", type=int, default=25, help="bench.py's default: 25")
    parser.add_argument("--jax-riccati", choices=("auto", "pallas"), default="auto")
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    records = []
    for rec in run(args.batch, args.steps, args.kick_after, args.robot, args.jax_riccati):
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print("WINDOW " + json.dumps(summary(records)), flush=True)


if __name__ == "__main__":
    main()
