"""The mixed fleet at its full width, both packages on the CPU: the group
``chip_smoke.group_phase`` runs on the card, stepped lane for lane.

    PYTHONPATH=. python tests/torch_group_window.py [--steps 8] [--threads 4] [--jax-riccati pallas|auto]

Both packages build a ``FleetGroup`` of ``chip_smoke.GROUP_SIZES``
(pointRobot 1024, panda 2048, boxer 1024; each class's setup dict with the
benchmark's weights) at the runner users get by default (each class's 1/8
rescue tier, the kick after 25 steps without improvement) and step the JAX
package's ``mixed_fleet_scenarios(seed=0)`` with the benchmark's samplers
(``chip_smoke.sampler``: class ``i`` drawn at seed ``1000 * i``), handed to
the port through ``interop``. The JAX solver runs the Pallas kernels its
fleet runs on its accelerator, in interpret mode (``--jax-riccati
pallas``, the default; ``auto`` takes the CPU's stage scan, whose
Cholesky solve stops the panda's solves after ~0.8% fewer iterations than
the kernels' LDL^T, ``PERF.md`` §5), the port its Riccati sweeps' plain
versions. One
JSON line per step with each package's converged fraction, mean
iterations, mean goal distance and rescue overflow fraction per class and
over the group (``GroupMetrics.overall``); the last line (``WINDOW``) has
both packages' means over steps 2-7 and the largest per-step gaps.
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

from chip_smoke import GROUP_SIZES, sampler
from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.parallel.fleet import FleetState as JaxState
from robot_mpcs_tpu.parallel.fleet_group import FleetGroup as JaxGroup
from robot_mpcs_tpu.parallel.fleet_group import mixed_fleet_scenarios as jax_mixed
from robot_mpcs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel import FleetGroup
from torch_bench_window import FIELDS

#: the steps whose means are held: 0 and 1 start from a cold warm start
WINDOW = (2, 8)
SETUPS = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}


def _numpy(metrics):
    return {k: float(v) for k, v in metrics._asdict().items()}


def jax_problems(sizes, riccati="auto"):
    """``{class: (JAX MpcProblem, batch)}`` of the classes in ``sizes``, in
    its order, their solvers' Riccati backward ``riccati`` (``"auto"``: the
    scan on the CPU; ``"pallas"``: the JAX package's Pallas kernels, which
    its fleet runs on its accelerator, in interpret mode on the CPU)."""
    out = {}
    for k, b in sizes.items():
        setup = JaxSetup.from_dict(SETUPS[k]())
        setup.solver = dataclasses.replace(setup.solver, riccati_backend=riccati)
        out[k] = (JaxProblem(setup), b)
    return out


def scenarios(jax_sub, seed=0):
    """The JAX package's mixed draw with the benchmark's samplers."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_mixed(jax_sub, seed=seed, sampler_kwargs={k: sampler(k) for k in jax_sub})


def jax_group(jax_sub, scens, **runner_kw):
    """The JAX ``FleetGroup`` on one CPU device over ``scens``; returns its
    initial states (numpy, per class) and ``step(states) -> (states,
    GroupMetrics as floats: {"overall": {...}, class: {...}})`` on numpy
    states (the step donates its input). Each class's step counter stays
    replicated, so each class's step compiles once."""
    mesh = jax_make_mesh(devices=jax.devices()[:1])
    group = JaxGroup(jax_sub, mesh=mesh, **runner_kw)
    sc = group.shard_scenarios(scens)
    states = group.init_states(sc)
    states = {k: s._replace(step=jax.device_put(s.step, NamedSharding(mesh, PartitionSpec())))
              for k, s in states.items()}
    shardings = {k: {f: v.sharding for f, v in s._asdict().items()} for k, s in states.items()}

    def to_numpy(s):
        return {f: np.array(v) for f, v in s._asdict().items()}

    def step(states):
        args = {k: JaxState(**{f: jax.device_put(v, shardings[k][f]) for f, v in s.items()})
                for k, s in states.items()}
        new, m = group.step(args, sc)
        return ({k: to_numpy(s) for k, s in new.items()},
                {"overall": _numpy(m.overall), **{k: _numpy(v) for k, v in m.per_class.items()}})

    return {k: to_numpy(s) for k, s in states.items()}, step


def port_group(sub, scens, **runner_kw):
    """The port's ``FleetGroup`` on the CPU over ``sub`` (``{class: (port
    MpcProblem, batch)}``) and the JAX draw ``scens`` as its scenarios (CPU
    tensors, per class)."""
    group = FleetGroup(sub, device="cpu", **runner_kw)
    tsc = {k: interop.scenario_from_numpy(np.asarray(s.xinit), np.asarray(s.params), device="cpu")
           for k, s in scens.items()}
    return group, tsc


def port_problems(sizes):
    """``{class: (port MpcProblem, batch)}`` of the classes in ``sizes``."""
    return {k: (MpcProblem(Setup.from_dict(SETUPS[k]())), b) for k, b in sizes.items()}


def run(sizes, steps: int, jax_riccati: str = "pallas"):
    """Yield one record per step (see the module docstring)."""
    warnings.simplefilter("ignore")
    jsub = jax_problems(sizes, jax_riccati)
    scens = scenarios(jsub)
    jax_states, jax_step = jax_group(jsub, scens)
    group, tsc = port_group(port_problems(sizes), scens)
    ts = group.init_states(tsc)
    for t in range(steps):
        t0 = time.perf_counter()
        jax_states, jm = jax_step(jax_states)
        t1 = time.perf_counter()
        ts, m = group.step(ts, tsc)
        pm = {"overall": _numpy(m.overall), **{k: _numpy(v) for k, v in m.per_class.items()}}
        t2 = time.perf_counter()
        yield {"step": t, "jax": {c: {k: v[k] for k in FIELDS} for c, v in jm.items()},
               "port": {c: {k: v[k] for k in FIELDS} for c, v in pm.items()},
               "jax_step_s": t1 - t0, "port_step_s": t2 - t1}


def summary(records, window=WINDOW):
    """Both packages' means over ``window`` per class and overall, and the
    largest per-step gaps."""
    win = [r for r in records if window[0] <= r["step"] < window[1]]
    out = {"window": list(window), "steps_in_window": len(win)}
    classes = list(records[0]["jax"]) if records else []
    for pkg in ("jax", "port"):
        out[pkg] = {c: {k: float(np.mean([r[pkg][c][k] for r in win])) if win else None for k in FIELDS}
                    for c in classes}
    out["largest_step_gap"] = {c: {k: max(abs(r["jax"][c][k] - r["port"][c][k]) for r in records)
                                   for k in FIELDS} for c in classes}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=WINDOW[1])
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--jax-riccati", choices=("pallas", "auto"), default="pallas")
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    records = []
    for rec in run(GROUP_SIZES, args.steps, args.jax_riccati):
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print("WINDOW " + json.dumps(summary(records)), flush=True)


if __name__ == "__main__":
    main()
