"""The mobile panda's fleet at its full width, both packages on the CPU: the
fleet ``chip_smoke.mobile_phase`` runs on the card, stepped lane for lane.

    PYTHONPATH=. python tests/torch_mobile_window.py [--batch 1024] [--steps 6] [--threads 4]

Both fleets start from the JAX package's draw of the mobile panda's scenario
(``chip_smoke.mobile_panda_setup``, ``MOBILE_SAMPLER``, seed 0), handed to
the port through ``interop``, and run the default runner (the 1/8 rescue
tier, which overflows at this width until the lanes converge) without the
kick (``kick_scale=0.0``), as ``mobile_phase`` does. On the CPU the JAX
solver takes its scan backward (the Pallas kernel's VMEM budget is passed)
and the port its general sweep's plain version. One JSON line per step with
each package's converged fraction, mean iterations, mean goal distance and
rescue overflow fraction; the last line (``WINDOW``) has both packages' means
over steps 2-5 (``WINDOW``: lanes begin to converge at step 2) and the
largest per-step gaps.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings

import numpy as np
import torch

from chip_smoke import MOBILE_SAMPLER, mobile_panda_setup
from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.parallel.fleet import random_fleet_scenario as jax_scenario
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.config import Setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
from torch_bench_window import FIELDS, jax_fleet

#: the steps whose means are held: 0 and 1 converge no lane in either package
WINDOW = (2, 6)
RUNNER_KW = dict(kick_scale=0.0)  # the default rescue tier, no kick


def problems():
    """The mobile panda in the port and in the JAX package."""
    d = mobile_panda_setup()
    return MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))


def scenario(jp, batch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_scenario(jp, batch, seed=0, **MOBILE_SAMPLER)


def run(batch: int, steps: int):
    """Yield one record per step (see the module docstring)."""
    tp, jp = problems()
    scen = scenario(jp, batch)
    jax_state, jax_step = jax_fleet(jp, batch, scen, **RUNNER_KW)
    tr = FleetRunner(tp, batch, device="cpu", **RUNNER_KW)
    tsc = interop.scenario_from_numpy(np.asarray(scen.xinit), np.asarray(scen.params), device="cpu")
    ts = tr.init_state(tsc)
    for t in range(steps):
        t0 = time.perf_counter()
        jax_state, jm = jax_step(RUNNER_KW, jax_state)
        t1 = time.perf_counter()
        ts, m = tr.step(ts, tsc)
        pm = {k: float(getattr(m, k)) for k in FIELDS}
        t2 = time.perf_counter()
        yield {"step": t, "jax": {k: jm[k] for k in FIELDS}, "port": pm,
               "jax_step_s": t1 - t0, "port_step_s": t2 - t1}


def summary(records, window=WINDOW):
    """Both packages' means over ``window`` and the largest per-step gaps."""
    win = [r for r in records if window[0] <= r["step"] < window[1]]
    out = {"window": list(window), "steps_in_window": len(win)}
    for pkg in ("jax", "port"):
        out[pkg] = {k: float(np.mean([r[pkg][k] for r in win])) if win else None for k in FIELDS}
    out["largest_step_gap"] = {
        k: max((abs(r["jax"][k] - r["port"][k]) for r in records), default=None) for k in FIELDS}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=WINDOW[1])
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    records = []
    for rec in run(args.batch, args.steps):
        records.append(rec)
        print(json.dumps(rec), flush=True)
    print("WINDOW " + json.dumps(summary(records)), flush=True)


if __name__ == "__main__":
    main()
