"""The comparison's control and its faults, all on the harness's side.

``Bf16`` stands for the program computing in bfloat16, the precision below
the float32 the configuration states: every input the program is handed
(the plant state, the carried warm start and multipliers, the task's
parameters) and every output it returns (the new state, the plan, the
action) is rounded to bfloat16. The comparison has to find such a run not
correct (``PERF.md``). No benchmark run uses it: ``run.py --control bf16``
and the tests do.

The faults break the timed path underneath the harness, for the test that
sees ``correct`` come out false (``tests/test_mpcbench_runs.py``):

* ``unchanged``: the step (or solve) hands back its input state (plan);
* ``half``: half of the batch is left out and the metrics are taken over
  the rest;
* ``altered``: one lane's new state (the action) is altered where it is
  produced;
* ``truncated``: the solver stops after one iteration (its iteration caps,
  ``solver.max_al_iterations`` and ``max_ilqr_iterations``, set to 1): its
  solves come back early with exit flag 0, as a solver cut short to run
  faster would.
"""

from __future__ import annotations

import numpy as np
import torch


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def _bf16_np(a):
    return _bf16(torch.as_tensor(np.asarray(a, np.float32))).numpy()


class Bf16:
    def inputs(self, state, scen):
        return (type(state)(*(_bf16(t) for t in state)),
                type(scen)(xinit=_bf16(scen.xinit), params=_bf16(scen.params)))

    def outputs(self, state):
        return type(state)(*(_bf16(t) for t in state))

    def task(self, tasks):
        return {k: (_bf16_np(v) if np.asarray(v).dtype.kind == "f" else v) for k, v in tasks.items()}

    def state(self, x):
        return _bf16_np(x).astype(np.float64)

    def plan(self, z):
        return _bf16_np(z)


CONTROLS = {"bf16": Bf16}


class Fault:
    """One fault planted under the timed call (``FAULTS``)."""

    def __init__(self, kind: str):
        if kind not in FAULTS:
            raise ValueError(f"unknown fault {kind!r}; have {FAULTS}")
        self.kind = kind
        #: solver knobs the drivers apply when they build the program
        self.solver = {"max_al_iterations": 1, "max_ilqr_iterations": 1} if kind == "truncated" else None
        self._prev = None
        self._half = None  # the half batch's runner

    def fleet_step(self, runner, state, scen):
        if self.kind == "half":
            B = state.x.shape[0]
            h = B // 2
            if self._half is None:
                from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner

                self._half = FleetRunner(runner.problem, h, device=runner.device, compaction_ratio=0)
            sub = type(state)(*(t if t.dim() == 0 else t[:h] for t in state))
            new_h, metrics = self._half.step(sub, type(scen)(scen.xinit[:h], scen.params[:h]))
            flags_h = self._half._last_program.carry["exitflag"]
            new = type(state)(*(n if n.dim() == 0 else torch.cat([n, o[h:]]) for n, o in zip(new_h, state)))
            flags = torch.cat([flags_h, torch.ones_like(flags_h[: B - h])])
            return new, metrics, flags
        new, metrics = runner.step(state, scen)
        flags = runner._last_program.carry["exitflag"]
        if self.kind == "unchanged":
            return state, metrics, flags
        if self.kind == "truncated":
            return new, metrics, flags
        x = new.x.clone()
        x[0] += 0.01
        return new._replace(x=x), metrics, flags

    def planner_solve(self, planner, args):
        action, output, flag = planner.computeAction(*args)
        if self.kind == "truncated":
            return action, output, flag
        if self.kind == "unchanged":
            if self._prev is not None:
                return self._prev
            self._prev = (action, output, flag)
            return action, output, flag
        action = np.array(action, np.float32)
        action[0] += 0.01
        return action, output, flag


FAULTS = ("unchanged", "half", "altered", "truncated")
#: the faults each driver's cells can have: a planner has no batch to halve
DRIVER_FAULTS = {"fleet": FAULTS, "planner": ("unchanged", "altered", "truncated")}
