"""The planner driver: ``MPCPlanner.computeAction`` on one robot, one solve
after another, a new task every ``reset_period`` (P) solves.

A task is set through the planner's public ``reset`` and setters, as the
examples do (``robot_mpcs_tpu_torch/examples/mpc_example.py:95-130``). The
plant between solves is the benchmark's own integrator of the
configuration's dynamics (``reference/model.py``, float64): the planner gets
the state as the robot would report it, and its action is applied. The
run's ``tasks`` tasks are drawn from the seed (``sampler.draw_tasks``, lane
0's k-th task a function of (seed, 0, k)), then run again from the first.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from mpcbench import sampler
from mpcbench.drivers import setup_of


class _Sphere:
    def __init__(self, pos, radius):
        self._p, self._r = [float(v) for v in pos], float(radius)

    def position(self):
        return self._p

    def radius(self):
        return self._r

    def dimension(self):
        return 3


class PlannerDriver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, robot, control=None, fault=None):
        from robot_mpcs_tpu_torch.models.problem import MpcProblem
        from robot_mpcs_tpu_torch.planner.mpc_planner import MPCPlanner

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.robot, self.control, self.fault = robot, control, fault
        self.P, self.K = int(traffic["reset_period"]), int(traffic["tasks"])
        self.planner = MPCPlanner(MpcProblem(setup_of(cfg, fault)), device=self.device)
        self.tasks = sampler.draw_tasks(cfg, robot, seed, [(0, k) for k in range(self.K)])
        self.t = 0
        self.x = None
        self.solve_s: List[float] = []
        self.records: List[Dict] = []
        self.failed = 0

    def task_row(self, t: int) -> int:
        return (t // self.P) % self.K

    def _set_task(self, row: int):
        tk, p, r = self.tasks, self.planner, self.robot
        if self.control is not None:
            tk = self.control.task(tk)
        rb = float(tk["r_body"][row])
        p.reset()
        p.setGoalReaching(tk["goal"][row])
        p.setConstraintAvoidance()
        for name in r.constraints:
            if name == "RadialConstraints":
                p.setRadialConstraints([_Sphere(o[:3], o[3]) for o in tk["obst"][row]], rb)
            elif name == "LinearConstraints":
                p.setLinearConstraints(np.broadcast_to(tk["planes"][row], (r.N,) + tk["planes"][row].shape), rb)
            elif name == "SelfCollisionAvoidanceConstraints":
                p.setSelfCollisionAvoidanceConstraints(rb)
            elif name == "JointLimitConstraints":
                p.setJointLimits((tk["q_lim"][row, :, 0], tk["q_lim"][row, :, 1]))
            elif name == "InputLimitConstraints":
                p.setInputLimits((tk["u_lim"][row, :, 0], tk["u_lim"][row, :, 1]))
        p.concretize()
        self.x = self.tasks["x0"][row].astype(np.float64)

    def _one_solve(self, record: bool):
        t0 = time.perf_counter()
        if self.t % self.P == 0:
            self._set_task(self.task_row(self.t))
        n, x = self.robot.n, self.x
        seen = x if self.control is None else self.control.state(x)
        args = (seen[:n], seen[n:2 * n]) if self.robot.base == "holonomic" else (seen[:n], seen[n:2 * n], seen[2 * n:])
        try:
            if self.fault is not None:
                action, output, flag = self.fault.planner_solve(self.planner, args)
            else:
                action, output, flag = self.planner.computeAction(*args)
        except Exception:  # noqa: BLE001 - a raised call is a failed solve, counted
            action, output, flag = np.zeros(self.robot.nu), {}, -2
        dt = time.perf_counter() - t0
        z = np.stack([output[k] for k in sorted(output)]) if output else None
        if self.control is not None and z is not None:
            z, action = self.control.plan(z), self.control.plan(np.asarray(action))
        if z is None or flag == -1 or not (np.isfinite(z).all() and np.isfinite(action).all()):
            self.failed += 1
        if record:
            info = getattr(self.planner, "_last_info", None)
            self.records.append({"t": self.t, "x": x.copy(), "z": z, "action": np.asarray(action, np.float32),
                                 "flag": int(flag), "task": self.task_row(self.t),
                                 "iterations": int(info.iterations) if info is not None and flag != -2 else None})
        a = torch.as_tensor(np.asarray(action, np.float64))
        self.x = self.robot.step(torch.as_tensor(x)[None], a[None])[0].numpy()
        self.t += 1
        return dt

    def warmup(self):
        for _ in range(int(self.traffic["warmup_solves"])):
            self._one_solve(record=False)
        self.failed = 0

    def window(self, seconds: float):
        start = time.perf_counter()
        while True:
            self.solve_s.append(self._one_solve(record=True))
            if time.perf_counter() - start >= seconds:
                break
        self.n_steps = len(self.solve_s)
        return time.perf_counter() - start

    def totals(self) -> Dict[str, float]:
        its = [r["iterations"] for r in self.records if r["iterations"] is not None]
        return {"attempted": len(self.solve_s),
                "converged": sum(r["flag"] == 1 for r in self.records),
                "failed": self.failed,
                "iterations": float(sum(its))}

    def profiled_calls(self):
        """One solve of the window's last task from a fixed input, as a
        callable (``trace.py``): the last solve's state, its plan shifted
        by a stage as the warm start, no multipliers, through the solver
        ``computeAction`` calls (``solve_batch``, B=1)."""
        last = self.records[-1]
        z0 = np.concatenate([last["z"][1:], last["z"][-1:]])[None]
        xinit = last["x"][None].astype(np.float32)
        params = self.planner.params[None]

        def call():
            return self.planner.solve_batch(xinit, params, z0, None)

        return call

    def release(self):
        self.planner = None
