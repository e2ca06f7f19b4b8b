"""The fleet driver: ``FleetRunner.step`` over B lanes under staggered task
resets.

Every lane runs tasks of ``reset_period`` (P) control steps: lane ``i``
starts a new task at each global step ``t`` with ``(t + i) mod P == 0``, so
B/P lanes reset a step. Lane ``i``'s task at step ``t`` is its
``((t + i mod P) // P) mod tasks_per_lane``-th, from the traffic's fixed
pool dealt to the lanes by the seed (``sampler.fleet_tasks``). The reset lanes'
state is the port's ``init_state`` of the new scenario rows, merged on the
device. Each step ends with the new plant
state (the commands a controller sends) copied to the host.

Set-up builds the runner, draws and packs the task bank, and runs
``warmup_steps`` steps (the first captures the step's CUDA graph), so that
the lanes' task ages are spread evenly when the window opens.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from mpcbench import sampler
from mpcbench.drivers import setup_of


def reset_lanes(t: int, B: int, P: int) -> np.ndarray:
    """The lanes that start a new task at global step ``t`` (none at 0,
    where every lane starts its first)."""
    return np.arange((-t) % P, B, P) if t > 0 else np.zeros(0, np.int64)


def task_index(t: int, lanes: np.ndarray, P: int, K: int) -> np.ndarray:
    """Each lane's task index at global step ``t``, cycling over ``K``."""
    return ((t + lanes % P) // P) % K


class FleetDriver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, robot, control=None, fault=None):
        from robot_mpcs_tpu_torch.models.problem import MpcProblem
        from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario

        self._Scenario = FleetScenario
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.robot, self.control, self.fault = robot, control, fault
        self.B, self.P = int(traffic["batch"]), int(traffic["reset_period"])
        self.K = int(traffic["tasks_per_lane"])
        self.problem = MpcProblem(setup_of(cfg, fault))
        self.runner = FleetRunner(self.problem, self.B, device=self.device, **traffic["runner"])
        self.tasks = sampler.fleet_tasks(cfg, robot, traffic, seed)  # row lane * K + k
        self._pack_bank()
        self.phase_lanes = [torch.arange(r, self.B, self.P, device=self.device) for r in range(self.P)]
        self.t = 0
        self.step_s: List[float] = []
        self.enqueue_s: List[float] = []
        self.snaps: Dict[int, Dict] = {}
        first = torch.arange(self.B, device=self.device) * self.K
        self.scen = FleetScenario(xinit=self.xbank[first].clone(), params=self._params_rows(first))
        self.state = self.runner.init_state(self.scen)
        f64 = dict(dtype=torch.float64, device=self.device)
        self._acc = {"converged": torch.zeros((), **f64), "iterations": torch.zeros((), **f64),
                     "failed": torch.zeros((), **f64)}
        self._host_x = torch.empty((self.B, robot.nx), dtype=torch.float32,
                                   pin_memory=self.device.type == "cuda")

    # --------------------------------------------------------------- inputs

    def _pack_bank(self):
        """Each task's stage parameters in the program's layout (its
        ``param_map``, as ``random_fleet_scenario`` fills it)."""
        pm, tasks, T = self.problem.param_map, self.tasks, len(self.tasks["x0"])
        par = np.zeros((T, self.problem.npar), np.float32)

        def put(name, v):
            if name in pm.entries:
                start, k = pm.entries[name]
                par[:, start:start + k] = np.asarray(v, np.float32).reshape(T, k)

        put("wgoal", tasks["wgoal"])
        put("wu", tasks["wu"])
        put("wconstr", np.tile(np.asarray(self.cfg["mpc"]["weights"]["wconstr"], np.float32), (T, 1)))
        put("goal", tasks["goal"])
        put("r_body", tasks["r_body"])
        put("obst", tasks["obst"])
        for i in range(self.robot.n_obst):
            put(f"lin_constrs_{i}", tasks["planes"][:, i])
        put("lower_limits", tasks["q_lim"][..., 0])
        put("upper_limits", tasks["q_lim"][..., 1])
        put("lower_limits_u", tasks["u_lim"][..., 0])
        put("upper_limits_u", tasks["u_lim"][..., 1])
        self.xbank = torch.as_tensor(tasks["x0"], device=self.device)
        self.pbank = torch.as_tensor(par, device=self.device)

    def _params_rows(self, rows):
        return self.pbank[rows][:, None, :].expand(-1, self.robot.N, -1).contiguous()

    def task_rows(self, t: int) -> np.ndarray:
        """Each lane's task row at global step ``t``."""
        lanes = np.arange(self.B)
        return lanes * self.K + task_index(t, lanes, self.P, self.K)

    def _reset(self):
        """Merge fresh tasks into the lanes whose period starts now."""
        r = (-self.t) % self.P
        lanes = self.phase_lanes[r]
        rows = lanes * self.K + int(task_index(self.t, np.array([r]), self.P, self.K)[0])
        fresh = self._Scenario(xinit=self.xbank[rows], params=self._params_rows(rows))
        init = self.runner.init_state(fresh)
        s = self.state
        self.scen = self._Scenario(xinit=self.scen.xinit.index_copy(0, lanes, fresh.xinit),
                                   params=self.scen.params.index_copy(0, lanes, fresh.params))
        self.state = type(s)(*(v if f == "step" else v.index_copy(0, lanes, getattr(init, f))
                               for f, v in zip(s._fields, s)))

    # ----------------------------------------------------------------- steps

    def _one_step(self, record: bool):
        t0 = time.perf_counter()
        if self.t > 0:
            self._reset()
        state, scen = self.state, self.scen
        if self.control is not None:
            state, scen = self.control.inputs(state, scen)
        step = self.fault.fleet_step if self.fault is not None else None
        if step is not None:
            new, metrics, flags = step(self.runner, state, scen)
        else:
            new, metrics = self.runner.step(state, scen)
            flags = self.runner._last_program.carry["exitflag"]
        t1 = time.perf_counter()
        acc = self._acc
        acc["converged"] += metrics.converged_fraction.double() * self.B
        acc["iterations"] += metrics.mean_iterations.double() * self.B
        finite = (torch.isfinite(new.x).all(-1) & torch.isfinite(new.z_warm).flatten(1).all(-1)
                  & torch.isfinite(new.lam).flatten(1).all(-1))
        acc["failed"] += ((flags == -1) | ~finite).sum().double()
        if self.control is not None:
            new = self.control.outputs(new)
        # the newest step is held until the next: the window's last is compared
        self._last = (self.t, {"in": state, "out": new, "flags": flags.clone(),
                               "converged_fraction": metrics.converged_fraction.clone()})
        if record and self.t in self.check_at:
            self.snaps[self.t] = self._last[1]
        self._host_x.copy_(new.x, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t2 = time.perf_counter()
        self.state = new
        self.t += 1
        return t2 - t0, t1 - t0

    def warmup(self):
        for _ in range(int(self.traffic["warmup_steps"])):
            self._one_step(record=False)

    def window(self, seconds: float):
        """Steps until ``seconds`` have passed; returns the window's length."""
        rng = np.random.default_rng([self.seed, 1])
        span = int(self.traffic["check_span"])
        picks = rng.choice(span, size=int(self.traffic["check_steps"]), replace=False)
        self.t_open = self.t
        self.check_at = {self.t + int(j) for j in picks}
        for v in self._acc.values():
            v.zero_()
        start = time.perf_counter()
        while True:
            dt, enq = self._one_step(record=True)
            self.step_s.append(dt)
            self.enqueue_s.append(enq)
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        self.snaps[self._last[0]] = self._last[1]
        self.n_steps = len(self.step_s)
        return elapsed

    def totals(self) -> Dict[str, float]:
        acc = {k: float(v) for k, v in self._acc.items()}
        return {"attempted": self.n_steps * self.B, "converged": acc["converged"],
                "failed": int(round(acc["failed"])), "iterations": acc["iterations"]}

    def profiled_calls(self):
        """One step from the current state as a callable (``trace.py``):
        the same step function, from a fixed input, again each call."""
        state, scen = self.state, self.scen

        def call():
            return self.runner.step(state, scen)

        return call

    def release(self):
        """Drop the program (runner, graphs, pools) and keep the snapshots
        and the window's totals."""
        self.runner = None
        self.problem = None
        self.state = self.scen = None
        self.xbank = self.pbank = None
