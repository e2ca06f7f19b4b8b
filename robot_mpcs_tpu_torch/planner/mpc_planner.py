"""Receding-horizon MPC planner — the runtime engine (port of
``robot_mpcs_tpu.planner.mpc_planner``).

The same public surface as the reference ``robotmpcs/planner/mpcPlanner.py``:
parameter setters writing a host ``[N, npar]`` buffer through the paramMap
ABI, ``reset`` / ``concretize`` / ``solve`` / ``computeAction`` with interval
decimation, and the warm-start modes ``current_state`` / ``previous_plan``.
A solve is one call of the problem's batch-first solver
(``MpcProblem.build_solver``) at B = 1 on the planner's device; the buffers
are built on the host and moved to the device once per solve. ``solve_batch``
calls the same solver for any B.

Reference bugs intentionally fixed (documented, not replicated):
* ``updateDynamicObstacles`` reads obstacle 0's data for every slot
  (``mpcPlanner.py:148-150``); here slot j reads block j.
* duplicate dead ``concretize`` (``mpcPlanner.py:212-213``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from robot_mpcs_tpu_torch.config import Setup
from robot_mpcs_tpu_torch.models.params import (
    EMPTY_OBSTACLE_POSITION,
    EMPTY_OBSTACLE_RADIUS,
)
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.solver.types import SolveResult
from robot_mpcs_tpu_torch.utils.devices import resolve_device


class SolverDoesNotExistError(Exception):
    """Raised when a named solver artifact directory is missing
    (reference ``mpcPlanner.py:10-16``)."""

    def __init__(self, solver_name):
        super().__init__()
        self._solver_name = solver_name

    def __str__(self):
        return f"Solver with name {self._solver_name} does not exist."


class EmptyObstacle:
    """Padding obstacle (reference ``mpcPlanner.py:18-26``): position/radius
    -100 deactivates the clearance constraint while keeping fixed shapes."""

    def position(self) -> List[float]:
        return [EMPTY_OBSTACLE_POSITION] * 3

    def radius(self) -> float:
        return EMPTY_OBSTACLE_RADIUS

    def dimension(self) -> int:
        return 3

    def dim(self) -> int:
        return 3


class MPCPlanner:
    """Single-scenario receding-horizon planner over the batched solver.

    ``device`` is where the solver runs: the CUDA card by default, ``"cpu"``
    for the CPU; asking for CUDA on a machine without it raises.
    ``solver_dir`` names the artifact directory the problem was read from
    (``from_solver_dir``). On the card, the kernel library exported there
    (``MpcProblem.generate_solver(..., export=True)``) is loaded before the
    solver is built, so the first solve builds no kernel; without a matching
    export the kernel is built into the kernel cache
    (``utils/compile_cache.py``), which must then be writable.
    """

    def __init__(
        self,
        problem: MpcProblem,
        debug: bool = False,
        solver_dir: Optional[str] = None,
        device="cuda",
    ):
        self._problem = problem
        self._config = problem.mpc
        self._debug = debug
        self._solver_dir = solver_dir
        self._device = resolve_device(device)
        self._dims = problem.dims
        self._param_map = problem.param_map
        self._npar = problem.npar
        self._nx, self._nu, self._ns = self._dims.nx, self._dims.nu, self._dims.ns
        self._N = self._dims.N
        self._r = 0.1  # default dynamic-obstacle radius (mpcPlanner.py:121)
        if self._device.type == "cuda":
            # the exported kernels (the ForcesPro ``Solver.from_directory``
            # analog, reference mpcPlanner.py:73), else the kernel cache
            from robot_mpcs_tpu_torch.utils import aot, compile_cache

            if solver_dir is None or aot.load_planner_solve(problem, solver_dir, self._device) is None:
                compile_cache.enable_compile_cache()
        # one batch-first solver serves solve (B = 1) and solve_batch (any B)
        self._solve_batch_fn = problem.build_solver(device=self._device)
        self.reset()
        self.concretize()

    # ------------------------------------------------------------- factory

    @classmethod
    def from_setup(cls, setup: Setup, debug: bool = False, device="cuda") -> "MPCPlanner":
        return cls(MpcProblem(setup), debug=debug, device=device)

    @classmethod
    def from_solver_dir(
        cls, robot_type: str, solvers_dir: str, debug: bool = False, device="cuda",
        **mpc_config,
    ) -> "MPCPlanner":
        """Reference-compatible constructor (``mpcPlanner.py:32-56``): rebuild
        the artifact directory name from config fields and load it."""
        dt_str = str(mpc_config["time_step"]).replace(".", "")
        name = (
            f"{robot_type}_n{mpc_config['n']}_{dt_str}_H{mpc_config['time_horizon']}"
        )
        if not mpc_config.get("slack", False):
            name += "_noSlack"
        path = os.path.join(solvers_dir, name)
        if not os.path.isdir(path):
            raise SolverDoesNotExistError(path)
        return cls(MpcProblem.from_solver_dir(path), debug=debug, solver_dir=path, device=device)

    # --------------------------------------------------------------- state

    def reset(self) -> None:
        """Zero trajectory/multipliers and pack static weights
        (reference ``mpcPlanner.py:83-108``: wgoal <- weights['w'],
        wu <- weights['wu'], ws <- weights['ws'])."""
        dims = self._dims
        self._x0 = np.zeros((self._N, dims.nz), dtype=np.float32)
        self._xinit = np.zeros(self._nx, dtype=np.float32)
        self._lam = np.zeros((self._N, self._problem.n_con), dtype=np.float32)
        self._initial_step = True
        self._slack = 0.0
        self.output: Dict[str, np.ndarray] = {}
        self._params = np.zeros((self._N, self._npar), dtype=np.float32)
        pm = self._param_map
        weights = self._config.weights
        if "wgoal" in pm:
            pm.set_np(self._params, "wgoal", weights["w"])
        if "wu" in pm:
            pm.set_np(self._params, "wu", weights["wu"])
        if self._config.slack and "ws" in pm:
            pm.set_np(self._params, "ws", weights["ws"])

    def concretize(self) -> None:
        self._actionCounter = self._config.interval

    def m(self) -> int:
        return self._dims.m

    # ----------------------------------------------------- parameter setters
    # All write the host [N, npar] buffer through the paramMap, like the
    # reference's stage loops (mpcPlanner.py:120-210) but vectorized.

    def setGoalReaching(self, goal_position) -> None:
        goal = np.zeros(self.m(), dtype=np.float32)
        k = min(len(goal_position), self.m())
        goal[:k] = np.asarray(goal_position, dtype=np.float32)[:k]
        self._param_map.set_np(self._params, "goal", goal)

    def setRadialConstraints(self, obsts, r_body: float) -> None:
        self._r = 0.1
        self._param_map.set_np(self._params, "r_body", r_body)
        m = self.m()
        vals = np.zeros((self._dims.n_obst, m + 1), dtype=np.float32)
        for j in range(self._dims.n_obst):
            obst = obsts[j] if j < len(obsts) else EmptyObstacle()
            vals[j, :m] = np.asarray(obst.position())[:m]
            vals[j, m] = obst.radius()
        self._param_map.set_np(self._params, "obst", vals.reshape(-1))

    def setLinearConstraints(self, lin_constr, r_body: float) -> None:
        """``lin_constr[stage][slot]`` = plane [a, b, c, d]
        (reference ``mpcPlanner.py:135-141``) — per-stage planes."""
        self._param_map.set_np(self._params, "r_body", r_body)
        for j in range(self._N):
            for i in range(self._dims.n_obst):
                self._param_map.set_np(
                    self._params, f"lin_constrs_{i}", lin_constr[j][i], stage=j
                )

    def setSelfCollisionAvoidanceConstraints(self, r_body: float) -> None:
        self._param_map.set_np(self._params, "r_body", r_body)

    def setJointLimits(self, limits) -> None:
        self._param_map.set_np(self._params, "lower_limits", np.asarray(limits[0]))
        self._param_map.set_np(self._params, "upper_limits", np.asarray(limits[1]))

    def setVelLimits(self, limits_vel) -> None:
        self._param_map.set_np(self._params, "lower_limits_vel", np.asarray(limits_vel[0])[:2])
        self._param_map.set_np(self._params, "upper_limits_vel", np.asarray(limits_vel[1])[:2])

    def setInputLimits(self, limits_u) -> None:
        self._param_map.set_np(self._params, "lower_limits_u", np.asarray(limits_u[0]))
        self._param_map.set_np(self._params, "upper_limits_u", np.asarray(limits_u[1]))

    def setConstraintAvoidance(self) -> None:
        self._param_map.set_np(
            self._params, "wconstr", np.asarray(self._config.weights["wconstr"])
        )

    def updateDynamicObstacles(self, obstArray: np.ndarray) -> None:
        """Constant-acceleration extrapolation over the horizon
        (reference ``mpcPlanner.py:144-161``): obstacle j's block is
        ``[pos(m), vel(m), acc(m)]``; stage i gets
        ``p + v dt i + 0.5 a (dt i)^2``."""
        m = self.m()
        obstArray = np.asarray(obstArray, dtype=np.float32).reshape(-1)
        nb = int(obstArray.size / (3 * m))
        dt = self._config.time_step
        start, _ = self._param_map.entries["obst"]
        t = dt * np.arange(self._N, dtype=np.float32)  # (N,)
        for j in range(self._dims.n_obst):
            if j < nb:
                block = obstArray[j * 3 * m : (j + 1) * 3 * m]
                pos, vel, acc = block[:m], block[m : 2 * m], block[2 * m :]
                pred = pos[None, :] + vel[None, :] * t[:, None] + 0.5 * acc[None, :] * t[:, None] ** 2
                radius = self._r
            else:
                pred = np.full((self._N, m), EMPTY_OBSTACLE_POSITION, dtype=np.float32)
                radius = EMPTY_OBSTACLE_RADIUS
            base = start + j * (m + 1)
            self._params[:, base : base + m] = pred
            self._params[:, base + m] = radius

    # ----------------------------------------------------------- warm start

    def shiftHorizon(self, z_prev: np.ndarray) -> None:
        """Shift the previous plan by one stage (reference
        ``mpcPlanner.py:215-226``): x0[k] = prev[k+1], last row repeated."""
        self._x0[:-1] = z_prev[1:]
        self._x0[-1] = z_prev[-1]

    def setX0(self, initialize_type: str = "current_state", initial_step: bool = True) -> None:
        if initialize_type == "current_state" or (
            initialize_type == "previous_plan" and initial_step
        ):
            self._x0[:, : self._nx] = self._xinit
            self._x0[:, self._nx :] = 0.0
            self._initial_step = False
        elif initialize_type == "previous_plan":
            self.shiftHorizon(self._z_prev)
        else:
            self._x0[:] = 0.0

    # ----------------------------------------------------------------- solve

    def _stage_key(self, stage: int) -> str:
        """ForcesPro-style output keys x1/x01/x001 (mpcPlanner.py:265-273)."""
        if self._N < 10:
            return f"x{stage}"
        if self._N < 100:
            return f"x{stage:02d}"
        return f"x{stage:03d}"

    def solve(self, ob: np.ndarray) -> Tuple[np.ndarray, dict, SolveResult, int]:
        """One receding-horizon solve (reference ``mpcPlanner.py:240-288``).
        Returns (action, output, lane-0 SolveResult on the device, exitflag)."""
        ob = np.asarray(ob, dtype=np.float32).reshape(-1)
        self._xinit = ob[: self._nx]
        if ob.size > self._nx:
            self.updateDynamicObstacles(ob[self._nx :])
        self.setX0(self._config.initialization, self._initial_step)

        dev = self._device
        batched = self._solve_batch_fn(
            *(torch.from_numpy(np.array(a, dtype=np.float32))[None].to(dev)
              for a in (self._xinit, self._params, self._x0, self._lam))
        )
        result = SolveResult(*(f[0] for f in batched))
        # one device-to-host copy per field read on the host
        z = result.z.cpu().numpy()
        lam = result.lam.cpu().numpy()
        exitflag = int(result.exitflag)
        self._z_prev = z
        # shift-align the multiplier warm start with the shift-horizon
        # trajectory warm start (stage k's multipliers belong to next step's
        # stage k-1; the fleet runner does the same, parallel/fleet.py)
        self._lam = np.concatenate([lam[1:], lam[-1:]], axis=0)
        self.output = {self._stage_key(k + 1): z[k] for k in range(self._N)}

        if self._config.control_mode == "vel":
            # velocity block of stage 2 (mpcPlanner.py:275-276). The
            # reference's slice z[-2nu:-nu] silently grabs the wrong block
            # when slack is enabled (the slack variable sits between x and
            # u); skipping ns entries keeps the same semantics ("the nu
            # velocity states preceding the controls") for every ns.
            lo = -(2 * self._nu + self._ns)
            hi = -(self._nu + self._ns)
            action = z[1][lo:hi]
        elif self._config.control_mode == "acc":
            action = z[0][-self._nu :]
        else:
            action = np.zeros(self._nu)
        if self._config.slack:
            self._slack = float(z[0][self._nx])
        return np.asarray(action), self.output, result, exitflag

    def computeAction(self, *args) -> Tuple[np.ndarray, dict, int]:
        """Interval-decimated action (reference ``mpcPlanner.py:293-301``):
        re-solve every ``interval`` steps, replay the cached action otherwise."""
        ob = np.concatenate([np.asarray(a, dtype=np.float32).reshape(-1) for a in args[:3]])
        if self._actionCounter >= self._config.interval:
            self._action, self._last_output, self._last_info, self._last_exitflag = self.solve(ob)
            self._actionCounter = 1
        else:
            self._actionCounter += 1
        return self._action, self._last_output, self._last_exitflag

    # ----------------------------------------------------------- batched API

    def solve_batch(self, xinit, params, z0, lam0) -> SolveResult:
        """Batched solve over B scenarios on the planner's device: xinit
        (B, nx), params (B, N, npar), z0 (B, N, nz), lam0 (B, N, n_con), as
        numpy arrays or tensors. Returns the batched SolveResult."""
        return self._solve_batch_fn(xinit, params, z0, lam0)

    @property
    def params(self) -> np.ndarray:
        return self._params
