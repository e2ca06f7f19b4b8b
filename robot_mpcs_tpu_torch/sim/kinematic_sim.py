"""Lightweight kinematic simulator for closed-loop validation (port of
``robot_mpcs_tpu.sim.kinematic_sim``).

Stands in for the reference's gym/pybullet harness (reference
``examples/*_example.py`` run ``urdf-env-v0`` with pybullet) so that
closed-loop MPC runs need no simulator dependency. The plant integrates the
same continuous dynamics as the MPC with a finer integrator (erk4, 16
substeps). The state is a host numpy array; ``step`` runs the port's
dynamics on ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from robot_mpcs_tpu_torch.models.dimensions import ProblemDimensions
from robot_mpcs_tpu_torch.models.dynamics import make_discrete_dynamics
from robot_mpcs_tpu_torch.utils.devices import resolve_device


class KinematicSim:
    """Integrates the robot state under applied controls at the MPC rate."""

    def __init__(
        self,
        dims: ProblemDimensions,
        dt: float,
        substeps: int = 16,
        noise_std: float = 0.0,
        seed: int = 0,
        device="cuda",
    ):
        self.dims = dims
        self.dt = dt
        self._device = resolve_device(device)
        self._step_fn = make_discrete_dynamics(dims, dt, "erk4", substeps=substeps)
        self._noise_std = noise_std
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros(dims.nx, dtype=np.float32)

    def reset(self, x0: Optional[np.ndarray] = None) -> np.ndarray:
        self.state = (
            np.zeros(self.dims.nx, dtype=np.float32)
            if x0 is None
            else np.asarray(x0, dtype=np.float32).copy()
        )
        return self.state.copy()

    def step(self, action: np.ndarray) -> np.ndarray:
        x = torch.tensor(self.state, dtype=torch.float32, device=self._device)
        u = torch.tensor(np.asarray(action, dtype=np.float32), dtype=torch.float32, device=self._device)
        self.state = self._step_fn(x, u).cpu().numpy()
        if self._noise_std > 0:
            self.state = self.state + self._rng.normal(
                0.0, self._noise_std, self.state.shape
            ).astype(np.float32)
        return self.state.copy()

    def step_velocity(self, vel_cmd: np.ndarray) -> np.ndarray:
        """Apply a VELOCITY command (``control_mode: vel`` plants): the
        velocity-controlled base tracks the commanded velocity exactly within
        one control period, like the reference's cmd_vel-driven boxer
        (reference ``ros_bridge/.../mpc_planner_node:131-137`` publishes
        Twist to a velocity controller).

        Holonomic: ``vel_cmd`` = qdot (n,) — positions integrate linearly.
        Diffdrive: ``vel_cmd`` = ``[arm_qdot..., v_forward, omega]`` — the
        planner's vel-mode action ordering (the nu-wide velocity block
        preceding the controls in z, with (v, omega) trailing; reference
        ``diff_drive_mpc_model.py:21-22``). For the armless boxer this is
        just ``(v, omega)``.
        """
        vel_cmd = np.asarray(vel_cmd, dtype=np.float32).reshape(-1)
        n, nx = self.dims.n, self.dims.nx
        x = self.state
        if self.dims.base_type == "diffdrive":
            v, omega = float(vel_cmd[-2]), float(vel_cmd[-1])
            sub = 16
            h = self.dt / sub
            q = x[:n].copy()
            for _ in range(sub):
                q[0] += h * np.cos(q[2]) * v
                q[1] += h * np.sin(q[2]) * v
                q[2] += h * omega
            x = x.copy()
            x[:n] = q
            x[nx - 2 :] = [v, omega]
            # arm joints (if any): track the commanded joint velocities
            # exactly over one control period — positions integrate, and the
            # arm rows of qdot hold the commanded rates (not stale values)
            if n > 3 and vel_cmd.size > 2:
                arm_qdot = vel_cmd[: n - 3]
                x[3:n] += self.dt * arm_qdot
                x[n + 3 : 2 * n] = arm_qdot
        else:
            x = x.copy()
            x[:n] += self.dt * vel_cmd[:n]
            x[n:nx] = vel_cmd[:n]
        self.state = x.astype(np.float32)
        return self.state.copy()

    # observation helpers matching the planner's computeAction(*args) calling
    # convention (reference examples pass (q, qdot[, vel]))
    def observation(self):
        n, nx = self.dims.n, self.dims.nx
        if self.dims.base_type == "diffdrive":
            return (
                self.state[:n],
                self.state[n:nx - 2],
                self.state[nx - 2 : nx],
            )
        return self.state[:n], self.state[n:nx]
