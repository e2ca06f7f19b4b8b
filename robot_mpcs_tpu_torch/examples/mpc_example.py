"""Shared scaffold of the port's examples (port of ``examples/mpc_example.py``).

Builds the problem, planner and kinematic sim from a config file on one
device, wires the configured objective and constraint names to the planner's
setters, and runs the closed loop headless against the kinematic sim,
printing the goal-reaching outcome (the reference's only success criterion,
``boxer_example.py:219-224``). Every example runs as a module::

    python -m robot_mpcs_tpu_torch.examples.point_robot_example [--device cpu] [--steps N]

on the CUDA card unless ``--device cpu``. ``--steps N`` cuts the episode to N
control steps (a smoke run): not reaching the goal then is no failure, only a
crash is. The configs are the repository's ``examples/config/*.yaml``.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from robot_mpcs_tpu_torch.config import Setup, load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.planner.mpc_planner import MPCPlanner
from robot_mpcs_tpu_torch.sim.kinematic_sim import KinematicSim
from robot_mpcs_tpu_torch.utils.devices import resolve_device

CONFIG_DIR = Path(__file__).resolve().parents[2] / "examples" / "config"


class SphereObstacle:
    def __init__(self, position, radius):
        self._position = list(position)
        self._radius = float(radius)

    def position(self):
        return self._position

    def radius(self):
        return self._radius

    def dimension(self):
        return 3


class MpcExample:
    """Base harness: config parse, model build, planner construction,
    parameter wiring (reference ``mpc_example.py:26-119``) and the closed
    loop. A subclass sets the scene (``initialize_environment``), the point
    it drives to the goal (``tracked_point``) within ``epsilon`` metres, and
    may act before each solve (``before_solve``).

    ``run`` records each solve's exit flag and wall time (``exitflags``,
    ``solve_ms``: the whole ``computeAction``, host copies included) and the
    step at which the goal was reached (``reached_at``)."""

    #: goal radius (m) of the tracked point
    epsilon = 0.2

    def __init__(self, config_file_name: str, device="cuda"):
        self._config_file = config_file_name
        match = re.search(r"([a-zA-Z]+)Mpc", os.path.basename(config_file_name))
        self._robot_type = match.group(1) if match else "robot"
        self.setup: Setup = load_setup(config_file_name)
        self.device = resolve_device(device)
        self._goal = None
        self._obstacles = []
        self._r_body = 0.2
        self._limits = None
        self._limits_u = None
        self._limits_vel = None
        self.exitflags: list = []
        self.solve_ms: list = []
        self.reached_at: Optional[int] = None

    def initialize_environment(self):  # overridden per robot
        raise NotImplementedError

    def build(self):
        self.problem = MpcProblem(self.setup)
        self.planner = MPCPlanner(self.problem, device=self.device)
        self.planner.reset()
        self.sim = KinematicSim(self.problem.dims, self.setup.mpc.time_step, device=self.device)

    def set_mpc_parameter(self):
        """Dispatch configured objective/constraint names to planner setters
        (reference ``mpc_example.py:63-119``); an unknown name raises."""
        cfg = self.setup.mpc
        for objective in cfg.objectives:
            if objective == "GoalReaching":
                if self._goal is not None:
                    self.planner.setGoalReaching(self._goal)
            elif objective == "ConstraintAvoidance":
                self.planner.setConstraintAvoidance()
            elif objective == "GoalMpcObjective":
                pass  # legacy objective packs its own weights at reset
            else:
                raise ValueError(f"No mpc parameter setter for objective {objective}")
        for constraint in cfg.constraints:
            if constraint == "RadialConstraints":
                self.planner.setRadialConstraints(self._obstacles, self._r_body)
            elif constraint == "SelfCollisionAvoidanceConstraints":
                self.planner.setSelfCollisionAvoidanceConstraints(self._r_body)
            elif constraint == "JointLimitConstraints":
                self.planner.setJointLimits((self._limits[:, 0], self._limits[:, 1]))
            elif constraint == "VelLimitConstraints":
                self.planner.setVelLimits((self._limits_vel[:, 0], self._limits_vel[:, 1]))
            elif constraint == "InputLimitConstraints":
                self.planner.setInputLimits((self._limits_u[:, 0], self._limits_u[:, 1]))
            elif constraint == "LinearConstraints":
                pass  # per-step perception pipeline sets these
            else:
                raise ValueError(f"No mpc parameter setter for constraint {constraint}")
        self.planner.concretize()

    def check_goal_reaching(self, ee_pos, epsilon: float = 0.2) -> bool:
        goal = np.asarray(self._goal)[: len(ee_pos)]
        return bool(np.linalg.norm(np.asarray(ee_pos) - goal) < epsilon)

    # ------------------------------------------------------- the closed loop

    def initial_state(self) -> np.ndarray:
        return np.zeros(self.problem.dims.nx)

    def start_episode(self) -> bool:
        """Set-up after the sim's reset; False ends the episode unreached."""
        return True

    def before_solve(self, q, exitflag: int, output: dict) -> None:
        """Per-step inputs before the solve (perception, local goals)."""

    def tracked_point(self, ob: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def run(self, n_steps: int) -> bool:
        self.sim.reset(self.initial_state())
        if not self.start_episode():
            return False
        exitflag, output = -1, {}
        point = self.tracked_point(self.sim.state)
        for step in range(n_steps):
            obs = self.sim.observation()
            self.before_solve(obs[0], exitflag, output)
            t = time.perf_counter()
            action, output, exitflag = self.planner.computeAction(*obs)
            self.solve_ms.append((time.perf_counter() - t) * 1e3)
            self.exitflags.append(exitflag)
            if exitflag < 0:
                print(f"step {step}: solver failed (exitflag {exitflag})")
            point = self.tracked_point(self.sim.step(action))
            if self.check_goal_reaching(point, self.epsilon):
                print(f"goal reached at step {step}: {np.round(point, 3)}")
                self.reached_at = step
                return True
        print(f"goal NOT reached in {n_steps} steps; final {np.round(point, 3)}")
        return False


def run_main(make_example: Callable[[str], MpcExample], steps: int, description: str,
             argv: Optional[Sequence[str]] = None) -> int:
    """The examples' command line: ``--device`` (default ``cuda``) and
    ``--steps`` (default ``steps``, the episode's limit). Returns 0 when the
    goal was reached, or when ``--steps`` cut the episode (a smoke run)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="torch device to solve on (default: cuda)")
    ap.add_argument("--steps", type=int, default=None,
                    help=f"cut the episode to N control steps (default {steps}); "
                         "not reaching the goal is then no failure")
    args = ap.parse_args(argv)
    example = make_example(args.device)
    reached = example.run(args.steps if args.steps is not None else steps)
    return 0 if reached or args.steps is not None else 1
