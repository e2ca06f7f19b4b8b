"""Boxer diff-drive MPC example with simulated lidar and free-space
decomposition (port of ``examples/boxer_example.py``): per control step,
raycast a simulated 2D lidar against the obstacle set, decompose the point
cloud into half-plane constraints for every predicted stage (around the
previous plan's stages when the last solve succeeded) and feed them to the
planner as LinearConstraints.

The N stage decompositions of a step are one batched
``free_space_halfplanes`` call on the planner's device, equal to N single
calls (the JAX example loops N times through the stateful wrapper).

    python -m robot_mpcs_tpu_torch.examples.boxer_example [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from robot_mpcs_tpu_torch.examples.mpc_example import (
    CONFIG_DIR,
    MpcExample,
    SphereObstacle,
    run_main,
)
from robot_mpcs_tpu_torch.perception.free_space_decomposition import free_space_halfplanes

STEPS = 300
N_RAYS = 64
LIDAR_RANGE = 10.0
#: the decomposition's reach around each stage position (m)
FSD_RADIUS = 5.0


def simulate_lidar(pose, obstacles, n_rays=N_RAYS, max_range=LIDAR_RANGE):
    """Raycast circles from the lidar mount (0.4 m ahead of base, like the
    reference boxer's sensor link). Returns (n_hits, 3) world points."""
    x, y, theta = pose
    origin = np.array([x + 0.4 * np.cos(theta), y + 0.4 * np.sin(theta)])
    angles = theta + np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    dirs = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    points = []
    for d in dirs:
        best = max_range
        for obst in obstacles:
            c = np.asarray(obst.position()[:2]) - origin
            proj = float(c @ d)
            if proj <= 0:
                continue
            perp2 = float(c @ c) - proj * proj
            r2 = obst.radius() ** 2
            if perp2 > r2:
                continue
            t = proj - np.sqrt(r2 - perp2)
            if 0 < t < best:
                best = t
        if best < max_range:
            hit = origin + best * d
            points.append([hit[0], hit[1], 0.0])
    return np.array(points, np.float32).reshape(-1, 3)


class BoxerMpcExample(MpcExample):
    """``fsd_ms`` records each step's lidar scan and decomposition time
    (the half-planes back on the host)."""

    epsilon = 0.4

    def initialize_environment(self):
        self._goal = [7.2, -2.2]
        self._obstacles = [
            SphereObstacle([4.0, -1.5, 0.0], 1.0),
            SphereObstacle([2.4, -0.7, 0.0], 0.3),
        ]
        self._r_body = 0.6
        self._limits = np.array([[-10.0, 10.0]] * 3)
        self._limits_u = np.array([[-10.0, 10.0]] * 2)

    def build(self):
        super().build()
        self._N = self.setup.mpc.time_horizon
        self._n_constr = self.setup.mpc.number_obstacles
        self.fsd_ms: list = []

    def compute_constraints_over_horizon(self, q, exitflag, output):
        """Stage-wise half-planes (reference boxer_example.py:191-202):
        decompose around each predicted stage position when the last solve
        succeeded, else around the current pose; with no lidar hit, the
        inactive plane ``[1, 0, 0, -100]`` in every slot. Returns (N, K, 4)."""
        point_cloud = simulate_lidar(q, self._obstacles)
        if not point_cloud.size:
            return np.tile(np.array([1.0, 0.0, 0.0, -100.0]), (self._N, self._n_constr, 1))
        if exitflag >= 0 and output:
            ref_pos = np.array([[*output[self.planner._stage_key(j + 1)][:2], 0.0]
                                for j in range(self._N)])
        else:
            ref_pos = np.tile(np.array([q[0], q[1], 0.0]), (self._N, 1))
        cloud = torch.from_numpy(point_cloud).to(self.device)
        planes = free_space_halfplanes(
            cloud.expand(self._N, -1, -1),
            torch.tensor(ref_pos, dtype=torch.float32, device=self.device),
            number_constraints=self._n_constr,
            max_radius=FSD_RADIUS,
        )
        return planes.cpu().numpy()

    def before_solve(self, q, exitflag, output):
        t = time.perf_counter()
        lin_constr = self.compute_constraints_over_horizon(q, exitflag, output)
        self.fsd_ms.append((time.perf_counter() - t) * 1e3)
        self.planner.setLinearConstraints(lin_constr, self._r_body)

    def tracked_point(self, ob):
        """The lidar mount, 0.4 m ahead of the base."""
        return ob[:2] + 0.4 * np.array([np.cos(ob[2]), np.sin(ob[2])])


def make_example(device="cuda") -> BoxerMpcExample:
    example = BoxerMpcExample(str(CONFIG_DIR / "boxerMpc.yaml"), device=device)
    example.initialize_environment()
    example.build()
    example.set_mpc_parameter()
    return example


def main(argv=None) -> int:
    return run_main(make_example, STEPS, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
