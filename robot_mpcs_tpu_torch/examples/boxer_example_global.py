"""Boxer example with global planning (port of
``examples/boxer_example_global.py``): rasterize the obstacle set into an
occupancy grid, plan a global path with A* once at the episode's start, then
track the local goal along the path on every step while the lidar and the
free-space decomposition supply the local half-planes.

    python -m robot_mpcs_tpu_torch.examples.boxer_example_global [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from robot_mpcs_tpu_torch.examples.boxer_example import BoxerMpcExample
from robot_mpcs_tpu_torch.examples.mpc_example import CONFIG_DIR, run_main
from robot_mpcs_tpu_torch.global_planner.global_planner import GlobalPlanner

STEPS = 400


class BoxerGlobalMpcExample(BoxerMpcExample):
    """``astar_ms`` and ``path`` record the episode's global plan."""

    epsilon = 0.5
    #: the occupancy grid's (rows, columns)
    grid = (100, 100)

    def initialize_environment(self):
        super().initialize_environment()
        self._limits_env = np.array([[-10.0, 10.0], [-10.0, 10.0], [0.0, 1.0]])
        self.global_planner = self.make_global_planner()

    def make_global_planner(self) -> GlobalPlanner:
        return GlobalPlanner(
            dim_pixels=np.array([*self.grid, 1]),
            limits_low=self._limits_env[:, 0],
            limits_high=self._limits_env[:, 1],
            BOOL_PLOTTING=False,
            enlarge_obstacles=True,
            device=self.device,
        )

    def occupied(self, obst, wx, wy) -> np.ndarray:
        """Cells of world coordinates (wx, wy) that ``obst`` covers."""
        cx, cy = obst.position()[:2]
        return (wx - cx) ** 2 + (wy - cy) ** 2 <= obst.radius() ** 2

    def occupancy_3d(self) -> np.ndarray:
        """Rasterize the obstacle set into the (H, W, 1) occupancy grid the
        reference gets from its OccupancySensor."""
        h, w = self.grid
        occ = np.zeros((h, w, 1), np.float32)
        lo = self._limits_env[:2, 0]
        size = self._limits_env[:2, 1] - lo
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # grid frame: row index along world-x flipped (see convert_meters)
        wx = self._limits_env[0, 1] - (ys + 0.5) / h * size[0]
        wy = lo[1] + (xs + 0.5) / w * size[1]
        for obst in self._obstacles:
            occ[self.occupied(obst, wx, wy), 0] = 1.0
        return occ

    def start_episode(self) -> bool:
        self.global_planner.get_occupancy_map(None, self.occupancy_3d())
        start = np.array([0.0, 0.0, 0.0])
        goal = np.array([self._goal[0], self._goal[1], 0.0])
        t = time.perf_counter()
        self.path, _ = self.global_planner.get_global_path_astar(start, goal)
        self.astar_ms = (time.perf_counter() - t) * 1e3
        if not self.path:
            print("global planner found no path")
            return False
        print(f"global path: {len(self.path)} waypoints")
        return True

    def before_solve(self, q, exitflag, output):
        local_goal = self.global_planner.get_local_goal(q[:2], self.path)
        self.planner.setGoalReaching(local_goal[:2])
        super().before_solve(q, exitflag, output)


def make_example(device="cuda") -> BoxerGlobalMpcExample:
    example = BoxerGlobalMpcExample(str(CONFIG_DIR / "boxerMpc.yaml"), device=device)
    example.initialize_environment()
    example.build()
    example.set_mpc_parameter()
    return example


def main(argv=None) -> int:
    return run_main(make_example, STEPS, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
