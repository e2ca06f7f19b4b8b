"""Boxer in a supermarket aisle scene (port of
``examples/boxer_example_supermarket.py``): the global-planner pipeline of
``boxer_example_global`` with shelf-like box obstacles, a sphere obstacle and
an 80x80 occupancy grid with a small convolution blur.

    python -m robot_mpcs_tpu_torch.examples.boxer_example_supermarket [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

import numpy as np

from robot_mpcs_tpu_torch.examples.boxer_example_global import BoxerGlobalMpcExample
from robot_mpcs_tpu_torch.examples.mpc_example import CONFIG_DIR, SphereObstacle, run_main
from robot_mpcs_tpu_torch.global_planner.global_planner import GlobalPlanner

STEPS = 500


class BoxObstacle:
    """Axis-aligned box footprint (the reference uses pybullet boxes)."""

    def __init__(self, position, length, width):
        self._position = list(position)
        self._length = float(length)  # x extent
        self._width = float(width)  # y extent
        # conservative circumscribed radius for lidar raycasts
        self._radius = 0.5 * float(np.hypot(length, width))

    def position(self):
        return self._position

    def radius(self):
        return self._radius

    def half_extents(self):
        return self._length / 2.0, self._width / 2.0


class BoxerSupermarketExample(BoxerGlobalMpcExample):
    grid = (80, 80)

    def initialize_environment(self):
        super().initialize_environment()
        self._goal = [7.0, -2.2]
        # five shelf rows + one sphere (reference supermarket scene)
        shelves = [
            BoxObstacle([2.0, 1.5, 0.0], 1.0, 3.0),
            BoxObstacle([4.0, 1.5, 0.0], 1.0, 3.0),
            BoxObstacle([6.0, 1.5, 0.0], 1.0, 3.0),
            BoxObstacle([3.0, -1.0, 0.0], 1.0, 2.0),
            BoxObstacle([5.0, -0.5, 0.0], 1.0, 2.0),
        ]
        self._obstacles = shelves + [SphereObstacle([1.5, -1.8, 0.0], 0.3)]

    def make_global_planner(self) -> GlobalPlanner:
        return GlobalPlanner(
            dim_pixels=np.array([*self.grid, 1]),
            limits_low=np.array([-10.0, -10.0, 0.0]),
            limits_high=np.array([10.0, 10.0, 1.0]),
            BOOL_PLOTTING=False,
            convolution_blur=(2, 2),
            enlarge_obstacles=True,
            device=self.device,
        )

    def occupied(self, obst, wx, wy):
        if isinstance(obst, BoxObstacle):
            cx, cy = obst.position()[:2]
            hx, hy = obst.half_extents()
            return (np.abs(wx - cx) <= hx) & (np.abs(wy - cy) <= hy)
        return super().occupied(obst, wx, wy)


def make_example(device="cuda") -> BoxerSupermarketExample:
    example = BoxerSupermarketExample(str(CONFIG_DIR / "boxerMpc.yaml"), device=device)
    example.initialize_environment()
    example.build()
    example.set_mpc_parameter()
    return example


def main(argv=None) -> int:
    return run_main(make_example, STEPS, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
