"""Point-robot MPC example (port of ``examples/point_robot_example.py``):
3-dof holonomic point mass, static sphere obstacle, single goal, headless
closed-loop run against the kinematic sim.

    python -m robot_mpcs_tpu_torch.examples.point_robot_example [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

import numpy as np

from robot_mpcs_tpu_torch.examples.mpc_example import (
    CONFIG_DIR,
    MpcExample,
    SphereObstacle,
    run_main,
)

#: the episode's limit (control steps)
STEPS = 500


class PointRobotMpcExample(MpcExample):
    def initialize_environment(self):
        self._goal = [3.0, 0.5, 0.0]
        self._obstacles = [SphereObstacle([1.5, 0.25, 0.05], 0.4)]
        self._r_body = 0.2
        self._limits = np.array([[-10.0, 10.0]] * 3)
        self._limits_u = np.array([[-5.0, 5.0]] * 3)

    def tracked_point(self, ob):
        return np.asarray(ob[:2])


def make_example(device="cuda") -> PointRobotMpcExample:
    example = PointRobotMpcExample(str(CONFIG_DIR / "pointRobotMpc.yaml"), device=device)
    # sane repulsion weight (see robot_mpcs_tpu_torch.models.objectives.ConstraintAvoidance)
    example.setup.mpc.weights["wconstr"] = [0.005, 0.0, 0.0, 0.0]
    example.initialize_environment()
    example.build()
    example.set_mpc_parameter()
    return example


def main(argv=None) -> int:
    return run_main(make_example, STEPS, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
