"""Panda arm MPC example (port of ``examples/panda_example.py``): 7-dof
arm with real joint limits, sphere obstacle, self-collision avoidance.

    python -m robot_mpcs_tpu_torch.examples.panda_example [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from robot_mpcs_tpu_torch.examples.mpc_example import (
    CONFIG_DIR,
    MpcExample,
    SphereObstacle,
    run_main,
)

STEPS = 500


class PandaMpcExample(MpcExample):
    epsilon = 0.1

    def initialize_environment(self):
        self._goal = [0.4, 0.3, 0.6]
        self._obstacles = [SphereObstacle([0.6, -0.3, 0.5], 0.2)]
        self._r_body = 0.1
        # real panda joint limits (reference panda_example.py:60-68)
        self._limits = np.array(
            [
                [-2.8973, 2.8973],
                [-1.7628, 1.7628],
                [-2.8973, 2.8973],
                [-3.0718, 0.0698],
                [-2.8973, 2.8973],
                [-0.0175, 3.7525],
                [-2.8973, 2.8973],
            ]
        )
        self._limits_u = np.array([[-10.0, 10.0]] * 7)

    def initial_state(self):
        x0 = np.zeros(self.problem.dims.nx)
        x0[:7] = [0.0, -0.8, 0.0, -1.5, 0.0, 1.0, 0.0]  # elbow-down home
        return x0

    def tracked_point(self, ob):
        """The end effector (``panda_link7``), by the port's FK on the CPU."""
        q = torch.as_tensor(np.asarray(ob[:7], np.float32))
        return self.problem.kin.fk_pos(q, "panda_link7").numpy()


def make_example(device="cuda") -> PandaMpcExample:
    example = PandaMpcExample(str(CONFIG_DIR / "pandaMpc.yaml"), device=device)
    example.setup.mpc.weights["wconstr"] = [0.01, 0.0, 0.0, 0.0]
    example.initialize_environment()
    example.build()
    example.set_mpc_parameter()
    return example


def main(argv=None) -> int:
    return run_main(make_example, STEPS, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
