"""Optional urdfenvs/pybullet integration seam (port of
``examples/urdfenvs_adapter.py``; pure numpy, the port's own copy).

The reference's examples run inside the ``urdf-env-v0`` gym environment
(reference ``examples/pointRobot_example.py:77-89`` steps the env and feeds
``ob['robot_0']['joint_state']`` into ``computeAction``). The port's
examples use the dependency-free
:class:`~robot_mpcs_tpu_torch.sim.kinematic_sim.KinematicSim` instead, but
users coming from the reference can keep their urdfenvs scenes by mapping
observations and actions through this adapter:

* observation: urdfenvs nests state under ``ob['robot_0']['joint_state']``
  (``position``, ``velocity``, and for differential-drive robots
  ``forward_velocity``, reference ``examples/boxer_example.py:180-182``);
  :func:`observation_to_args` flattens that to the ``computeAction(*args)``
  calling convention (``(q, qdot)`` holonomic, ``(q, qdot, vel)``
  diffdrive).
* action: both frameworks use the same convention (``control_mode: acc``
  emits accelerations, ``vel`` the velocity block), so the planner's action
  feeds ``env.step`` unchanged.

urdfenvs is not a dependency of the port; install it separately to use this
module. Minimal closed loop::

    import gymnasium as gym
    from urdfenvs.robots.generic_urdf import GenericUrdfReacher
    from robot_mpcs_tpu_torch.examples.urdfenvs_adapter import observation_to_args

    robots = [GenericUrdfReacher(urdf="pointRobot.urdf", mode="acc")]
    env = gym.make("urdf-env-v0", robots=robots, render=True, dt=0.05)
    ob, _ = env.reset()
    for _ in range(1000):
        action, output, exitflag = planner.computeAction(
            *observation_to_args(ob, base_type=problem.dims.base_type)
        )
        ob, *_ = env.step(action)
"""

from __future__ import annotations

import numpy as np


def observation_to_args(ob: dict, base_type: str = "holonomic", robot: str = "robot_0"):
    """urdfenvs observation dict -> ``computeAction(*args)`` tuple.

    Holonomic: ``(q, qdot)``. Diffdrive: ``(q, qdot, vel)`` with
    ``vel = (forward_velocity, yaw_rate)`` exactly as the reference builds
    it (reference ``examples/boxer_example.py:180-182``).
    """
    js = ob[robot]["joint_state"]
    q = np.asarray(js["position"], dtype=float)
    qdot = np.asarray(js["velocity"], dtype=float)
    if base_type == "diffdrive":
        vel = np.array((float(js["forward_velocity"]), float(qdot[2])), dtype=float)
        return q, qdot, vel
    return q, qdot


def lidar_point_cloud(ob: dict, q, number_rays: int, robot: str = "robot_0",
                      sensor: str = "LidarSensor"):
    """urdfenvs lidar observation -> world-frame 3D point cloud for
    :func:`~robot_mpcs_tpu_torch.perception.free_space_decomposition.
    free_space_halfplanes` (the reference computes this inline,
    ``examples/boxer_example.py:105-130``: rays are ego-frame (x, y)
    offsets, rotated by heading and translated by base position)."""
    q = np.asarray(q, dtype=float)
    rays = np.asarray(ob[robot][sensor], dtype=float).reshape(number_rays, 2)
    c, s = np.cos(q[2]), np.sin(q[2])
    world = rays @ np.array([[c, s], [-s, c]]) + q[:2]
    return np.concatenate([world, np.zeros((number_rays, 1))], axis=1)
