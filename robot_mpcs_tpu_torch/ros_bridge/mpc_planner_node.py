#!/usr/bin/env python3
"""ROS1 MPC planner node (port of ``ros_bridge/mpc_planner_node.py``).

Separates the transport (rospy pub/sub, imported only in ``main``) from the
planner logic (``MpcRosLogic``), so the control path imports and runs
without ROS. Run it as a node with

    python3 -m robot_mpcs_tpu_torch.ros_bridge.mpc_planner_node _config_file:=<boxer_mpc_config.yaml>

and optionally ``_device:=cpu`` (default ``cuda``) and ``_solver_dir:=<dir>``,
an artifact directory written by ``ros_bridge/make_solver.py``: its exported
kernels are loaded, so the node's first control tick builds none.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from robot_mpcs_tpu_torch.config import Setup, load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.planner.mpc_planner import MPCPlanner


class MpcRosLogic:
    """Transport-free node logic: state in, velocity command out, the solve
    on ``device`` (the CUDA card by default).

    In "acc" control mode the planner returns accelerations; like the
    reference node (``mpc_planner_node:131-137``) they are integrated to a
    velocity command at the control rate. ``solver_dir``: an artifact
    directory of ``setup``'s problem whose exported kernels the planner
    loads.
    """

    def __init__(self, setup: Setup, device="cuda", solver_dir: Optional[str] = None):
        self.setup = setup
        self.problem = MpcProblem(setup)
        self.planner = MPCPlanner(self.problem, solver_dir=solver_dir, device=device)
        self.planner.reset()
        self.dt = setup.mpc.time_step
        self._vel_cmd = np.zeros(self.problem.dims.nu)
        self._state: Optional[np.ndarray] = None

    # --- inputs ---------------------------------------------------------

    def update_odometry(self, x: float, y: float, yaw: float,
                        forward_vel: float, yaw_vel: float) -> None:
        dims = self.problem.dims
        state = np.zeros(dims.nx, dtype=np.float32)
        state[0:3] = [x, y, yaw]
        if dims.base_type == "diffdrive":
            state[dims.nx - 2 :] = [forward_vel, yaw_vel]
        self._state = state

    def update_goal(self, position: List[float]) -> None:
        self.planner.setGoalReaching(position)

    def update_obstacles(self, obstacles, r_body: float) -> None:
        self.planner.setRadialConstraints(obstacles, r_body)

    # --- control step ---------------------------------------------------

    def compute_velocity_command(self):
        """Returns (forward_vel, yaw_vel) or None when no odometry yet."""
        if self._state is None:
            return None
        dims = self.problem.dims
        q = self._state[: dims.n]
        qdot = self._state[dims.n : dims.nx - (2 if dims.base_type == "diffdrive" else 0)]
        args = (q, qdot)
        if dims.base_type == "diffdrive":
            args = (q, qdot, self._state[dims.nx - 2 :])
        action, _, exitflag = self.planner.computeAction(*args)
        if exitflag < 0:
            return (0.0, 0.0)
        if self.setup.mpc.control_mode == "acc":
            self._vel_cmd = self._vel_cmd + self.dt * np.asarray(action)
        else:
            self._vel_cmd = np.asarray(action)
        return (float(self._vel_cmd[0]), float(self._vel_cmd[1]))


def main() -> int:  # pragma: no cover - requires a ROS1 runtime
    try:
        import rospy
        from geometry_msgs.msg import PoseStamped, Twist
        from nav_msgs.msg import Odometry
        from tf.transformations import euler_from_quaternion
    except ImportError:
        print("rospy not available; this node requires a ROS1 environment")
        return 1

    rospy.init_node("mpc_planner_node")
    logic = MpcRosLogic(
        load_setup(rospy.get_param("~config_file")),
        device=rospy.get_param("~device", "cuda"),
        solver_dir=rospy.get_param("~solver_dir", None),
    )

    def odom_cb(msg: "Odometry") -> None:
        q = msg.pose.pose.orientation
        _, _, yaw = euler_from_quaternion([q.x, q.y, q.z, q.w])
        logic.update_odometry(
            msg.pose.pose.position.x,
            msg.pose.pose.position.y,
            yaw,
            msg.twist.twist.linear.x,
            msg.twist.twist.angular.z,
        )

    def goal_cb(msg: "PoseStamped") -> None:
        logic.update_goal([msg.pose.position.x, msg.pose.position.y])

    rospy.Subscriber("/odometry/filtered", Odometry, odom_cb)
    rospy.Subscriber("/mpc/goal", PoseStamped, goal_cb)
    pub = rospy.Publisher("/boxer_velocity_controller/cmd_vel", Twist, queue_size=1)

    rate = rospy.Rate(1.0 / logic.dt)
    while not rospy.is_shutdown():
        cmd = logic.compute_velocity_command()
        if cmd is not None:
            twist = Twist()
            twist.linear.x, twist.angular.z = cmd
            pub.publish(twist)
        rate.sleep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
