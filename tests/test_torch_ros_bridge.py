"""The port's ROS-bridge logic (``robot_mpcs_tpu_torch.ros_bridge``) on the
CPU, transport-free: the counterparts of ``tests/test_ros_bridge.py``, and 8
control ticks of the port's ``MpcRosLogic`` against the JAX node's on the
same odometry. Each tick's action (an acceleration) is held to 1e-3 where
both solves took the same number of inner iterations, else to 2 x
tol_stationarity (one Newton step apart, ``ROADMAP.md`` Queue 3); a velocity
command is ``dt`` x the sum of the actions so far, so the commands are held
to ``dt`` x the sum of those bars.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from robot_mpcs_tpu_torch.config import load_setup
from robot_mpcs_tpu_torch.ros_bridge.mpc_planner_node import MpcRosLogic

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "ros_bridge", "config", "boxer_mpc_config.yaml")
ACTION_TOL = 1e-3


class _Sphere:
    def __init__(self, pos, r):
        self._pos, self._r = pos, r

    def position(self):
        return self._pos

    def radius(self):
        return self._r

    def dimension(self):
        return 3


def _prepare(logic):
    """The inputs of ``tests/test_ros_bridge.py``'s 8-tick run."""
    logic.update_goal([3.0, 0.0])
    logic.update_obstacles([_Sphere([10.0, 10.0, 0.0], 0.3)], r_body=0.5)
    logic.planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
    logic.planner.setInputLimits(([-5.0, -5.0], [5.0, 5.0]))
    logic.update_odometry(0.0, 0.0, 0.0, 0.0, 0.0)


def test_logic_no_odometry_returns_none():
    logic = MpcRosLogic(load_setup(CONFIG), device="cpu")
    assert logic.compute_velocity_command() is None


def test_logic_integrates_acc_to_velocity():
    logic = MpcRosLogic(load_setup(CONFIG), device="cpu")
    _prepare(logic)
    v = np.zeros(2)
    for step in range(8):
        cmd = logic.compute_velocity_command()
        assert cmd is not None
        v = np.asarray(cmd)
        # crude forward simulation of the base to keep odometry fresh
        logic.update_odometry(step * 0.05, 0.0, 0.0, v[0], v[1])
    # the goal is straight ahead: the node must command forward motion
    assert v[0] > 0.05, f"expected forward velocity, got {v}"


def test_visualizer_renders_file(tmp_path):
    from robot_mpcs_tpu_torch.planner.visualizer import Visualizer

    viz = Visualizer()
    viz.add_trace_point([0.0, 0.0])
    viz.add_trace_point([0.5, 0.1])
    out = viz.render(
        plan_xy=np.array([[0.5, 0.1], [1.0, 0.2], [1.5, 0.3]]),
        goal=[3.0, 0.5],
        obstacles=[_Sphere([1.5, 0.25, 0.0], 0.4)],
        halfplanes=np.array([[1.0, 0.5, 0.0, -3.0]]),
        r_body=0.2,
        save_to=str(tmp_path / "frame.png"),
    )
    assert os.path.exists(out)
    assert os.path.getsize(out) > 1000


def test_eight_ticks_match_the_jax_node():
    sys.path.insert(0, os.path.join(ROOT, "ros_bridge"))
    from mpc_planner_node import MpcRosLogic as JaxLogic

    from robot_mpcs_tpu.config import load_setup as jax_load_setup

    jl, tl = JaxLogic(jax_load_setup(CONFIG)), MpcRosLogic(load_setup(CONFIG), device="cpu")
    for logic in (jl, tl):
        _prepare(logic)
    np.testing.assert_array_equal(tl.planner.params, jl.planner.params)
    tol = tl.setup.solver.tol_stationarity
    bar = 0.0
    for step in range(8):
        c_j, c_t = jl.compute_velocity_command(), tl.compute_velocity_command()
        iters = int(jl.planner._last_info.iterations), int(tl.planner._last_info.iterations)
        assert jl.planner._last_exitflag >= 0 and tl.planner._last_exitflag >= 0
        bar += tl.dt * (ACTION_TOL if iters[0] == iters[1] else 2.0 * tol)
        assert np.abs(np.subtract(c_t, c_j)).max() <= bar, (step, iters, c_t, c_j)
        # both nodes read the JAX node's odometry
        for logic in (jl, tl):
            logic.update_odometry(step * 0.05, 0.0, 0.0, c_j[0], c_j[1])
    assert c_t[0] > 0.05


def test_node_imports_without_rospy_or_ros_bridge_on_the_path():
    """The node's module and ``main`` need no ROS to import; ``main``
    reports the missing runtime instead of failing at import."""
    code = (
        "import sys; sys.modules['rospy'] = None\n"
        "from robot_mpcs_tpu_torch.ros_bridge import mpc_planner_node, make_solver\n"
        "assert not any('ros_bridge' in p and 'robot_mpcs_tpu_torch' not in p for p in sys.path)\n"
        "print(mpc_planner_node.main())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "rospy not available" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "1"


def test_logic_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MpcRosLogic(load_setup(CONFIG))
