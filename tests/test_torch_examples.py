"""The port's examples (``robot_mpcs_tpu_torch.examples``) on the CPU, and
against the JAX package's ``examples/`` on the same scenarios.

* Each example's command line with ``--device cpu --steps 5`` returns 0 with
  no failed solve (the counterpart of ``tests/test_examples_smoke.py``).
* pointRobot and panda: five observations of the JAX example's closed loop
  fed to both planners. No solve fails; actions within 1e-3 (the control
  bar of ``tests/test_parity.py``) where both solves took the same number
  of inner iterations, else within 2 x tol_stationarity: such solves stop
  one Newton step apart (``ROADMAP.md`` Queue 3). Exit flags equal, except
  that a cold first solve may be budget-bound (flag 0) on one side and
  converged on the other: pointRobot's is, in JAX (32 iterations, gradient
  1.4e-2), where the port converges in 22; there the port's action is held,
  under the same bars, to JAX's solve of the same observation with twice
  the AL and iLQR budget, which converges. The panda end effector by the
  port's FK within 1e-5 of the JAX FK (f32).
* boxer: the per-stage half-planes of one pose and plan against the JAX
  example's ``compute_constraints_over_horizon``, at atol 1e-4 (the bar of
  ``tests/test_torch_perception_sim.py``).
* global and supermarket: occupancy rasters, A* paths and the local goals
  along a path equal to the JAX examples' exactly (the same arithmetic on
  0/1 maps).
* the urdfenvs adapter: the counterparts of ``tests/test_urdfenvs_adapter.py``.
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_mpcs_tpu_torch.examples import (
    boxer_example,
    boxer_example_global,
    boxer_example_supermarket,
    panda_example,
    point_robot_example,
)
from robot_mpcs_tpu_torch.examples.urdfenvs_adapter import lidar_point_cloud, observation_to_args
from robot_mpcs_tpu_torch.config import load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.planner.mpc_planner import MPCPlanner
from robot_mpcs_tpu_torch.sim.kinematic_sim import KinematicSim

torch.set_num_threads(2)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)

PORT = {
    "pointRobot": point_robot_example,
    "panda": panda_example,
    "boxer": boxer_example,
    "global": boxer_example_global,
    "supermarket": boxer_example_supermarket,
}
#: the JAX example module and class of each scenario
JAX = {
    "pointRobot": ("point_robot_example", "PointRobotMpcExample", "pointRobotMpc.yaml"),
    "panda": ("panda_example", "PandaMpcExample", "pandaMpc.yaml"),
    "boxer": ("boxer_example", "BoxerMpcExample", "boxerMpc.yaml"),
    "global": ("boxer_example_global", "BoxerGlobalMpcExample", "boxerMpc.yaml"),
    "supermarket": ("boxer_example_supermarket", "BoxerSupermarketExample", "boxerMpc.yaml"),
}
#: the repulsion weight each JAX example's main sets
WCONSTR = {"pointRobot": [0.005, 0.0, 0.0, 0.0], "panda": [0.01, 0.0, 0.0, 0.0]}
ACTION_TOL = 1e-3


def _jax_example(kind, build=True, budget=1):
    """The JAX example of ``kind``, set up as its ``main`` sets it up, with
    ``budget`` times the solver's AL and iLQR iteration limits."""
    module, cls, config = JAX[kind]
    mod = importlib.import_module(module)
    example = getattr(mod, cls)(os.path.join(EXAMPLES, "config", config))
    if kind in WCONSTR:
        example.setup.mpc.weights["wconstr"] = WCONSTR[kind]
    example.setup.solver.max_al_iterations *= budget
    example.setup.solver.max_ilqr_iterations *= budget
    example.initialize_environment()
    if build:
        example.build()
        example.set_mpc_parameter()
    return example


@pytest.mark.parametrize("kind", sorted(PORT))
def test_example_smoke(kind, capsys):
    assert PORT[kind].main(["--device", "cpu", "--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "solver failed" not in out, out
    assert "goal NOT reached in 5 steps" in out


def test_offset_starts_of_the_card_check(capsys):
    """``chip_smoke.offset_start``, the boxer example's extra starts on the
    card: seed 0 keeps the example's own start; seed k moves every state
    entry by 1e-3 times seed k's normal draw, the same at every episode, and
    the episode starts there."""
    from chip_smoke import START_OFFSET, offset_start

    own = boxer_example.make_example("cpu")
    assert np.array_equal(offset_start(own, 0).initial_state(), np.zeros(own.problem.dims.nx))
    ex = offset_start(boxer_example.make_example("cpu"), 3)
    want = START_OFFSET * np.random.default_rng(3).normal(size=own.problem.dims.nx)
    assert np.array_equal(ex.initial_state(), want) and np.array_equal(ex.initial_state(), want)
    ex.run(1)
    assert "solver failed" not in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["pointRobot", "panda"])
def test_example_closed_loop_matches_jax(kind):
    jex, tex = _jax_example(kind), PORT[kind].make_example("cpu")
    np.testing.assert_array_equal(tex.planner.params, jex.planner.params)
    bar_other = 2.0 * tex.setup.solver.tol_stationarity
    jex.sim.reset(tex.initial_state())
    for step in range(5):
        obs = jex.sim.observation()
        a_j, _, flag_j = jex.planner.computeAction(*obs)
        a_t, _, flag_t = tex.planner.computeAction(*obs)
        assert min(flag_t, flag_j) >= 0, (step, flag_t, flag_j)
        held, iters = a_j, (int(jex.planner._last_info.iterations), int(tex.planner._last_info.iterations))
        if flag_t != flag_j:
            assert step == 0 and 0 in (flag_t, flag_j), (step, flag_t, flag_j)
            ref = _jax_example(kind, budget=2)
            held, _, flag_r = ref.planner.computeAction(*obs)
            assert flag_r == flag_t == 1, (flag_r, flag_t)
            iters = (int(ref.planner._last_info.iterations), iters[1])
        bar = ACTION_TOL if iters[0] == iters[1] else bar_other
        assert np.abs(a_t - np.asarray(held)).max() <= bar, (step, iters, a_t, held)
        ob = jex.sim.step(a_j)
        if kind == "panda":
            ee_j = np.asarray(jex.problem.kin.fk_pos(jnp.asarray(ob[:7]), "panda_link7"))
            np.testing.assert_allclose(tex.tracked_point(ob), ee_j, atol=1e-5)


@pytest.mark.parametrize("case", ["plan", "pose", "no_hit"])
def test_boxer_halfplanes_match_jax(case):
    jex, tex = _jax_example("boxer"), boxer_example.make_example("cpu")
    N = tex.setup.mpc.time_horizon
    q = np.array([50.0, 50.0, 0.0]) if case == "no_hit" else np.array([1.2, -0.3, -0.4])
    exitflag = 1 if case == "plan" else -1
    # a plan whose stages pass close to both obstacles
    output = {tex.planner._stage_key(j + 1): np.array([1.2 + 0.3 * j, -0.3 - 0.12 * j, -0.4, 0.0, 0.0,
                                                       0.0, 0.0, 0.0], np.float32)
              for j in range(N)}
    want = np.stack(jex.compute_constraints_over_horizon(q, exitflag, output))
    got = tex.compute_constraints_over_horizon(q, exitflag, output)
    assert got.shape == want.shape == (N, tex.setup.mpc.number_obstacles, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if case == "no_hit":
        np.testing.assert_array_equal(got[..., 3], -100.0)


@pytest.mark.parametrize("kind", ["global", "supermarket"])
def test_global_rasters_paths_and_local_goals_match_jax(kind):
    jex = _jax_example(kind, build=False)
    tex = PORT[kind].make_example("cpu")
    np.testing.assert_array_equal(tex.occupancy_3d(), jex.occupancy_3d())
    assert tex.start_episode()
    jex.global_planner.get_occupancy_map(None, jex.occupancy_3d())
    path_j, _ = jex.global_planner.get_global_path_astar(
        np.zeros(3), np.array([jex._goal[0], jex._goal[1], 0.0]))
    assert len(tex.path) == len(path_j) > 0
    np.testing.assert_array_equal(np.asarray(tex.path), np.asarray(path_j))
    # the follower's goals along the way, from positions near each waypoint
    rng = np.random.default_rng(0)
    for wp in path_j:
        pos = np.asarray(wp)[:2] + rng.normal(0.0, 0.5, 2)
        np.testing.assert_array_equal(tex.global_planner.get_local_goal(pos, tex.path),
                                      jex.global_planner.get_local_goal(pos, path_j))
    assert tex.global_planner.idx_local == jex.global_planner.idx_local > 0


# ---------------------------------------------------------------- adapter


class FakeUrdfEnv:
    """urdfenvs-shaped observation/action surface over the port's KinematicSim
    (``tests/test_urdfenvs_adapter.py``)."""

    def __init__(self, dims, dt, base_type):
        self._sim = KinematicSim(dims, dt, device="cpu")
        self._base_type = base_type
        self._sim.reset(np.zeros(dims.nx))

    def _ob(self):
        obs = self._sim.observation()
        if self._base_type == "diffdrive":
            q, qdot, vel = obs
            js = {"position": list(q), "velocity": list(qdot), "forward_velocity": float(vel[0])}
        else:
            q, qdot = obs
            js = {"position": list(q), "velocity": list(qdot)}
        return {"robot_0": {"joint_state": js}}

    def reset(self):
        return self._ob(), {}

    def step(self, action):
        self._sim.step(np.asarray(action, dtype=float))
        return self._ob(), 0.0, False, False, {}


def _config(name):
    return os.path.join(EXAMPLES, "config", name)


def test_holonomic_closed_loop_through_adapter():
    setup = load_setup(_config("pointRobotMpc.yaml"))
    setup.mpc.weights["wconstr"] = [0.005, 0.0, 0.0, 0.0]
    problem = MpcProblem(setup)
    planner = MPCPlanner(problem, device="cpu")
    goal = [1.5, 0.8, 0.0]
    planner.setGoalReaching(goal)
    planner.setRadialConstraints([point_robot_example.SphereObstacle([50.0, 50.0, 0.05], 0.3)], 0.2)
    planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
    planner.setInputLimits(([-5.0] * 3, [5.0] * 3))
    planner.setConstraintAvoidance()
    planner.concretize()
    env = FakeUrdfEnv(problem.dims, setup.mpc.time_step, "holonomic")
    ob, _ = env.reset()
    for _ in range(200):
        args = observation_to_args(ob, base_type=problem.dims.base_type)
        assert len(args) == 2  # (q, qdot) for holonomic
        action, _, flag = planner.computeAction(*args)
        assert flag >= 0
        ob, *_ = env.step(action)
        q = np.asarray(ob["robot_0"]["joint_state"]["position"])
        if np.linalg.norm(q[:2] - goal[:2]) < 0.15:
            break
    else:
        pytest.fail(f"goal not reached through adapter; final q {q}")


def test_diffdrive_observation_mapping():
    from urdfenvs_adapter import observation_to_args as jax_observation_to_args

    setup = load_setup(_config("boxerMpc.yaml"))
    problem = MpcProblem(setup)
    env = FakeUrdfEnv(problem.dims, setup.mpc.time_step, "diffdrive")
    env.step(np.array([1.0, 0.5]))
    ob, *_ = env.step(np.array([0.5, -0.2]))
    args = observation_to_args(ob, base_type="diffdrive")
    assert len(args) == 3  # (q, qdot, vel)
    q, qdot, vel = args
    assert q.shape == (problem.dims.n,)
    assert vel.shape == (2,)
    # vel = (forward_velocity, yaw_rate): the yaw rate is qdot[2]
    assert vel[1] == qdot[2]
    for got, want in zip(args, jax_observation_to_args(ob, base_type="diffdrive")):
        np.testing.assert_array_equal(got, want)


def test_lidar_point_cloud_geometry():
    """Ego-frame rays rotate by heading and translate by base position
    (reference examples/boxer_example.py:105-130); equal to the JAX
    example's adapter."""
    from urdfenvs_adapter import lidar_point_cloud as jax_lidar_point_cloud

    n_rays, theta = 4, 0.7
    q = np.array([1.0, -2.0, theta])
    rays = np.zeros((n_rays, 2))
    rays[0] = [2.0, 0.0]  # straight ahead (ego +x)
    rays[1] = [0.0, 3.0]  # to the left (ego +y)
    ob = {"robot_0": {"LidarSensor": rays.ravel()}}
    pc = lidar_point_cloud(ob, q, n_rays)
    assert pc.shape == (n_rays, 3)
    np.testing.assert_allclose(pc[0, :2], q[:2] + 2.0 * np.array([np.cos(theta), np.sin(theta)]),
                               atol=1e-12)
    np.testing.assert_allclose(pc[1, :2], q[:2] + 3.0 * np.array([-np.sin(theta), np.cos(theta)]),
                               atol=1e-12)
    assert np.all(pc[:, 2] == 0.0)
    np.testing.assert_array_equal(pc, jax_lidar_point_cloud(ob, q, n_rays))
