"""The port's free-space decomposition and kinematic sim against the JAX
package's, on the CPU, plus a short closed loop of the port alone.

Tolerances, and why:

* halfplanes within atol 1e-4 of the JAX carve (the bar of
  ``tests/test_perception.py``: f32 dots summed in another order); a batched
  call is bit-equal to single calls (the same elementwise arithmetic);
* ``KinematicSim.step`` within 1e-5 (erk4 with 16 substeps in f32, summed
  in another order); ``step_velocity`` and ``observation`` are the same host
  numpy code: equal bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_mpcs_tpu.config import load_setup as jax_load_setup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.perception.free_space_decomposition import (
    FreeSpaceDecomposition as JaxFsd,
    free_space_halfplanes as jax_halfplanes,
)
from robot_mpcs_tpu.sim.kinematic_sim import KinematicSim as JaxSim
from robot_mpcs_tpu_torch.config import Setup, load_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.perception import FreeSpaceDecomposition, HalfPlane, free_space_halfplanes
from robot_mpcs_tpu_torch.planner import MPCPlanner
from robot_mpcs_tpu_torch.sim import KinematicSim

torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "config")


def _cloud(seed, P=64):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-3, 3, size=(P, 3)).astype(np.float32)
    points[:, 2] = 0.0
    position = np.array([*rng.uniform(-0.5, 0.5, size=2), 0.0], np.float32)
    return points, position


@pytest.mark.parametrize("seed,K,R", [(0, 6, 4.0), (1, 1, 5.0), (2, 10, 2.0), (3, 4, 1.0)])
def test_halfplanes_match_jax(seed, K, R):
    points, position = _cloud(seed)
    want = np.asarray(jax_halfplanes(jnp.asarray(points), jnp.asarray(position),
                                     number_constraints=K, max_radius=R))
    got = free_space_halfplanes(torch.from_numpy(points), torch.from_numpy(position),
                                number_constraints=K, max_radius=R)
    assert got.shape == (K, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_halfplanes_ties_and_all_dummy_match_jax():
    # duplicated nearest points: both carves take the first index
    points, position = _cloud(4, P=16)
    points[5] = points[9] = position + np.array([0.3, 0.1, 0.0], np.float32)
    far = np.full((8, 3), 50.0, np.float32)  # no point in range: all dummy
    for pts, pos in ((points, position), (far, np.array([1.0, 2.0, 0.0], np.float32))):
        want = np.asarray(jax_halfplanes(jnp.asarray(pts), jnp.asarray(pos),
                                         number_constraints=4, max_radius=5.0))
        got = free_space_halfplanes(torch.from_numpy(pts), torch.from_numpy(pos),
                                    number_constraints=4, max_radius=5.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[:, :3], np.tile([-20.0, -20.0, 0.0], (4, 1)), atol=1e-4)
    assert np.all(got[:, :3] @ pos + got[:, 3] > 0)  # robot on the positive side


def test_batched_halfplanes_equal_single_calls():
    clouds = [_cloud(s) for s in range(5)]
    pts = torch.from_numpy(np.stack([c[0] for c in clouds]))
    pos = torch.from_numpy(np.stack([c[1] for c in clouds]))
    batched = free_space_halfplanes(pts, pos, number_constraints=5, max_radius=3.0)
    assert batched.shape == (5, 5, 4)
    for i in range(5):
        single = free_space_halfplanes(pts[i], pos[i], number_constraints=5, max_radius=3.0)
        torch.testing.assert_close(batched[i], single, rtol=0, atol=0)
    # two leading dimensions (stage, scenario)
    both = free_space_halfplanes(pts.reshape(5, 1, 64, 3).expand(5, 2, 64, 3),
                                 pos[:, None].expand(5, 2, 3), number_constraints=5, max_radius=3.0)
    torch.testing.assert_close(both[:, 1], batched, rtol=0, atol=0)


def test_fsd_class_api_matches_jax():
    points, _ = _cloud(6)
    ours, ref = FreeSpaceDecomposition(4, 3.0, device="cpu"), JaxFsd(4, 3.0)
    for fsd in (ours, ref):
        fsd.set_position(np.array([0.2, -0.1, 0.0]))
        fsd.compute_constraints(points)
    np.testing.assert_allclose(ours.aslist(), ref.aslist(), atol=1e-4)
    assert sorted(ours.asdict()) == sorted(ref.asdict())
    assert len(ours.constraints()) == len(ref.constraints())
    for a, b in zip(ours.constraints(), ref.constraints()):
        np.testing.assert_allclose(a.constraint(), b.constraint(), atol=1e-3)
    for a, b in zip(ours.get_points(), ref.get_points()):
        np.testing.assert_allclose(a, b, atol=1e-3)
    plane = HalfPlane(np.array([1.0, 0.0, 0.0]), np.zeros(3))
    assert plane.point_behind_plane(np.array([2.0, 0.0, 0.0]))
    assert plane.point_infront_plane(np.zeros(3))


def _sims(kind, **kw):
    jp = JaxProblem(jax_load_setup(os.path.join(CONFIG_DIR, f"{kind}Mpc.yaml")))
    tp = MpcProblem(load_setup(os.path.join(CONFIG_DIR, f"{kind}Mpc.yaml")))
    dt = jp.mpc.time_step
    return JaxSim(jp.dims, dt, **kw), KinematicSim(tp.dims, dt, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["pointRobot", "panda", "boxer"])
@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_sim_step_matches_jax(kind, noise):
    jsim, tsim = _sims(kind, noise_std=noise, seed=3)
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=tsim.dims.nx).astype(np.float32)
    if kind == "boxer":
        x0[tsim.dims.n : tsim.dims.nx - 2] = 0.0  # base rows of qdot stay zero
    np.testing.assert_array_equal(jsim.reset(x0), tsim.reset(x0))
    for _ in range(4):
        u = rng.normal(size=tsim.dims.nu).astype(np.float32)
        want, got = jsim.step(u), tsim.step(u)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        jsim.reset(got)  # keep both on the same state
        for a, b in zip(jsim.observation(), tsim.observation()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["pointRobot", "boxer"])
def test_step_velocity_and_observation_match_jax(kind):
    jsim, tsim = _sims(kind)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=tsim.dims.nx).astype(np.float32)
    jsim.reset(x0)
    tsim.reset(x0)
    for _ in range(3):
        v = rng.normal(size=tsim.dims.n).astype(np.float32)
        np.testing.assert_array_equal(tsim.step_velocity(v), jsim.step_velocity(v))
        obs_t, obs_j = tsim.observation(), jsim.observation()
        assert len(obs_t) == len(obs_j) == (3 if kind == "boxer" else 2)
        for a, b in zip(obs_t, obs_j):
            np.testing.assert_array_equal(a, b)


def test_point_robot_closed_loop_reaches_goal():
    setup = Setup.from_dict(point_robot_setup())
    problem = MpcProblem(setup)
    planner = MPCPlanner(problem, device="cpu")
    goal = [2.0, 0.0, 0.0]
    planner.setGoalReaching(goal)
    planner.setRadialConstraints([], 0.2)
    planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
    planner.setInputLimits(([-5.0] * 3, [5.0] * 3))
    planner.setConstraintAvoidance()
    planner.concretize()
    sim = KinematicSim(problem.dims, setup.mpc.time_step, device="cpu")
    sim.reset(np.zeros(problem.dims.nx))
    for step in range(80):
        action, _, flag = planner.computeAction(*sim.observation())
        assert flag >= 0, (step, flag)
        ob = sim.step(action)
        if np.linalg.norm(ob[:2] - goal[:2]) < 0.1:
            break
    assert np.linalg.norm(ob[:2] - goal[:2]) < 0.1, ob[:3]
