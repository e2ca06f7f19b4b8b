"""The port's receding-horizon planner against the JAX package's, on the CPU.

Both planners get the same setup files and the same observations; the JAX
side runs as its own tests run it (``jax.jit(jax.vmap(solve))`` on the CPU),
the port with ``device="cpu"`` (the plain Riccati versions). Tolerances, and
why:

* the ``(N, npar)`` parameter buffers, the warm-start buffers and the
  action slices are host numpy written by the same arithmetic: equal bit
  for bit;
* closed-loop actions within 1e-3 and equal exit flags: the control-error
  bar of ``tests/test_parity.py``; f32 sums in another order move a solve's
  controls by up to ~1e-3 (``ROADMAP.md`` Queue 3);
* a cold first solve's true cost within 1e-6 relative (both sides reach it
  to ~1e-7);
* ``solve_batch`` lanes against single solves: exit flags equal, ``z``
  within 1e-3, the same control bar.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from robot_mpcs_tpu.config import load_setup as jax_load_setup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.planner.mpc_planner import MPCPlanner as JaxPlanner
from robot_mpcs_tpu.sim.kinematic_sim import KinematicSim as JaxSim
from robot_mpcs_tpu.solver.types import SolveResult as JaxSolveResult
from robot_mpcs_tpu_torch.config import load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.planner import MPCPlanner, SolverDoesNotExistError
from robot_mpcs_tpu_torch.solver.types import SolveResult

torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "config")
ACTION_TOL = 1e-3
COLD_COST_RTOL = 1e-6


def _config(kind):
    return os.path.join(CONFIG_DIR, f"{kind}Mpc.yaml")


class _Sphere:
    def __init__(self, pos, radius):
        self._pos, self._r = list(pos), radius

    def position(self):
        return self._pos

    def radius(self):
        return self._r

    def dimension(self):
        return 3


def _setups(kind, **mpc):
    """The same setup file parsed by both packages, with ``mpc`` overrides."""
    out = []
    for load in (jax_load_setup, load_setup):
        s = load(_config(kind))
        for k, v in mpc.items():
            setattr(s.mpc, k, v)
        out.append(s)
    return out


def _planners(kind, **mpc):
    js, ts = _setups(kind, **mpc)
    return JaxPlanner(JaxProblem(js)), MPCPlanner(MpcProblem(ts), device="cpu")


def _setter_calls(kind, problem):
    """The setters a user calls for ``kind``, as (name, args) in order."""
    m = problem.dims.m
    if kind == "boxer":
        N = problem.dims.N
        rng = np.random.default_rng(1)
        lin = [[rng.normal(size=4).astype(np.float32)] for _ in range(N)]
        return [
            ("setGoalReaching", ([7.2, -2.2],)),
            ("setLinearConstraints", (lin, 0.6)),
            ("setSelfCollisionAvoidanceConstraints", (0.6,)),
            ("setJointLimits", (([-10.0] * 3, [10.0] * 3),)),
            ("setInputLimits", (([-10.0] * 2, [10.0] * 2),)),
            ("setConstraintAvoidance", ()),
        ]
    n = problem.dims.n
    block = np.arange(3 * m, dtype=np.float32) * 0.1 + 0.3  # [pos, vel, acc]
    return [
        ("setGoalReaching", ([0.4, 0.3, 0.6],)),
        ("setRadialConstraints", ([_Sphere([0.2, -0.4, 0.8], 0.15)], 0.1)),
        ("setRadialConstraints", ([], 0.1)),  # EmptyObstacle padding
        ("setSelfCollisionAvoidanceConstraints", (0.05,)),
        ("setJointLimits", ((np.linspace(-2, -1, n), np.linspace(1, 2, n)),)),
        ("setInputLimits", (([-5.0] * n, [5.0] * n),)),
        ("setConstraintAvoidance", ()),
        ("updateDynamicObstacles", (block,)),
        ("updateDynamicObstacles", (np.zeros(0, np.float32),)),  # padding slot
    ]


@pytest.mark.parametrize("kind", ["pointRobot", "panda", "boxer"])
def test_params_buffers_match_jax_after_every_setter(kind):
    jpl, tpl = _planners(kind)
    np.testing.assert_array_equal(tpl.params, jpl.params)
    assert tpl.params.dtype == np.float32
    for name, args in _setter_calls(kind, tpl._problem):
        getattr(jpl, name)(*args)
        getattr(tpl, name)(*args)
        np.testing.assert_array_equal(tpl.params, jpl.params, err_msg=name)
    jpl.reset()
    tpl.reset()
    np.testing.assert_array_equal(tpl.params, jpl.params, err_msg="reset")


def _point_planner(**mpc):
    _, ts = _setups("pointRobot", **mpc)
    ts.mpc.weights["wconstr"] = [0.005, 0.0, 0.0, 0.0]
    planner = MPCPlanner(MpcProblem(ts), device="cpu")
    _prepare(planner, "pointRobot")
    return planner


def _prepare(planner, kind):
    planner.reset()
    if kind == "boxer":
        planner.setGoalReaching([2.0, 1.0])
        lin = [[np.array([1.0, 0.0, 0.0, -100.0])] for _ in range(planner._N)]
        planner.setLinearConstraints(lin, 0.3)
        planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
        planner.setInputLimits(([-5.0] * 2, [5.0] * 2))
    else:
        planner.setGoalReaching([2.0, 0.0, 0.0])
        planner.setRadialConstraints([_Sphere([1.0, 0.1, 0.05], 0.3)], 0.2)
        planner.setJointLimits(([-10.0] * 3, [10.0] * 3))
        planner.setInputLimits(([-5.0] * 3, [5.0] * 3))
        planner.setSelfCollisionAvoidanceConstraints(0.2)
    planner.setConstraintAvoidance()
    planner.concretize()


def test_interval_decimation_replays_cached_action():
    planner = _point_planner(time_horizon=8, interval=3)
    q, qdot = np.zeros(3), np.zeros(3)
    a0, _, _ = planner.computeAction(q, qdot)  # solve
    a1, _, _ = planner.computeAction(q + 0.3, qdot)  # cached (state ignored)
    a2, _, _ = planner.computeAction(q + 0.6, qdot)  # cached
    a3, _, _ = planner.computeAction(q + 0.9, qdot)  # re-solve
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_array_equal(a0, a2)
    assert not np.array_equal(a0, a3)


@pytest.mark.parametrize("mode", ["current_state", "previous_plan", "none"])
def test_shift_horizon_and_set_x0_match_jax(mode):
    jpl, tpl = _planners("pointRobot")
    rng = np.random.default_rng(2)
    for step in range(3):
        xinit = rng.normal(size=tpl._nx).astype(np.float32)
        z_prev = rng.normal(size=(tpl._N, tpl._dims.nz)).astype(np.float32)
        for pl in (jpl, tpl):
            pl._xinit, pl._z_prev = xinit.copy(), z_prev.copy()
            pl.setX0(mode, pl._initial_step)
        np.testing.assert_array_equal(tpl._x0, jpl._x0, err_msg=f"{mode}, step {step}")
        assert tpl._initial_step == jpl._initial_step
    if mode == "previous_plan":  # the first call seeded, later ones shifted
        np.testing.assert_array_equal(tpl._x0[:-1], z_prev[1:])
        np.testing.assert_array_equal(tpl._x0[-1], z_prev[-1])
    for pl in (jpl, tpl):
        pl.shiftHorizon(z_prev[::-1].copy())
    np.testing.assert_array_equal(tpl._x0, jpl._x0)


def test_vel_mode_action_skips_the_slack_entry():
    """``control_mode: vel`` with a slack variable (ns = 1): the action is
    stage 1's velocity block, not the reference's ``z[-2nu:-nu]``, and the
    slack is read from stage 0; both planners slice the same z alike."""
    jpl, tpl = _planners("pointRobot", slack=True, control_mode="vel")
    dims = tpl._dims
    assert dims.ns == 1
    z = np.arange(dims.N * dims.nz, dtype=np.float32).reshape(dims.N, dims.nz)
    lam = np.zeros((dims.N, tpl._problem.n_con), np.float32)

    def torch_solve(xinit, params, z0, lam0):
        one = torch.ones((1,))
        return SolveResult(torch.from_numpy(z)[None], torch.ones((1,), dtype=torch.int32),
                           one, one, one, torch.from_numpy(lam)[None],
                           torch.ones((1,), dtype=torch.int32), one)

    def jax_solve(xinit, params, z0, lam0):
        return JaxSolveResult(z, np.int32(1), 1.0, 1.0, 1.0, lam, 1, 1.0)

    tpl._solve_batch_fn = torch_solve
    jpl._solve_fn = jax_solve
    ob = np.zeros(2 * dims.n, np.float32)
    a_t, out_t, _, flag_t = tpl.solve(ob)
    a_j, out_j, _, flag_j = jpl.solve(ob)
    np.testing.assert_array_equal(a_t, z[1][dims.n : dims.nx])  # qdot of stage 1
    np.testing.assert_array_equal(a_t, a_j)
    assert tpl._slack == jpl._slack == float(z[0][dims.nx])
    assert flag_t == flag_j == 1
    assert sorted(out_t) == sorted(out_j) and sorted(out_t)[0] == "x01"


@pytest.mark.parametrize("kind", ["pointRobot", "boxer"])
def test_closed_loop_matches_jax(kind):
    """Five observations of a JAX closed loop, fed to both planners."""
    mpc = {"time_horizon": 8} if kind == "pointRobot" else {}
    js, ts = _setups(kind, **mpc)
    if kind == "pointRobot":
        for s in (js, ts):
            s.mpc.weights["wconstr"] = [0.005, 0.0, 0.0, 0.0]
    jp = JaxProblem(js)
    jpl, tpl = JaxPlanner(jp), MPCPlanner(MpcProblem(ts), device="cpu")
    for pl in (jpl, tpl):
        _prepare(pl, kind)
    np.testing.assert_array_equal(tpl.params, jpl.params)
    sim = JaxSim(jp.dims, js.mpc.time_step)
    sim.reset(np.zeros(jp.dims.nx))
    for step in range(5):
        obs = sim.observation()
        a_j, out_j, flag_j = jpl.computeAction(*obs)
        a_t, out_t, flag_t = tpl.computeAction(*obs)
        assert flag_t == flag_j, (step, flag_t, flag_j)
        assert flag_t >= 0
        assert np.abs(a_t - a_j).max() <= ACTION_TOL, (step, a_t, a_j)
        assert sorted(out_t) == sorted(out_j)
        if step == 0:  # cold solve: held on its true cost
            c_j, c_t = float(jpl._last_info.cost), float(tpl._last_info.cost)
            assert abs(c_t - c_j) <= COLD_COST_RTOL * abs(c_j), (c_t, c_j)
        sim.step(a_j)


def test_solve_batch_matches_single_solves():
    planner = _point_planner(time_horizon=8)
    dims, n_con = planner._dims, planner._problem.n_con
    rng = np.random.default_rng(3)
    B = 4
    xinit = np.zeros((B, dims.nx), np.float32)
    xinit[:, :2] = rng.uniform(-0.5, 0.5, size=(B, 2))
    params = np.broadcast_to(planner.params, (B,) + planner.params.shape).copy()
    z0 = np.zeros((B, dims.N, dims.nz), np.float32)
    z0[:, :, : dims.nx] = xinit[:, None]
    lam0 = np.zeros((B, dims.N, n_con), np.float32)
    batch = planner.solve_batch(xinit, params, z0, lam0)
    assert batch.z.shape == (B, dims.N, dims.nz)
    for i in range(B):
        one = planner.solve_batch(xinit[i : i + 1], params[i : i + 1], z0[i : i + 1], lam0[i : i + 1])
        assert int(one.exitflag[0]) == int(batch.exitflag[i]) >= 0
        assert float((one.z[0] - batch.z[i]).abs().max()) <= ACTION_TOL


def test_solver_dir_round_trip_with_jax(tmp_path):
    """A directory the JAX package writes (``export=False``) loads in the
    port, the port writes the same YAML payloads, and the loaded planner's
    ``solve_batch`` still takes any B."""
    js, ts = _setups("pointRobot")
    jax_dir = JaxProblem(js).generate_solver(str(tmp_path / "jax"), export=False)
    problem = MpcProblem(ts)
    with pytest.warns(UserWarning, match="no kernels exported"):
        port_dir = problem.generate_solver(str(tmp_path / "port"), device="cpu")
    assert os.path.basename(jax_dir) == os.path.basename(port_dir) == problem.solver_name
    payload = {}
    for d in (jax_dir, port_dir):
        for name in ("paramMap.yaml", "properties.yaml", "setup.yaml"):
            with open(os.path.join(d, name)) as f:
                payload[d, name] = yaml.safe_load(f)
    for name in ("paramMap.yaml", "properties.yaml"):
        assert payload[port_dir, name] == payload[jax_dir, name], name
    # the port's SolverConfiguration has no psd_projection / dtype fields
    # (tests/test_torch_models.py::test_config_equals_jax): all else is equal
    jax_setup = payload[jax_dir, "setup.yaml"]
    for key in ("psd_projection", "dtype"):
        jax_setup["solver"].pop(key)
    assert payload[port_dir, "setup.yaml"] == jax_setup

    planner = MPCPlanner.from_solver_dir(
        "pointRobot", str(tmp_path / "jax"), device="cpu", **ts.mpc.__dict__
    )
    assert planner._solver_dir == jax_dir
    assert planner._problem.param_map.to_reference_dict() == payload[jax_dir, "paramMap.yaml"]
    assert JaxProblem.from_solver_dir(port_dir).npar == problem.npar
    with pytest.raises(SolverDoesNotExistError):
        MPCPlanner.from_solver_dir("pointRobot", str(tmp_path / "none"), device="cpu", **ts.mpc.__dict__)
    # a tampered paramMap is refused
    with open(os.path.join(port_dir, "paramMap.yaml"), "w") as f:
        yaml.dump({"goal": [0, 1, 2]}, f)
    with pytest.raises(ValueError, match="paramMap mismatch"):
        MpcProblem.from_solver_dir(port_dir)

    _prepare(planner, "pointRobot")
    dims, B = planner._dims, 2
    xinit = np.zeros((B, dims.nx), np.float32)
    xinit[1, 0] = 0.2
    z0 = np.zeros((B, dims.N, dims.nz), np.float32)
    z0[:, :, : dims.nx] = xinit[:, None]
    res = planner.solve_batch(
        xinit, np.stack([planner.params] * B), z0, np.zeros((B, dims.N, planner._problem.n_con), np.float32)
    )
    assert res.z.shape == (B, dims.N, dims.nz) and torch.isfinite(res.z).all()


def test_slice_entry_points_default_to_cuda(tmp_path):
    """With no device the slice's entry points ask for the card; without
    CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable here")
    from robot_mpcs_tpu_torch.global_planner.global_planner import GlobalPlanner, enlarge_obstacles
    from robot_mpcs_tpu_torch.perception import FreeSpaceDecomposition
    from robot_mpcs_tpu_torch.sim import KinematicSim
    from robot_mpcs_tpu_torch.utils.checkpoint import load_fleet_state

    _, ts = _setups("pointRobot")
    problem = MpcProblem(ts)
    calls = [
        lambda: MPCPlanner(problem),
        lambda: KinematicSim(problem.dims, 0.05),
        lambda: FreeSpaceDecomposition(),
        lambda: enlarge_obstacles(np.zeros((8, 8), np.float32), 1, 0.3),
        lambda: GlobalPlanner([10, 10, 1], [-5.0, -5.0, 0.0], [5.0, 5.0, 1.0]),
        lambda: load_fleet_state(str(tmp_path / "absent.npz")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
