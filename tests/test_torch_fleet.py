"""The slice as a whole: the port's panda solve and fleet against the JAX package.

Both packages get the same numpy data: the JAX package draws the scenario
and runs its own ``FleetRunner`` on a 1-device mesh; its states are handed
to the port through ``interop``. Tolerances, and why:

* exit flags may differ on 2 of 16 lanes: f32 sums taken in another order
  (batched matmuls here, scalarized FMAs there; the Schur-form structured
  sweep here, the full-form scan there on the CPU) can flip a borderline
  line-search accept or stationarity test;
* controls of lanes both sides converge agree within 1e-3 from the fleet's
  warm start — the control-error bar of ``tests/test_parity.py``. A COLD
  solve is only determined to that level by the f32 stopping rule (the JAX
  package's own first control moves by ~1.3e-3 on some lanes when xinit
  changes by 1e-7 relative), so there the test holds the true cost instead,
  which both sides reach to ~1e-7 relative;
* converged lanes are feasible to the solver's tol_constraint (1e-4);
* fleet metrics: converged fraction within 2/16 (two flipped lanes) and
  mean goal distance within 2%.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.fleet import random_fleet_scenario as jax_scenario
from robot_mpcs_tpu.parallel.mesh import make_mesh
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
from robot_mpcs_tpu_torch.parallel.fleet_group import FleetGroup

torch.set_num_threads(2)

B = 16
STEPS = 3
SAMPLER = dict(  # the panda sampler of bench.py:52-60
    goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 1.0)),
    obstacle_box=((-0.8, -0.8, 0.2), (0.8, 0.8, 1.0)),
    reachable_goals=True,
)
RUNNER_KW = dict(compaction_ratio=2, kick_scale=0.0)  # rescue tier on, no random kick
BOXER_SAMPLER = dict(  # bench.py:70-77
    goal_box=((-2.0, -2.0, 0.0), (2.0, 2.0, 0.0)),
    obstacle_box=((5.0, 5.0, 0.0), (6.0, 6.0, 0.0)),
)
NU0 = 14  # first control column of z = [x (14), u (7)]


@pytest.fixture(scope="module")
def problems():
    return MpcProblem(Setup.from_dict(panda_setup())), JaxProblem(JaxSetup.from_dict(panda_setup()))


@pytest.fixture(scope="module")
def jax_run(problems):
    """The JAX fleet: scenario, per-step states (numpy) and metrics."""
    _, jp = problems
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scen = jax_scenario(jp, B, seed=0, **SAMPLER)
    runner = JaxRunner(jp, B, mesh=make_mesh(devices=jax.devices()[:1]), **RUNNER_KW)
    sc = runner.shard_scenario(scen)
    state = runner.init_state(sc)
    states, metrics = [], []
    for _ in range(STEPS):
        state, m = runner.step(state, sc)
        # copy now: the next step donates this state's buffers
        states.append({k: np.asarray(v) for k, v in state._asdict().items()})
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return {
        "xinit": np.asarray(scen.xinit),
        "params": np.asarray(scen.params),
        "states": states,
        "metrics": metrics,
    }


@pytest.fixture(scope="module")
def jax_solve(problems):
    return jax.jit(jax.vmap(problems[1].build_solver()))


def _both_solves(problems, jax_solve, xinit, params, z0, lam0):
    tp, _ = problems
    res_j = jax_solve(xinit, params, z0, lam0)
    res_t = tp.build_solver(device="cpu")(
        *interop.solver_inputs_from_numpy(xinit, params, z0, lam0)
    )
    flag_j, flag_t = np.asarray(res_j.exitflag), res_t.exitflag.numpy()
    assert int(np.sum(flag_j == flag_t)) >= B - 2, (flag_j, flag_t)
    both = (flag_j == 1) & (flag_t == 1)
    assert both.sum() >= B - 2
    assert res_t.z.shape == (B, tp.dims.N, tp.dims.nz) and torch.isfinite(res_t.z).all()
    assert np.all(res_t.violation.numpy()[both] <= 1e-4)
    assert np.all(np.asarray(res_j.violation)[both] <= 1e-4)
    return res_j, res_t, both


def test_random_fleet_scenario_matches_jax(problems, jax_run):
    tp, _ = problems
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scen = random_fleet_scenario(tp, B, seed=0, **SAMPLER)
    assert scen.xinit.dtype == scen.params.dtype == torch.float32
    np.testing.assert_array_equal(scen.xinit.numpy(), jax_run["xinit"])
    np.testing.assert_allclose(scen.params.numpy(), jax_run["params"], atol=1e-6)


def test_warm_solve_matches_jax(problems, jax_run, jax_solve):
    """One solve from the JAX fleet's warm start after its first step."""
    s = jax_run["states"][0]
    res_j, res_t, both = _both_solves(
        problems, jax_solve, s["x"], jax_run["params"], s["z_warm"], s["lam"]
    )
    du = np.abs(np.asarray(res_j.z)[..., NU0:] - res_t.z.numpy()[..., NU0:]).max(axis=(1, 2))
    assert np.all(du[both] < 1e-3), du


def test_cold_solve_matches_jax(problems, jax_run, jax_solve):
    """One cold solve from the scenario's initial states."""
    tp, _ = problems
    xinit, params = jax_run["xinit"], jax_run["params"]
    z0 = np.zeros((B, tp.dims.N, tp.dims.nz), np.float32)
    z0[:, :, : tp.dims.nx] = xinit[:, None, :]
    lam0 = np.zeros((B, tp.dims.N, tp.n_con), np.float32)
    res_j, res_t, both = _both_solves(problems, jax_solve, xinit, params, z0, lam0)
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.numpy() - cost_j) / np.abs(cost_j)
    assert np.all(rel[both] < 1e-5), rel


def test_fleet_matches_jax(problems, jax_run):
    tp, _ = problems
    runner = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    scen = interop.scenario_from_numpy(jax_run["xinit"], jax_run["params"])
    state = runner.init_state(scen)
    for i in range(STEPS):
        state, m = runner.step(state, scen)
        mt = {k: float(v) for k, v in m._asdict().items()}
        mj = jax_run["metrics"][i]
        assert all(np.isfinite(v) for v in mt.values()), mt
        assert abs(mt["converged_fraction"] - mj["converged_fraction"]) <= 2 / B + 1e-6
        assert abs(mt["mean_goal_distance"] - mj["mean_goal_distance"]) <= 0.02 * mj["mean_goal_distance"]
        assert mt["max_violation_converged"] <= 1e-4
    got = interop.state_to_numpy(state)
    want = jax_run["states"][-1]
    assert int(got["step"]) == int(want["step"]) == STEPS
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-3)


def test_fault_injection_brakes_and_resets(problems, jax_run):
    """A lane with NaN parameters fails (exitflag -1), brakes (u = 0) and is
    cold-restarted, while the other lanes proceed."""
    tp, _ = problems
    params = jax_run["params"].copy()
    params[3] = np.nan
    runner = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    scen = interop.scenario_from_numpy(jax_run["xinit"], params)
    state = runner.init_state(scen)
    new, m = runner.step(state, scen)
    assert float(m.reset_fraction) == pytest.approx(1 / B)
    assert np.isfinite(float(m.mean_goal_distance)) and np.isfinite(float(m.mean_cost))
    braked = tp.dynamics(state.x[3:4], torch.zeros((1, tp.dims.nu)))
    torch.testing.assert_close(new.x[3:4], braked)
    assert torch.all(new.z_warm[3, :, tp.dims.nx :] == 0) and torch.all(new.lam[3] == 0)


def test_interop_round_trip_names_dtypes(jax_run):
    s = dict(jax_run["states"][0])
    s64 = {k: v.astype(np.float64) for k, v in s.items()}  # numpy's default float
    state = interop.state_from_numpy(s64)
    assert state.x.dtype == state.z_warm.dtype == state.lam.dtype == torch.float32
    assert state.step.dtype == state.stall.dtype == state.no_improve.dtype == torch.int32
    back = interop.state_to_numpy(state)
    for k, v in s.items():
        np.testing.assert_array_equal(back[k], v)
    scen = interop.scenario_from_numpy(jax_run["xinit"].astype(np.float64), jax_run["params"])
    assert scen.xinit.dtype == scen.params.dtype == torch.float32
    back = interop.scenario_to_numpy(scen)
    np.testing.assert_array_equal(back["xinit"], jax_run["xinit"])
    np.testing.assert_array_equal(back["params"], jax_run["params"])


@pytest.mark.parametrize("case", ["panda_scan", "boxer_auto", "boxer_scan"])
def test_scan_backend_and_boxer_solve_on_cpu(problems, jax_run, case):
    """The stage-scan backend and the diff-drive problem build and solve on
    the CPU; the panda scan solve meets the warm-start bars of
    ``_both_solves`` against the JAX solver (tests/test_torch_boxer_fleet.py
    holds the boxer solve against JAX)."""
    tp, _ = problems
    if case.startswith("boxer"):
        tp = MpcProblem(Setup.from_dict(boxer_setup()))
    cfg = dataclasses.replace(tp.setup.solver, riccati_backend=case.split("_")[1])
    solve = tp.build_solver(cfg, device="cpu")
    dims = tp.dims
    if case == "panda_scan":
        s = jax_run["states"][0]
        inputs = (s["x"], jax_run["params"], s["z_warm"], s["lam"])
    else:
        scen = random_fleet_scenario(tp, B, seed=0, **BOXER_SAMPLER)
        xinit = scen.xinit.numpy()
        z0 = np.zeros((B, dims.N, dims.nz), np.float32)
        z0[:, :, : dims.nx] = xinit[:, None, :]
        inputs = (xinit, scen.params.numpy(), z0, np.zeros((B, dims.N, tp.n_con), np.float32))
    res = solve(*interop.solver_inputs_from_numpy(*inputs))
    assert res.z.shape == (B, dims.N, dims.nz) and torch.isfinite(res.z).all()
    assert torch.all(res.exitflag >= 0) and torch.any(res.exitflag == 1)
    assert torch.all(res.violation[res.exitflag == 1] <= 1e-4)
    if case == "panda_scan":
        assert int((res.exitflag == 1).sum()) >= B - 2


def test_entry_points_default_to_cuda(problems):
    """With no device the entry points ask for the card; without CUDA they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable here")
    tp, _ = problems
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetRunner(tp, B)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.build_solver()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetGroup({"panda": (tp, B)})
