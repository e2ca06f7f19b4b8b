"""The diff-drive (boxer) slice: the port's boxer solve and fleet against the
JAX package.

Both packages get the same numpy data: the JAX package draws the scenario
(bench.py's boxer sampler) and runs its own ``FleetRunner`` on a 1-device
mesh; its states are handed to the port through ``interop``. On the CPU the
JAX solver runs its scan backward (Cholesky, full-form update) and the port
its general sweep's plain version (LDL^T, full-form update), both with
per-stage Jacobians of the ERK2 unicycle. Tolerances, and why:

* exit flags may differ on 2 of 16 lanes: f32 sums taken in another order
  can flip a borderline line-search accept or stationarity test. A single
  boxer solve leaves many lanes unconverged within the default budget on
  both sides (7 of 16 converge cold from seed 0), so the port is held to
  converge wherever JAX does, up to those two lanes;
* converged lanes are feasible to the solver's tol_constraint (1e-4);
* true costs of lanes both sides converge agree to 1e-4 relative (the f32
  stopping rule fixes a converged solve only to its tolerances, not to
  rounding);
* fleet metrics: converged fraction within 2/16 (two flipped lanes) and
  mean goal distance within 2%.
"""

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
from robot_mpcs_tpu_torch.config import Setup, boxer_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

torch.set_num_threads(2)

B = 16
STEPS = 3
SAMPLER = dict(  # the boxer sampler of bench.py:70-77
    goal_box=((-2.0, -2.0, 0.0), (2.0, 2.0, 0.0)),
    obstacle_box=((5.0, 5.0, 0.0), (6.0, 6.0, 0.0)),
)
RUNNER_KW = dict(compaction_ratio=2, kick_scale=0.0)  # rescue tier on, no random kick


@pytest.fixture(scope="module")
def problems():
    return MpcProblem(Setup.from_dict(boxer_setup())), JaxProblem(JaxSetup.from_dict(boxer_setup()))


@pytest.fixture(scope="module")
def jax_run(problems):
    """The JAX boxer fleet: scenario, per-step states (numpy) and metrics."""
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


def test_random_fleet_scenario_matches_jax(problems, jax_run):
    tp, _ = problems
    scen = random_fleet_scenario(tp, B, seed=0, **SAMPLER)
    np.testing.assert_array_equal(scen.xinit.numpy(), jax_run["xinit"])
    np.testing.assert_allclose(scen.params.numpy(), jax_run["params"], atol=1e-6)


@pytest.mark.parametrize("start", ["warm", "cold"])
def test_solve_matches_jax(problems, jax_run, jax_solve, start):
    """One solve from the JAX fleet's warm start after its first step, and
    one cold solve from the scenario's initial states."""
    tp, _ = problems
    dims = tp.dims
    params = jax_run["params"]
    if start == "warm":
        s = jax_run["states"][0]
        xinit, z0, lam0 = s["x"], s["z_warm"], s["lam"]
    else:
        xinit = jax_run["xinit"]
        z0 = np.zeros((B, dims.N, dims.nz), np.float32)
        z0[:, :, : dims.nx] = xinit[:, None, :]
        lam0 = np.zeros((B, dims.N, tp.n_con), np.float32)
    res_j = jax_solve(xinit, params, z0, lam0)
    res_t = tp.build_solver(device="cpu")(
        *interop.solver_inputs_from_numpy(xinit, params, z0, lam0)
    )
    flag_j, flag_t = np.asarray(res_j.exitflag), res_t.exitflag.numpy()
    assert int(np.sum(flag_j == flag_t)) >= B - 2, (flag_j, flag_t)
    # a boxer solve often spends its whole budget (exitflag 0) on both sides:
    # the port must converge wherever JAX does, up to the two flipped lanes
    both = (flag_j == 1) & (flag_t == 1)
    assert both.sum() >= max(1, int(np.sum(flag_j == 1)) - 2), (flag_j, flag_t)
    assert res_t.z.shape == (B, dims.N, dims.nz) and torch.isfinite(res_t.z).all()
    assert np.all(res_t.violation.numpy()[both] <= 1e-4)
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.numpy() - cost_j) / np.abs(cost_j)
    assert np.all(rel[both] < 1e-4), rel


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
    assert int(got["step"]) == int(jax_run["states"][-1]["step"]) == STEPS
