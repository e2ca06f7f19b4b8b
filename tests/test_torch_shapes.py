"""Robot shapes beyond pointRobot, panda and boxer, against the JAX package.

Both CUDA kernels are compiled for the shape a solve asks for at its first
use (``ops/_build.py``). Here, on the CPU, the port's wrappers run their
plain versions; this file holds them, and whole solves and fleets at two
new robots' shapes, to the JAX package:

* the Pallas kernels in interpret mode (as ``tests/test_riccati_packed.py``
  and ``tests/test_riccati_pallas.py`` run them) against the port's plain
  sweeps at a 6-dof chain's (12, 6, 0), a 2-dof arm's with slack (4, 3, 1)
  and the mobile panda's (22, 9), at those files' tolerances (rtol 2e-3,
  atol 2e-5 structured, 2e-4 general);
* the mobile panda (``chip_smoke.mobile_panda_setup``: the panda arm on a
  diff-drive base, nx = 22, nu = 9) as a fleet of 16 lanes for 3 steps, at
  the bars of ``tests/test_torch_boxer_fleet.py``: converged fraction
  within 2/16, mean goal distance within 2%, and a warm solve's exit flags
  on all but 2 lanes, its converged lanes' true costs within 1e-4 relative;
* the 6-dof chain (``chip_smoke.chain6_setup``: panda cut at
  ``panda_link6``) solved cold on 16 lanes at ``tests/test_torch_solver.py``'s
  bars: flags on all but one lane (so the port converges wherever JAX does
  but one), true costs of lanes both converge within 1e-5 relative,
  feasible to 1e-4;
* the kernel library's name, computed without ``nvcc``: the same for the
  same shape, another for another shape.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import MOBILE_SAMPLER, chain6_setup, mobile_panda_setup, sampler
from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.ops.riccati_packed import riccati_backward_packed as jax_packed
from robot_mpcs_tpu.ops.riccati_pallas import riccati_backward_batched as jax_batched
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.fleet import random_fleet_scenario as jax_scenario
from robot_mpcs_tpu.parallel.mesh import make_mesh
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.config import Setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner
from robot_mpcs_tpu_torch.utils import aot
from tests.test_riccati_packed import _random_data, _structured_dyn
from tests.test_riccati_pallas import _random_lqr

torch.set_num_threads(2)

B = 16
STEPS = 3
RUNNER_KW = dict(compaction_ratio=2, kick_scale=0.0)  # rescue tier on, no random kick


@pytest.mark.parametrize("n,ns,N", [(6, 0, 20), (2, 1, 5)], ids=["chain6", "n2_slack"])
def test_structured_plain_matches_jax_kernel(n, ns, N):
    nx, nw = 2 * n, n + ns
    A, Bm = _structured_dyn(n, ns, *map(np.float32, (0.05, 0.00125, 0.05)))
    st = rp.detect_structure(A, Bm, nx=nx, ns=ns)
    data = _random_data(5, N, nx, nw)
    kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=st[0], b1=st[1], b2=st[2])
    k_t, K_t, f_t = rp.riccati_backward_packed(*map(torch.as_tensor, data), **kw)
    k_j, K_j, f_j = jax_packed(*map(jnp.asarray, data), **kw)
    assert not f_t.any() and not np.asarray(f_j).any()
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("batched_dyn", [True, False], ids=["batched_AB", "constant_AB"])
def test_general_plain_matches_jax_kernel_at_mobile_panda(batched_dyn):
    nx, nw, N = 22, 9, 8
    data = [np.array(a) for a in _random_lqr(4, N, nx, nw)]
    if not batched_dyn:
        data[5], data[6] = data[5][0].copy(), data[6][0].copy()
    kw = dict(N=N, nx=nx, nw=nw)
    k_t, K_t, f_t = rb.riccati_backward_batched(*map(torch.as_tensor, data), **kw)
    k_j, K_j, f_j = jax_batched(*map(jnp.asarray, data), **kw)
    assert not f_t.any() and not np.asarray(f_j).any()
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def mobile():
    """The mobile panda in both packages, and the JAX fleet's run: scenario,
    per-step states (numpy) and metrics."""
    d = mobile_panda_setup()
    tp, jp = MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scen = jax_scenario(jp, B, seed=0, **MOBILE_SAMPLER)
    runner = JaxRunner(jp, B, mesh=make_mesh(devices=jax.devices()[:1]), **RUNNER_KW)
    sc = runner.shard_scenario(scen)
    state = runner.init_state(sc)
    states, metrics = [], []
    for _ in range(STEPS):
        state, m = runner.step(state, sc)
        # copy now: the next step donates this state's buffers
        states.append({k: np.asarray(v) for k, v in state._asdict().items()})
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return {"port": tp, "jax": jp, "xinit": np.asarray(scen.xinit), "params": np.asarray(scen.params),
            "states": states, "metrics": metrics}


def test_mobile_panda_shape(mobile):
    tp, jp = mobile["port"], mobile["jax"]
    assert (tp.dims.nx, tp.dims.nu, tp.dims.ns, tp.dims.N) == (22, 9, 0, 20)
    assert (jp.dims.nx, jp.dims.nu, tp.n_con, tp.npar) == (22, 9, jp.n_con, jp.npar)
    assert aot.kernel_shapes(tp) == [("riccati_batched", (22, 9))]


def test_mobile_panda_fleet_matches_jax(mobile):
    tp = mobile["port"]
    runner = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    scen = interop.scenario_from_numpy(mobile["xinit"], mobile["params"], device="cpu")
    state = runner.init_state(scen)
    for i in range(STEPS):
        state, m = runner.step(state, scen)
        mt, mj = {k: float(v) for k, v in m._asdict().items()}, mobile["metrics"][i]
        assert all(np.isfinite(v) for v in mt.values()), mt
        assert abs(mt["converged_fraction"] - mj["converged_fraction"]) <= 2 / B + 1e-6, (i, mt, mj)
        assert abs(mt["mean_goal_distance"] - mj["mean_goal_distance"]) <= 0.02 * mj["mean_goal_distance"]
        assert mt["max_violation_converged"] <= 1e-4
    assert int(interop.state_to_numpy(state)["step"]) == STEPS


def test_mobile_panda_warm_solve_matches_jax(mobile):
    """One solve from the JAX fleet's warm start after its second step,
    when lanes begin to converge (a cold mobile-panda solve converges none
    within the default budget, in either package)."""
    tp, jp = mobile["port"], mobile["jax"]
    s = mobile["states"][1]
    args = (s["x"], mobile["params"], s["z_warm"], s["lam"])
    res_j = jax.jit(jax.vmap(jp.build_solver()))(*args)
    res_t = tp.build_solver(device="cpu")(*interop.solver_inputs_from_numpy(*args, device="cpu"))
    flag_j, flag_t = np.asarray(res_j.exitflag), res_t.exitflag.numpy()
    assert int(np.sum(flag_j == flag_t)) >= B - 2, (flag_j, flag_t)
    both = (flag_j == 1) & (flag_t == 1)
    assert both.sum() >= max(1, int(np.sum(flag_j == 1)) - 2), (flag_j, flag_t)
    assert res_t.z.shape == (B, 20, tp.dims.nz) and torch.isfinite(res_t.z).all()
    assert np.all(res_t.violation.numpy()[both] <= 1e-4)
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.numpy() - cost_j) / np.abs(cost_j)
    assert np.all(rel[both] < 1e-4), rel


def test_chain6_cold_solve_matches_jax():
    d = chain6_setup()
    tp, jp = MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))
    assert aot.kernel_shapes(tp) == [("riccati_packed", (12, 6, 0))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scen = jax_scenario(jp, B, seed=0, **sampler("panda"))
    xinit, params = np.asarray(scen.xinit), np.asarray(scen.params)
    dims = tp.dims
    z0 = np.zeros((B, dims.N, dims.nz), np.float32)
    z0[:, :, : dims.nx] = xinit[:, None, :]
    lam0 = np.zeros((B, dims.N, tp.n_con), np.float32)
    res_j = jax.jit(jax.vmap(jp.build_solver()))(xinit, params, z0, lam0)
    res_t = tp.build_solver(device="cpu")(
        *interop.solver_inputs_from_numpy(xinit, params, z0, lam0, device="cpu")
    )
    flag_j, flag_t = np.asarray(res_j.exitflag), res_t.exitflag.numpy()
    assert int(np.sum(flag_j == flag_t)) >= B - 1, (flag_j, flag_t)
    # the port converges wherever JAX does, up to the one flipped lane
    both = (flag_j == 1) & (flag_t == 1)
    assert both.sum() >= max(1, int(np.sum(flag_j == 1)) - 1), (flag_j, flag_t)
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.numpy() - cost_j) / np.abs(cost_j)
    assert np.all(rel[both] < 1e-5), rel
    assert np.all(res_t.violation.numpy()[both] <= 1e-4)


def test_library_name_is_keyed_by_shape():
    """The name hashes the source, flags, shape and compiler: one name per
    shape, stable for a shape, computed without nvcc."""
    version = "Cuda compilation tools, release 12.8, V12.8.93"
    names = {(stem, shape): _build.library_name(stem, shape, version)
             for stem, shape in [("riccati_packed", (14, 7, 0)), ("riccati_packed", (12, 6, 0)),
                                 ("riccati_packed", (12, 7, 1)), ("riccati_batched", (8, 2)),
                                 ("riccati_batched", (22, 9)), ("riccati_batched", (22, 10))]}
    assert len(set(names.values())) == len(names)
    for (stem, shape), name in names.items():
        assert name == _build.library_name(stem, list(shape), version)
        assert name.startswith(f"lib{stem}_") and name.endswith(".so")
        assert name != _build.library_name(stem, shape, version + " (another build)")


@pytest.mark.parametrize("stem,shape,match", [
    ("riccati_packed", (6, 5, 2), "not a holonomic shape"),
    ("riccati_packed", (7, 4, 0), "not a holonomic shape"),
    ("riccati_batched", (70, 34), 'riccati_backend="scan"'),
    ("riccati_packed", (100, 50, 0), 'riccati_backend="scan"'),
])
def test_shapes_the_kernels_do_not_take_raise_before_nvcc(stem, shape, match, monkeypatch):
    """A shape the kernel does not take (ns = 2, odd nx), or one whose lane
    does not fit a block's 227 KB, raises before nvcc is looked for."""
    def unreachable():
        raise AssertionError("nvcc was called")

    monkeypatch.setattr(_build, "nvcc", unreachable)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(ValueError, match=match):
        _build.load_library(stem, shape)
