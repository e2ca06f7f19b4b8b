"""The port's reference-form solver API against the JAX package and scipy.

``build_solver``'s stacked ``values``/``weights`` Gauss-Newton path and its
generic ``cost``/``ineq`` (exact-Hessian) path, ``pinned_rows``,
``MpcProblem.stage_objective`` / ``stage_inequalities`` and the JAX-form
``solver_callbacks``, ``RobotKinematics.fk_frame`` / ``from_urdf_file``,
``planar_base_transform`` and ``ParamMap.from_reference_dict``. The solver
cases transcribe ``tests/test_solver.py`` (a 1-D double integrator, batch
first here). Tolerances, and why:

* against scipy SLSQP: ``tests/test_solver.py``'s own bars (unconstrained
  cost rtol 1e-3 / atol 1e-4, controls 2e-2; constrained cost 1e-4,
  controls 1e-2, within the limit to 1e-2);
* port against JAX on the same path: controls within 1e-4 and costs within
  1e-5 relative (both f32; the sweeps sum in another order);
* generic against values path: cost rtol 1e-4, z within 5e-3
  (``test_generic_fallback_matches_structured``);
* robot solves, port against JAX: exit flags on all but 2 of 16 lanes,
  converged true costs within 1e-5 relative, converged violation <= 1e-4
  (``tests/test_torch_fleet.py``'s bars), at least 4 lanes converged on
  both sides (cold boxer solves converge 7 of 16 in both packages);
* stage functions and FK: 1e-5 relative / 1e-5 absolute (f32, other
  operation order), FK 1e-6 absolute; the values-path gradient against
  autodiff of the AL stage cost 2e-4 (``tests/test_split_expansion.py``).
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.config import SolverConfiguration as JaxCfg
from robot_mpcs_tpu.models.fk import RobotKinematics as JaxKin
from robot_mpcs_tpu.models.fk import planar_base_transform as jax_planar
from robot_mpcs_tpu.models.params import ParamMap as JaxParamMap
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.solver.al_ilqr import StageFunctions as JaxStage
from robot_mpcs_tpu.solver.al_ilqr import build_solver as jax_build
from robot_mpcs_tpu_torch.config import (
    Setup,
    SolverConfiguration,
    boxer_setup,
    panda_setup,
    point_robot_setup,
)
from robot_mpcs_tpu_torch.models.fk import RobotKinematics, planar_base_transform
from robot_mpcs_tpu_torch.models.params import ParamMap
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import random_fleet_scenario
from robot_mpcs_tpu_torch.solver.al_ilqr import StageFunctions, build_solver

torch.set_num_threads(2)

N, DT = 8, 0.1
ACCURATE = dict(  # test_solver.py's strict cold-start configuration
    max_al_iterations=15, max_ilqr_iterations=15, line_search_steps=8,
    tol_gradient=1e-5, tol_stationarity=1e-4, tol_constraint=1e-5, penalty_initial=10.0,
)
SETUPS = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}
SAMPLERS = {  # bench.py's samplers
    "pointRobot": dict(goal_box=((-2, -2, 0.05), (2, 2, 0.05)),
                       obstacle_box=((-1, -1, 0.05), (1, 1, 0.05))),
    "panda": dict(goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 1.0)),
                  obstacle_box=((-0.8, -0.8, 0.2), (0.8, 0.8, 1.0)), reachable_goals=True),
    "boxer": dict(goal_box=((-2.0, -2.0, 0.0), (2.0, 2.0, 0.0)),
                  obstacle_box=((5.0, 5.0, 0.0), (6.0, 6.0, 0.0))),
}


# ---------------------------------------------------------------- double integrator


def _di(goal, wu, u_lim=None, form="values", lib="torch", pinned_rows=None,
        dyn_jac=None, cfg=None, extra_row=False):
    """``test_solver.py``'s 1-D double integrator in either package: the
    stage functions, then ``build_solver`` for ``form`` ("values",
    "generic"). ``extra_row`` adds a state-only constraint ``x0 - 0.5 >= 0``
    (a row no control moves at stage 0)."""
    xp = torch if lib == "torch" else jnp

    def stack(vals):
        return torch.stack(vals, -1) if lib == "torch" else jnp.stack(vals, -1)

    def cat(vals):
        return torch.cat(vals, -1) if lib == "torch" else jnp.concatenate(vals, -1)

    def dynamics(x, u):
        return stack([x[..., 0] + DT * x[..., 1] + 0.5 * DT**2 * u[..., 0], x[..., 1] + DT * u[..., 0]])

    def cost(x, w, p):
        return (x[..., 0] - goal) ** 2 + 0.1 * x[..., 1] ** 2 + wu * w[..., 0] ** 2

    def ineq(x, w, p):
        rows = [] if u_lim is None else [w[..., 0] + u_lim, u_lim - w[..., 0]]
        if extra_row:
            rows.append(x[..., 0] - 0.5)
        return stack(rows) if rows else xp.zeros(x.shape[:-1] + (0,), dtype=x.dtype)

    def values(x, w, p):
        return cat([stack([x[..., 0] - goal, x[..., 1], w[..., 0]]), ineq(x, w, p)])

    def weights(p):
        if lib == "torch":
            return p.new_tensor([1.0, 0.1, wu]), p.new_zeros((0,))
        return jnp.array([1.0, 0.1, wu]), jnp.zeros((0,))

    n_con = (0 if u_lim is None else 2) + int(extra_row)
    Stage = StageFunctions if lib == "torch" else JaxStage
    stage = Stage(dynamics, cost, ineq, *((values, weights) if form == "values" else ()),
                  dyn_jac=dyn_jac)
    kw = dict(nx=2, ns=0, nu=1, N=N, n_con=n_con, n_res=3 if form == "values" else 0, n_bar=0,
              w_lb=[-100.0], w_ub=[100.0], pinned_rows=pinned_rows)
    if lib == "torch":
        return build_solver(stage, cfg=SolverConfiguration(**(cfg or {})), device="cpu", **kw)
    return jax_build(stage, cfg=JaxCfg(**(cfg or {})), **kw)


def _solve(solve, n_con, lib="torch", xinit=(0.0, 0.0)):
    x0 = np.asarray(xinit, np.float32)
    z0 = np.zeros((N, 3), np.float32)
    lam = np.zeros((N, n_con), np.float32)
    if lib == "torch":
        t = lambda a: torch.as_tensor(a)[None]
        res = solve(t(x0), torch.zeros((1, N, 1)), t(z0), t(lam))
        return {k: v[0].numpy() for k, v in res._asdict().items()}
    res = jax.jit(solve)(jnp.asarray(x0), jnp.zeros((N, 1)), jnp.asarray(z0), jnp.asarray(lam))
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def _oracle(goal, wu, u_lim=None):
    """scipy SLSQP on the identical transcription (decision = controls)."""

    def rollout(us):
        x, xs = np.zeros(2), []
        for k in range(N):
            xs.append(x.copy())
            x = np.array([x[0] + DT * x[1] + 0.5 * DT**2 * us[k], x[1] + DT * us[k]])
        return np.array(xs)

    def f(us):
        xs = rollout(us)
        return np.sum((xs[:, 0] - goal) ** 2 + 0.1 * xs[:, 1] ** 2 + wu * us**2)

    bounds = [(-u_lim, u_lim)] * N if u_lim else None
    res = minimize(f, np.zeros(N), method="SLSQP", bounds=bounds,
                   options={"maxiter": 500, "ftol": 1e-12})
    return res.x, res.fun


@pytest.mark.parametrize("form", ["values", "generic"])
def test_unconstrained_matches_scipy_and_jax(form):
    got = _solve(_di(1.0, 0.01, form=form), 0)
    want = _solve(_di(1.0, 0.01, form=form, lib="jax"), 0, lib="jax")
    u_star, f_star = _oracle(1.0, 0.01)
    assert int(got["exitflag"]) == int(want["exitflag"]) and int(got["exitflag"]) >= 0
    np.testing.assert_allclose(float(got["cost"]), f_star, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["z"][:, 2], u_star, atol=2e-2)
    np.testing.assert_allclose(got["z"][:, 2], want["z"][:, 2], atol=1e-4)
    np.testing.assert_allclose(float(got["cost"]), float(want["cost"]), rtol=1e-5)


@pytest.mark.parametrize("form", ["values", "generic"])
def test_constrained_matches_scipy_and_jax(form):
    got = _solve(_di(2.0, 0.001, u_lim=3.0, form=form, cfg=ACCURATE), 2)
    want = _solve(_di(2.0, 0.001, u_lim=3.0, form=form, cfg=ACCURATE, lib="jax"), 2, lib="jax")
    u_star, f_star = _oracle(2.0, 0.001, u_lim=3.0)
    assert int(got["exitflag"]) == int(want["exitflag"]) == 1
    assert np.max(np.abs(got["z"][:, 2])) <= 3.0 + 1e-2
    np.testing.assert_allclose(float(got["cost"]), f_star, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["z"][:, 2], u_star, atol=1e-2)
    np.testing.assert_allclose(got["z"][:, 2], want["z"][:, 2], atol=1e-4)
    np.testing.assert_allclose(float(got["cost"]), float(want["cost"]), rtol=1e-5)


def test_generic_fallback_matches_structured():
    """The unstructured (exact-Hessian) path reaches the values path's optimum."""
    r1 = _solve(_di(1.0, 0.01, form="values"), 0)
    r2 = _solve(_di(1.0, 0.01, form="generic"), 0)
    np.testing.assert_allclose(float(r1["cost"]), float(r2["cost"]), rtol=1e-4)
    np.testing.assert_allclose(r1["z"], r2["z"], atol=5e-3)


def test_constant_dyn_jacobians_same_solution():
    """Constant (A, B) (the structured sweep) match autodiff Jacobians (the
    general sweep)."""
    A = np.array([[1.0, DT], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * DT**2], [DT]], np.float32)
    r1 = _solve(_di(1.0, 0.01), 0)
    r2 = _solve(_di(1.0, 0.01, dyn_jac=(A, B)), 0)
    np.testing.assert_allclose(r1["z"], r2["z"], atol=1e-4)


def test_batched_solve_every_lane_its_own():
    solve = _di(1.0, 0.01)
    Bsz = 16
    xinit = torch.stack([torch.tensor([x, 0.0]) for x in np.linspace(-1, 1, Bsz)]).float()
    res = solve(xinit, torch.zeros((Bsz, N, 1)), torch.zeros((Bsz, N, 3)))
    assert res.z.shape == (Bsz, N, 3) and bool((res.exitflag == 1).all())
    term = res.z[:, -1, 0].numpy()
    assert np.all(np.abs(term - 1.0) < np.abs(xinit[:, 0].numpy() - 1.0) + 1e-6)
    assert np.all(np.diff(term) > 0)
    # each lane's result does not depend on its batch
    one = solve(xinit[5:6], torch.zeros((1, N, 1)), torch.zeros((1, N, 3)))
    torch.testing.assert_close(one.z[0], res.z[5], rtol=0, atol=1e-6)


@pytest.mark.parametrize("form", ["values", "generic"])
def test_nan_inputs_flagged(form):
    res = _di(1.0, 0.01, form=form)(torch.full((1, 2), float("nan")), torch.zeros((1, N, 1)),
                                     torch.zeros((1, N, 3)))
    assert int(res.exitflag[0]) == -1


def test_warm_start_reduces_iterations():
    solve = _di(1.0, 0.01)
    args = (torch.zeros((1, 2)), torch.zeros((1, N, 1)))
    r1 = solve(*args, torch.zeros((1, N, 3)))
    r2 = solve(*args, r1.z)
    assert float(r2.grad_norm[0]) <= max(1e-4, float(r1.grad_norm[0]))


def test_pinned_rows_shape_is_checked():
    with pytest.raises(ValueError, match=r"pinned_rows shape \(2,\) != \(3,\)"):
        _di(1.0, 0.01, u_lim=3.0, extra_row=True, pinned_rows=[True, False])


@pytest.mark.parametrize("form", ["values", "generic"])
def test_pinned_rows_offset_stage_zero(form):
    """A state-only row violated at xinit (x0 = 0.45 < 0.5, moving at 5 so
    every later stage is feasible) is pinned at stage 0: its offset is 1e6
    there and nowhere else, the lane still converges, and the raw stage-0
    violation reports it; the JAX package agrees."""
    pinned = [False, False, True]
    solve = _di(1.0, 0.01, u_lim=3.0, form=form, extra_row=True, pinned_rows=pinned,
                cfg=ACCURATE)
    off = solve._internals["C_OFF"].numpy()
    assert off.shape == (N, 3) and off[0, 2] == 1e6 and np.count_nonzero(off) == 1
    got = _solve(solve, 3, xinit=(0.45, 5.0))
    want = _solve(_di(1.0, 0.01, u_lim=3.0, form=form, extra_row=True, pinned_rows=pinned,
                      cfg=ACCURATE, lib="jax"), 3, lib="jax", xinit=(0.45, 5.0))
    assert int(got["exitflag"]) == int(want["exitflag"]) == 1
    np.testing.assert_allclose(float(got["violation0_raw"]), 0.05, atol=1e-6)
    np.testing.assert_allclose(float(want["violation0_raw"]), 0.05, atol=1e-6)
    np.testing.assert_allclose(got["z"][:, 2], want["z"][:, 2], atol=1e-4)
    # without the pin no step can fix the stage-0 row: the lane stays infeasible
    unpinned = _solve(_di(1.0, 0.01, u_lim=3.0, form=form, extra_row=True, cfg=ACCURATE), 3,
                      xinit=(0.45, 5.0))
    assert int(unpinned["exitflag"]) == 0 and float(unpinned["violation"]) >= 0.05 - 1e-6


# ------------------------------------------------------------------ robot problems


def _problems(name, slack=False):
    d = SETUPS[name]()
    d["mpc"]["slack"] = slack
    return MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))


def _random_stage(problem, n=8, seed=0):
    rng = np.random.default_rng(seed)
    d = problem.dims
    z = (rng.normal(size=(n, d.nz)) * 0.3).astype(np.float32)
    z[:, d.nx :] = np.abs(z[:, d.nx :])
    p = (np.abs(rng.normal(size=(n, problem.npar))) * 0.5 + 0.1).astype(np.float32)
    return z, p


CASES = [("pointRobot", False), ("pointRobot", True), ("panda", False), ("panda", True),
         ("boxer", False), ("boxer", True)]


@pytest.mark.parametrize("name,slack", CASES)
def test_stage_functions_match_jax(name, slack):
    tp, jp = _problems(name, slack)
    z, p = _random_stage(tp)
    tz, tpar = torch.as_tensor(z), torch.as_tensor(p)
    obj_t = tp.stage_objective(tz, tpar).numpy()
    obj_j = np.asarray(jax.vmap(jp.stage_objective)(z, p))
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-5, atol=1e-5)
    ineq_t = tp.stage_inequalities(tz, tpar).numpy()
    ineq_j = np.asarray(jax.vmap(jp.stage_inequalities)(z, p))
    assert ineq_t.shape == (8, tp.n_ineq)
    np.testing.assert_allclose(ineq_t, ineq_j, rtol=1e-5, atol=1e-5)
    # the stage cost of the split path is the canonical objective
    split_cost = tp.build_solver(device="cpu")._internals["true_cost"]
    nx = tp.dims.nx
    np.testing.assert_allclose(split_cost(tz[:, :nx], tz[:, nx:], tpar).numpy(), obj_t,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,slack", CASES)
def test_solver_callbacks_match_jax(name, slack):
    tp, jp = _problems(name, slack)
    z, p = _random_stage(tp, seed=1)
    nx = tp.dims.nx
    st, wl_t, wu_t = tp.solver_callbacks()
    sj, wl_j, wu_j = jp.solver_callbacks()
    np.testing.assert_array_equal(wl_t, wl_j)
    np.testing.assert_array_equal(wu_t, wu_j)
    tx, tw, tpar = torch.as_tensor(z[:, :nx]), torch.as_tensor(z[:, nx:]), torch.as_tensor(p)
    vmap3 = lambda f: np.asarray(jax.vmap(f)(z[:, :nx], z[:, nx:], p))
    vals = st.values(tx, tw, tpar).numpy()
    assert vals.shape == (8, tp.n_res + tp.n_bar + tp.n_con)
    np.testing.assert_allclose(vals, vmap3(sj.values), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.ineq(tx, tw, tpar).numpy(), vmap3(sj.ineq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.cost(tx, tw, tpar).numpy(), vmap3(sj.cost), rtol=1e-5, atol=1e-5)
    for got, want in zip(st.weights(tpar), jax.vmap(sj.weights)(p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if sj.dyn_jac is None:
        assert st.dyn_jac is None
    else:
        for got, want in zip(st.dyn_jac, sj.dyn_jac):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("name", ["pointRobot", "panda", "boxer"])
def test_values_path_gradient_is_exact(name):
    """The values path's gradient is the exact gradient of its AL stage
    cost (the Gauss-Newton Hessian is a model, the gradient is not)."""
    tp, _ = _problems(name)
    stage, w_lb, w_ub = tp.solver_callbacks()
    d = tp.dims
    solve = build_solver(stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=tp.n_con, n_res=tp.n_res,
                         n_bar=tp.n_bar, w_lb=w_lb, w_ub=w_ub, device="cpu")
    rng = np.random.default_rng(0)
    z, p = _random_stage(tp, n=d.N)
    X = torch.as_tensor(z[None, :, : d.nx])
    W = torch.as_tensor(z[None, :, d.nx :])
    P = torch.as_tensor(p[None])
    lam = torch.as_tensor(np.abs(rng.normal(size=(1, d.N, tp.n_con))).astype(np.float32))
    mu = torch.tensor([7.0])
    lx, lw, *_ = solve._internals["stage_expansion_blocks"](X, W, P, lam, mu)
    al = solve._internals["al_stage_cost"]
    v = torch.cat([X, W], -1).requires_grad_(True)
    g_ref = torch.autograd.grad(al(v[..., : d.nx], v[..., d.nx :], P, lam, mu).sum(), v)[0]
    # stage 0 carries no pinned rows here (none are pinned on this path)
    np.testing.assert_allclose(torch.cat([lx, lw], -1).numpy(), g_ref.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("slack", [False, True])
def test_reference_rows_map_onto_the_split_rows(slack):
    """``reference_constraint_rows``: with the constraint modules in an order
    that interleaves q-family and affine rows, the reference form's ``ineq``
    row i is the split stack's row perm[i], and the pins are the split
    solver's stage-0 offsets in that order."""
    d = point_robot_setup()
    d["mpc"]["slack"] = slack
    d["mpc"]["constraints"] = ["JointLimitConstraints", "RadialConstraints",
                               "InputLimitConstraints"]
    tp = MpcProblem(Setup.from_dict(d))
    perm, pinned = tp.reference_constraint_rows()
    assert sorted(perm.tolist()) == list(range(tp.n_con)) and perm[0] != 0
    z, p = _random_stage(tp, seed=2)
    nx = tp.dims.nx
    args = (torch.as_tensor(z[:, :nx]), torch.as_tensor(z[:, nx:]), torch.as_tensor(p))
    split = tp.build_solver(device="cpu")._internals
    ref = tp.solver_callbacks()[0].ineq(*args)
    np.testing.assert_allclose(ref.numpy(), split["stage_ineq"](*args)[..., perm].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pinned, split["C_OFF"][0].numpy()[perm] > 0)
    assert pinned.any() and not pinned.all()


def _reference_solver(tp, generic=False):
    stage, w_lb, w_ub = tp.solver_callbacks()
    if generic:
        stage = stage._replace(values=None, weights=None)
    d = tp.dims
    return build_solver(stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=tp.n_con, n_res=tp.n_res,
                        n_bar=tp.n_bar, w_lb=w_lb, w_ub=w_ub, cfg=tp.setup.solver, device="cpu")


def _jax_reference_solver(jp, generic=False):
    stage, w_lb, w_ub = jp.solver_callbacks()
    if generic:
        stage = stage._replace(values=None, weights=None)
    d = jp.dims
    return jax.jit(jax.vmap(jax_build(
        stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=jp.n_con, n_res=jp.n_res, n_bar=jp.n_bar,
        w_lb=w_lb, w_ub=w_ub, cfg=jp.setup.solver,
    )))


def _cold_inputs(tp, name, Bsz=16):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sc = random_fleet_scenario(tp, Bsz, seed=0, **SAMPLERS[name])
    d = tp.dims
    z0 = np.zeros((Bsz, d.N, d.nz), np.float32)
    z0[:, :, : d.nx] = sc.xinit.numpy()[:, None, :]
    return sc.xinit.numpy(), sc.params.numpy(), z0, np.zeros((Bsz, d.N, tp.n_con), np.float32)


@pytest.mark.parametrize("case", ["pointRobot_values", "pointRobot_generic", "panda_values",
                                  "boxer_values"])
def test_robot_reference_solves_match_jax(case):
    """A cold 16-lane solve through the values (or generic) path of the port
    against the same path of the JAX package; the values path also against
    the port's split path."""
    name, form = case.split("_")
    tp, jp = _problems(name)
    inputs = _cold_inputs(tp, name)
    res_t = _reference_solver(tp, form == "generic")(*(torch.as_tensor(a) for a in inputs))
    res_j = _jax_reference_solver(jp, form == "generic")(*inputs)
    others = [("jax", np.asarray(res_j.exitflag), np.asarray(res_j.cost))]
    if form == "values":
        res_s = tp.build_solver(device="cpu")(*(torch.as_tensor(a) for a in inputs))
        others.append(("split", res_s.exitflag.numpy(), res_s.cost.numpy()))
    flag_t, cost_t = res_t.exitflag.numpy(), res_t.cost.numpy()
    assert np.all(res_t.violation.numpy()[flag_t == 1] <= 1e-4)
    for label, flag, cost in others:
        assert int(np.sum(flag == flag_t)) >= 14, (label, flag, flag_t)
        both = (flag == 1) & (flag_t == 1)
        assert both.sum() >= 4, (label, flag, flag_t)  # boxer: 7 of 16 converge cold
        rel = np.abs(cost_t - cost) / np.abs(cost)
        assert np.all(rel[both] < 1e-5), (label, rel)


# ------------------------------------------------------------- kinematics, params


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
URDFS = {  # tests/test_fk.py's REFERENCE_URDFS
    "panda": ("panda.urdf", "panda_link0", "panda_link7", "holonomic",
              ["panda_link3", "panda_link5", "panda_link7"]),
    "pointRobot": ("pointRobot.urdf", "world", "base_link", "holonomic", ["base_link"]),
    "boxer": ("boxer_fk.urdf", "base_link", "ee_link", "diffdrive", ["ee_link"]),
}


@pytest.mark.parametrize("name", sorted(URDFS))
def test_fk_frame_from_urdf_file_matches_jax(name):
    fname, root, end, base, links = URDFS[name]
    path = os.path.join(DATA, fname)
    kin = RobotKinematics.from_urdf_file(path, root, end, base_type=base)
    jkin = JaxKin.from_urdf_file(path, root, end, base_type=base)
    assert kin.n == jkin.n
    np.testing.assert_allclose(kin.joint_limits, jkin.joint_limits, atol=1e-12)
    q = np.random.default_rng(7).uniform(-1.5, 1.5, size=(16, kin.n)).astype(np.float32)
    for link in links:
        got = kin.fk_frame(torch.as_tensor(q), link).numpy()
        want = np.asarray(jax.vmap(lambda qq: jkin.fk_frame(qq, link))(q))
        assert got.shape == (16, 4, 4)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"{name}:{link}")
        np.testing.assert_allclose(got[:, :3, 3], kin.fk_pos(torch.as_tensor(q), link).numpy(),
                                   atol=1e-6)
    # unbatched q gives one (4, 4) frame
    assert kin.fk_frame(torch.as_tensor(q[0])).shape == (4, 4)


def test_planar_base_transform_matches_jax():
    xyt = np.random.default_rng(3).uniform(-2, 2, size=(3, 10)).astype(np.float32)
    got = planar_base_transform(*(torch.as_tensor(a) for a in xyt)).numpy()
    want = np.asarray(jax.vmap(jax_planar)(*xyt))
    assert got.shape == (10, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_param_map_reference_dict_round_trip(name):
    tp, jp = _problems(name)
    d = tp.param_map.to_reference_dict()
    assert d == jp.param_map.to_reference_dict()
    back = ParamMap.from_reference_dict(d)
    jback = JaxParamMap.from_reference_dict(d)
    assert back.entries == tp.param_map.entries == jback.entries
    assert back.npar == tp.npar == jback.npar
    bad = dict(d, holes=[back.npar, back.npar + 2])
    for cls in (ParamMap, JaxParamMap):
        with pytest.raises(ValueError, match="'holes' is not contiguous"):
            cls.from_reference_dict(bad)


def test_split_callbacks_keep_building_the_solver():
    """``MpcProblem.build_solver`` runs the split form (as the JAX package's
    does), now under ``split_solver_callbacks``."""
    tp, _ = _problems("pointRobot")
    stage, split, w_lb, w_ub = tp.split_solver_callbacks()
    assert stage.q_rows is split["q_rows"] and stage.values is None
    cfg = dataclasses.replace(tp.setup.solver)
    solve = tp.build_solver(cfg, device="cpu")
    assert "stage_expansion_blocks" in solve._internals
