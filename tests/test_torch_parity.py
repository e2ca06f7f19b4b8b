"""The SLSQP parity oracle of ``tests/test_parity.py``, held against the port.

scipy SLSQP in float64 solves the identical single-shooting transcription
the AL-iLQR solver uses: decision variables = stacked controls, states from
the same discrete dynamics, the port's own ``MpcProblem.stage_objective``
and ``stage_inequalities`` (in float64, gradients and Jacobians by torch
autograd). Each test runs a short receding-horizon episode on the CPU: the
plant follows the port solver's action; at every step the oracle polishes
from the solver's answer and the first controls must agree to < 1e-3 (the
reference parity bar), with relative objective suboptimality < 1e-6.
Transcribes ``tests/test_parity.py:182-298`` (pointRobot, pointRobot with a
cold oracle, boxer with its vel-mode action, panda).
"""

import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from robot_mpcs_tpu_torch.config import SolverConfiguration, load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem

from tests.conftest import config_path

torch.set_num_threads(2)

#: the accuracy configuration of tests/test_parity.py
ACCURACY_CFG_KW = dict(
    max_al_iterations=10,
    max_ilqr_iterations=25,
    line_search_steps=8,
    tol_gradient=1e-5,
    tol_stationarity=1e-4,
    tol_constraint=1e-6,
    penalty_initial=10.0,
)


def _make_problem(name, weights=None):
    setup = load_setup(config_path(name))
    if weights:
        setup.mpc.weights.update(weights)
    return MpcProblem(setup)


def _fill_params(problem, goal, obst, r_body, u_lim, joint_lim, planes=None):
    dims, pm = problem.dims, problem.param_map
    params = np.zeros((dims.N, problem.npar), np.float32)
    w = problem.mpc.weights
    pm.set_np(params, "wgoal", [w["w"]] * dims.m)
    pm.set_np(params, "wu", [w["wu"]] * dims.nu)
    if "wconstr" in pm:
        pm.set_np(params, "wconstr", np.asarray(w["wconstr"], np.float32))
    pm.set_np(params, "goal", goal)
    pm.set_np(params, "r_body", r_body)
    if "obst" in pm:
        pm.set_np(params, "obst", obst)
    if planes is not None:
        for i, plane in enumerate(planes):
            pm.set_np(params, f"lin_constrs_{i}", np.asarray(plane, np.float32))
    pm.set_np(params, "lower_limits", [-joint_lim] * dims.n)
    pm.set_np(params, "upper_limits", [joint_lim] * dims.n)
    pm.set_np(params, "lower_limits_u", [-u_lim] * dims.nu)
    pm.set_np(params, "upper_limits_u", [u_lim] * dims.nu)
    return params


def _rollout_z(problem, x0, U):
    """(N, nz) trajectory of stacked controls ``U (N, nu)`` (ns = 0)."""
    xs = [x0]
    for k in range(problem.dims.N - 1):
        xs.append(problem.dynamics(xs[-1], U[k]))
    return torch.cat([torch.stack(xs), U], 1)


def _objective_f64(problem, xinit, params, U):
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    Z = _rollout_z(problem, f64(xinit), f64(U))
    return float(problem.stage_objective(Z, f64(params)).sum())


def _oracle_solve(problem, xinit, params, u_lim, u_init, maxiter=400):
    """scipy SLSQP (float64) on the identical transcription; returns the
    optimal stacked controls (N, nu)."""
    dims = problem.dims
    N, nu = dims.N, dims.nu
    P = torch.as_tensor(np.asarray(params, np.float64))
    x0 = torch.as_tensor(np.asarray(xinit, np.float64))

    def objective(u):
        return problem.stage_objective(_rollout_z(problem, x0, u.reshape(N, nu)), P).sum()

    def constraints(u):
        C = problem.stage_inequalities(_rollout_z(problem, x0, u.reshape(N, nu)), P)
        # stage-0 rows depend only on xinit (pinned), as in the solver
        return C[1:].reshape(-1)

    t = lambda u: torch.as_tensor(np.asarray(u, np.float64))
    grad = torch.func.grad(objective)
    jac = torch.func.jacrev(constraints)
    res = minimize(
        lambda u: float(objective(t(u))),
        np.asarray(u_init, np.float64).reshape(-1),
        jac=lambda u: grad(t(u)).numpy(),
        method="SLSQP",
        bounds=[(-u_lim, u_lim)] * (N * nu),
        constraints=[{
            "type": "ineq",
            "fun": lambda u: constraints(t(u)).detach().numpy(),
            "jac": lambda u: jac(t(u)).numpy(),
        }],
        options={"maxiter": maxiter, "ftol": 1e-12},
    )
    return np.asarray(res.x, np.float64).reshape(N, nu)


def _solve_one(solve, problem, x, params, z0, lam):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
    res = solve(t(x), t(params), t(z0), t(lam))
    return res, res.z[0].numpy(), res.lam[0].numpy()


def _run_parity(problem, params, xinit, u_lim, steps, tol, solver_cfg=None):
    """Receding-horizon parity: per-step (control error, relative objective
    suboptimality) against the float64 SLSQP oracle."""
    dims = problem.dims
    solve = problem.build_solver(solver_cfg, device="cpu")
    x = np.asarray(xinit, np.float32)
    z0 = np.zeros((dims.N, dims.nz), np.float32)
    z0[:, : dims.nx] = x
    lam = np.zeros((dims.N, problem.n_con), np.float32)
    errs, subopts = [], []
    for step in range(steps):
        res, z, lam_z = _solve_one(solve, problem, x, params, z0, lam)
        assert int(res.exitflag[0]) == 1, f"step {step}: solver not converged"
        u_port = z[:, -dims.nu :]
        u_star = _oracle_solve(problem, x, params, u_lim, u_port)
        err = float(np.max(np.abs(u_port[0] - u_star[0])))
        f_port = _objective_f64(problem, x, params, u_port)
        f_star = _objective_f64(problem, x, params, u_star)
        errs.append(err)
        subopts.append((f_port - f_star) / max(1.0, abs(f_star)))
        assert err < tol, f"step {step}: control error {err:.2e} >= {tol}"
        with torch.no_grad():
            x = problem.dynamics(torch.as_tensor(x), torch.as_tensor(u_port[0])).numpy()
        z0 = np.concatenate([z[1:], z[-1:]])
        lam = np.concatenate([lam_z[1:], lam_z[-1:]])
    return errs, subopts


@pytest.mark.slow
def test_point_robot_parity_vs_slsqp():
    """pointRobot (H=20, active radial constraint): < 1e-3 control error with
    the accuracy configuration; the throughput defaults within 3e-3 control
    and 1e-6 relative objective of the same optimum."""
    problem = _make_problem("pointRobotMpc.yaml", weights={"wconstr": [0.005, 0.0, 0.0, 0.0]})
    params = _fill_params(problem, goal=[2.0, 0.4, 0.0], obst=[1.0, 0.1, 0.0, 0.35],
                          r_body=0.2, u_lim=5.0, joint_lim=10.0)
    errs, subopts = _run_parity(problem, params, np.zeros(problem.dims.nx), u_lim=5.0, steps=5,
                                tol=1e-3, solver_cfg=SolverConfiguration(**ACCURACY_CFG_KW))
    assert max(errs) < 1e-3
    assert max(subopts) < 1e-6
    _, subopts_d = _run_parity(problem, params, np.zeros(problem.dims.nx), u_lim=5.0, steps=3,
                               tol=3e-3)
    assert max(subopts_d) < 1e-6


@pytest.mark.slow
def test_point_robot_parity_cold_oracle():
    """The oracle starts from zeros instead of the solver's answer: both
    find the same optimum independently."""
    problem = _make_problem("pointRobotMpc.yaml", weights={"wconstr": [0.005, 0.0, 0.0, 0.0]})
    dims = problem.dims
    params = _fill_params(problem, goal=[1.5, -0.3, 0.0], obst=[0.8, 0.1, 0.0, 0.3],
                          r_body=0.2, u_lim=5.0, joint_lim=10.0)
    x = np.zeros(dims.nx, np.float32)
    z0 = np.zeros((dims.N, dims.nz), np.float32)
    res, z, _ = _solve_one(problem.build_solver(device="cpu"), problem, x, params, z0,
                           np.zeros((dims.N, problem.n_con), np.float32))
    assert int(res.exitflag[0]) == 1
    u_port = z[:, -dims.nu :]
    u_star = _oracle_solve(problem, x, params, 5.0, np.zeros_like(u_port))
    assert float(np.max(np.abs(u_port[0] - u_star[0]))) < 1e-3


@pytest.mark.slow
def test_boxer_diffdrive_parity_vs_slsqp():
    """boxer (diff-drive, H=10, active input limits): the nonlinear dynamics
    path sits on the SLSQP optimum to < 1e-3, and the vel-mode action (the
    stage-1 velocity block) agrees with the oracle's rolled-out stage 1."""
    problem = _make_problem("boxerMpc.yaml")
    dims = problem.dims
    u_lim = 1.0
    params = _fill_params(problem, goal=[1.5, 0.8, 0.0], obst=None, r_body=0.3, u_lim=u_lim,
                          joint_lim=10.0, planes=[[1.0, 0.0, 0.0, -100.0]])
    cfg = SolverConfiguration(**ACCURACY_CFG_KW)
    errs, subopts = _run_parity(problem, params, np.zeros(dims.nx), u_lim=u_lim, steps=4,
                                tol=1e-3, solver_cfg=cfg)
    assert max(errs) < 1e-3
    assert max(subopts) < 1e-6
    x = np.zeros(dims.nx, np.float32)
    res, z, _ = _solve_one(problem.build_solver(cfg, device="cpu"), problem, x, params,
                           np.zeros((dims.N, dims.nz), np.float32),
                           np.zeros((dims.N, problem.n_con), np.float32))
    assert int(res.exitflag[0]) == 1
    u_port = z[:, -dims.nu :]
    u_star = _oracle_solve(problem, x, params, u_lim, u_port)
    with torch.no_grad():
        x1 = problem.dynamics(torch.as_tensor(x), torch.as_tensor(u_star[0], dtype=torch.float32))
    vel_oracle = x1.numpy()[dims.nx - 2 :]
    vel_port = z[1][-(2 * dims.nu + dims.ns) : -(dims.nu + dims.ns)][-2:]
    np.testing.assert_allclose(vel_port, vel_oracle, atol=1e-3)


@pytest.mark.slow
def test_panda_parity_vs_slsqp():
    """panda (7-dof, H=20, radial + joint/input limits): < 1e-3 control error
    across receding steps."""
    problem = _make_problem("pandaMpc.yaml", weights={"wconstr": [0.05, 0.0, 0.0, 0.0]})
    params = _fill_params(problem, goal=[0.4, 0.3, 0.6], obst=[0.35, -0.25, 0.55, 0.15],
                          r_body=0.1, u_lim=10.0, joint_lim=3.0)
    xinit = np.zeros(problem.dims.nx, np.float32)
    xinit[: problem.dims.n] = [0.3, -0.4, 0.2, -1.6, 0.1, 1.8, 0.4]
    errs, subopts = _run_parity(problem, params, xinit, u_lim=10.0, steps=3, tol=1e-3,
                                solver_cfg=SolverConfiguration(**ACCURACY_CFG_KW))
    assert max(errs) < 1e-3
    assert max(subopts) < 1e-6
