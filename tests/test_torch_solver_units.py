"""The solver's loop bodies as units over a carry (``solver/units.py``), on the CPU.

On the card each unit is captured once as a CUDA graph and replayed; a
capture must see no host read, or it fails. Here the same units run
eagerly, so three properties are held where no card is needed:

* **no host read inside a unit**: with every way a tensor's value reaches
  the host patched to raise (``__bool__``, ``item``, ``tolist``,
  ``__int__``, ``__float__``, ``__index__``, ``nonzero``), each unit runs
  once on the panda split path, the stacked ``values`` path and boxer's
  general path (its ``torch.func`` dynamics Jacobians) at B=8;
* **held to JAX**: the unit-driven solve against ``robot_mpcs_tpu``'s
  ``jax.jit(jax.vmap(solve))``, panda at B=64 from the fleet's shift of a
  JAX solve (a warm start) and boxer at B=16 cold. Inner iterations and exit
  flags are equal lane for lane, except on lanes whose iteration counts
  differ: a solve is determined only to about one Newton step (ROADMAP
  Queue 3, "Solves that take different iteration counts"), and those lanes
  are printed. Every lane's controls agree within 2 x tol_stationarity;
  those of lanes with equal counts within 1e-3 (``tests/test_parity.py``),
  up to one lane in 32 whose AL iterations split the same count otherwise
  (printed: 1.03e-3 and 1.16e-3 on two lanes of 64 here); true costs of lanes both
  converge within ``tests/test_torch_fleet.py``'s 1e-5 (panda) and
  ``tests/test_torch_boxer_fleet.py``'s 1e-4 (boxer);
* **no state leaks through the carry**: solve(A), solve(B), solve(A) at the
  same B through one solver, the first and the third bit for bit equal.
"""

import jax
import numpy as np
import pytest
import torch

from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import random_fleet_scenario
from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

from chip_smoke import sampler

torch.set_num_threads(2)

UNITS = ("prologue", "al_head", "head", "probe", "tail", "al_update", "epilogue")
#: (problem, B, true-cost bar of lanes both converge)
CASES = {"panda": (panda_setup, 64, 1e-5), "boxer": (boxer_setup, 16, 1e-4)}


def _problem(kind):
    return MpcProblem(Setup.from_dict({"panda": panda_setup, "boxer": boxer_setup}[kind]()))


def _cold(problem, B, seed=0, kind="panda"):
    """(xinit, params, z0, lam0) numpy, a cold start of the bench's scenario."""
    d = problem.dims
    sc = random_fleet_scenario(problem, B, seed=seed, **sampler(kind))
    xinit, params = sc.xinit.numpy(), sc.params.numpy()
    z0 = np.zeros((B, d.N, d.nz), np.float32)
    z0[:, :, : d.nx] = xinit[:, None, :]
    return xinit, params, z0, np.zeros((B, d.N, problem.n_con), np.float32)


def _values_solver(problem):
    """The reference form (stacked ``values`` rows), pinned like the split path."""
    stage, w_lb, w_ub = problem.solver_callbacks()
    d = problem.dims
    return build_solver(stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=problem.n_con,
                        n_res=problem.n_res, n_bar=problem.n_bar, w_lb=w_lb, w_ub=w_ub,
                        cfg=problem.setup.solver, pinned_rows=problem.reference_constraint_rows()[1],
                        device="cpu")


def _host_read(*args, **kwargs):
    raise AssertionError("a solver unit read a tensor's value on the host")


@pytest.mark.parametrize("path", ["panda split", "panda values", "boxer general"])
def test_no_unit_reads_a_tensor_on_the_host(path, monkeypatch):
    kind = path.split()[0]
    problem = _problem(kind)
    if path == "panda values":
        solve = _values_solver(problem)
        perm = problem.reference_constraint_rows()[0]
    else:
        solve = problem.build_solver(device="cpu")
        perm = np.arange(problem.n_con)
    xinit, params, z0, lam0 = (torch.as_tensor(a) for a in _cold(problem, 8, kind=kind))
    prog = solve._program(xinit, params)
    prog.load(xinit=xinit, P=params, z0=z0, lam0=lam0[..., perm])
    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "nonzero"):
            m.setattr(torch.Tensor, name, _host_read)
        m.setattr(torch, "nonzero", _host_read)
        with pytest.raises(AssertionError, match="on the host"):
            bool(torch.ones(()))  # the patch is live
        for unit in UNITS:  # each once, in the solve's order
            prog.run(unit)
    assert set(UNITS) == set(prog.units)
    c = prog.carry
    assert c["z"].shape == z0.shape and torch.isfinite(c["z"]).all()
    # the head's search flags, the tail's done flags: the loops would go on
    assert c["any_in"].dtype == c["any_ls"].dtype == c["any_al"].dtype == torch.bool


@pytest.fixture(scope="module")
def jax_solvers():
    return {k: jax.jit(jax.vmap(JaxProblem(JaxSetup.from_dict(s())).build_solver()))
            for k, (s, _, _) in CASES.items()}


def _shift(problem, xinit, z, lam):
    """The fleet's shift-horizon warm start after a step (``FleetRunner._post_step``
    for a lane that executes its plan): the plant moves by the first control,
    z and the multipliers shift one stage."""
    d = problem.dims
    u = torch.as_tensor(z[:, 0, -d.nu:])
    x_next = problem.dynamics(torch.as_tensor(xinit), u).numpy()
    z_shift = np.concatenate([z[:, 1:], z[:, -1:]], 1)
    lam_shift = np.concatenate([lam[:, 1:], lam[:, -1:]], 1)
    return x_next, z_shift, lam_shift


@pytest.mark.parametrize("kind", sorted(CASES))
def test_unit_driven_solve_matches_jax(kind, jax_solvers):
    _, B, cost_bar = CASES[kind]
    problem = _problem(kind)
    d = problem.dims
    jsolve = jax_solvers[kind]
    xinit, params, z0, lam0 = _cold(problem, B, kind=kind)
    if kind == "panda":  # warm: the fleet's shift of JAX's cold solve
        first = jsolve(xinit, params, z0, lam0)
        xinit, z0, lam0 = _shift(problem, xinit, np.asarray(first.z), np.asarray(first.lam))
    res_j = jsolve(xinit, params, z0, lam0)
    res_t = problem.build_solver(device="cpu")(*(torch.as_tensor(a) for a in (xinit, params, z0, lam0)))
    it_j, it_t = np.asarray(res_j.iterations), res_t.iterations.numpy()
    flag_j, flag_t = np.asarray(res_j.exitflag), res_t.exitflag.numpy()
    same = it_j == it_t
    du = np.abs(np.asarray(res_j.z)[..., d.nx + d.ns:] - res_t.z.numpy()[..., d.nx + d.ns:]).max(axis=(1, 2))
    print(f"{kind}: lanes with other iteration counts (lane, JAX, port, du): "
          f"{[(int(i), int(it_j[i]), int(it_t[i]), float(du[i])) for i in np.flatnonzero(~same)]}")
    np.testing.assert_array_equal(flag_t[same], flag_j[same])
    # a solve is determined to about one Newton step (< tol_stationarity):
    # two solves of it agree within 2 x tol_stationarity, and within 1e-3
    # where they took as many inner iterations, up to one lane in 32 whose
    # AL iterations split that count otherwise (printed)
    assert np.all(du <= 2.0 * problem.setup.solver.tol_stationarity), du.max()
    over = np.flatnonzero(same & (du > 1e-3))
    print(f"{kind}: lanes with equal iteration counts over 1e-3 (lane, du): "
          f"{[(int(i), float(du[i])) for i in over]}")
    assert len(over) <= B // 32, over
    both = (flag_j == 1) & (flag_t == 1)
    assert both.sum() >= (B // 2 if kind == "panda" else 1)  # boxer: often budget-bound on both sides
    cost_j = np.asarray(res_j.cost)
    rel = np.abs(res_t.cost.numpy() - cost_j) / np.abs(cost_j)
    assert np.all(rel[both] < cost_bar), rel[both].max()
    assert np.all(res_t.violation.numpy()[both] <= 1e-4)


def test_no_state_leaks_through_the_carry():
    problem = _problem("panda")
    solve = problem.build_solver(device="cpu")
    a = [torch.as_tensor(v) for v in _cold(problem, 8, seed=0)]
    b = [torch.as_tensor(v) for v in _cold(problem, 8, seed=1)]
    first = solve(*a)
    other = solve(*b)
    again = solve(*a)
    assert solve._program(a[0], a[1]) is solve._program(b[0], b[1])  # one carry
    assert not torch.equal(first.z, other.z)
    for name, x, y in zip(first._fields, first, again):
        assert torch.equal(x, y), name
    # the result is the caller's: the next solve at this shape does not touch it
    assert first.z.data_ptr() != again.z.data_ptr()
