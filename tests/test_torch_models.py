"""The port's model layer against the JAX package, on the same numpy inputs.

Config, dimensions and the paramMap ABI must be identical; FK, dynamics and
the solver's two-family stage rows must agree to f32 rounding (atol 1e-5:
both sides compute in f32, summing in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.config import load_setup as jax_load_setup
from robot_mpcs_tpu.models.dynamics import constant_dynamics_jacobians as jax_const_jac
from robot_mpcs_tpu.models.dynamics import make_discrete_dynamics as jax_discrete
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.ops.riccati_packed import detect_structure as jax_detect
from robot_mpcs_tpu_torch.config import (
    Setup,
    boxer_setup,
    load_setup,
    panda_setup,
    point_robot_setup,
)
from robot_mpcs_tpu_torch.models.dynamics import (
    constant_dynamics_jacobians,
    dynamics_jacobians,
    make_discrete_dynamics,
)
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops.riccati_packed import detect_structure

from tests.conftest import config_path

torch.set_num_threads(2)

CONFIGS = ["pandaMpc.yaml", "pointRobotMpc.yaml", "boxerMpc.yaml"]
ATOL = 1e-5


def panda_variant_setup():
    """Panda with slack, velocity limits and the legacy GoalMpcObjective: the
    components and ns > 0 paths the example configs leave unexercised."""
    d = panda_setup()
    d["mpc"]["slack"] = True
    d["mpc"]["constraints"] = d["mpc"]["constraints"] + ["VelLimitConstraints"]
    d["mpc"]["objectives"] = ["GoalMpcObjective", "ConstraintAvoidance"]
    d["mpc"]["weights"]["wconstr"] = [0.05, 0.0, 0.0, 0.0, 0.0]
    return d


@pytest.fixture(scope="module", params=CONFIGS + ["panda_variant"])
def problems(request):
    name = request.param
    if name == "panda_variant":
        d = panda_variant_setup()
        return MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))
    return MpcProblem(load_setup(config_path(name))), JaxProblem(jax_load_setup(config_path(name)))


def _links(problem):
    return list(dict.fromkeys(list(problem.robot.collision_links) + [problem.robot.end_link]))


def _stage_inputs(problem, M=6, seed=0):
    rng = np.random.default_rng(seed)
    z = (0.5 * rng.normal(size=(M, problem.dims.nz))).astype(np.float32)
    p = (np.abs(rng.normal(size=(M, problem.npar))) * 0.5 + 0.1).astype(np.float32)
    return z, p


@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_jax(name):
    want = jax_load_setup(config_path(name)).to_dict()
    # the port leaves out two solver settings: psd_projection (read by no
    # code) and dtype (the port computes in float32, the JAX default)
    assert want["solver"].pop("dtype") == "float32"
    want["solver"].pop("psd_projection")
    assert load_setup(config_path(name)).to_dict() == want


def test_panda_setup_equals_yaml():
    import bench  # the fleet benchmark's panda repulsion override (bench.py:48-61)

    with open(config_path("pandaMpc.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["mpc"]["weights"].update(bench.CLASS_SPECS["panda"]["weights"])
    assert panda_setup() == raw
    assert Setup.from_dict(panda_setup()).to_dict() == Setup.from_dict(raw).to_dict()


@pytest.mark.parametrize(
    "name,make", [("pointRobot", point_robot_setup), ("boxer", boxer_setup)]
)
def test_fleet_setups_equal_yaml(name, make):
    """The dicts the card runs without PyYAML are the example configs with
    the fleet benchmark's weight overrides (bench.py:48-77)."""
    import bench

    with open(config_path(bench.CLASS_SPECS[name]["config"])) as f:
        raw = yaml.safe_load(f)
    raw["mpc"]["weights"].update(bench.CLASS_SPECS[name]["weights"])
    assert make() == raw


def test_dims_and_param_map_equal_jax(problems):
    tp, jp = problems
    assert dataclasses.asdict(tp.dims) == dataclasses.asdict(jp.dims)
    assert tp.param_map.entries == jp.param_map.entries
    assert tp.npar == jp.npar
    assert tp.param_map.to_reference_dict() == jp.param_map.to_reference_dict()
    assert (tp.n_con, tp.n_res, tp.n_bar) == (jp.n_con, jp.n_res, jp.n_bar)
    assert tp.bound_rows() == jp.bound_rows()


def test_fk_positions_and_jacobians_match_jax(problems):
    tp, jp = problems
    links = _links(tp)
    q = np.random.default_rng(1).uniform(-1.5, 1.5, size=(8, tp.dims.n)).astype(np.float32)
    P_j, J_j = jax.jit(jax.vmap(lambda qq: jp.kin.fk_pos_links_with_jac(qq, links)))(jnp.asarray(q))
    P_t, J_t = tp.kin.fk_pos_links_with_jac(torch.as_tensor(q), links)
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), atol=ATOL)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=ATOL)
    np.testing.assert_allclose(tp.kin.fk_pos_links(torch.as_tensor(q), links).numpy(), np.asarray(P_j), atol=ATOL)
    ee_j = jax.vmap(lambda qq: jp.kin.fk_pos(qq))(jnp.asarray(q))
    np.testing.assert_allclose(tp.kin.fk_pos(torch.as_tensor(q)).numpy(), np.asarray(ee_j), atol=ATOL)
    # the analytic Jacobian is the derivative of the positions
    J_ad = torch.func.vmap(torch.func.jacfwd(lambda qq: tp.kin.fk_pos_links(qq, links)))(torch.as_tensor(q))
    np.testing.assert_allclose(J_t.numpy(), J_ad.numpy(), atol=ATOL)


@pytest.mark.parametrize("integrator", ["erk2", "erk4", "euler"])
@pytest.mark.parametrize("name", ["pandaMpc.yaml", "boxerMpc.yaml"])
def test_discrete_dynamics_match_jax(name, integrator):
    tp = MpcProblem(load_setup(config_path(name)))
    dims = tp.dims
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, dims.nx)).astype(np.float32)
    u = rng.normal(size=(5, dims.nu)).astype(np.float32)
    F_t = make_discrete_dynamics(dims, 0.05, integrator, 4)
    jdims = JaxProblem(jax_load_setup(config_path(name))).dims
    F_j = jax_discrete(jdims, 0.05, integrator, 4)
    want = np.asarray(jax.vmap(F_j)(jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(F_t(torch.as_tensor(x), torch.as_tensor(u)).numpy(), want, atol=ATOL)


def test_constant_dynamics_and_structure_match_jax():
    tp = MpcProblem(Setup.from_dict(panda_setup()))
    jp = JaxProblem(jax_load_setup(config_path("pandaMpc.yaml")))
    A, B = constant_dynamics_jacobians(tp.dims, tp.dynamics)
    A_j, B_j = jax_const_jac(jp.dims, jp.dynamics)
    np.testing.assert_allclose(A, A_j, atol=1e-7)
    np.testing.assert_allclose(B, B_j, atol=1e-7)
    Bw = np.concatenate([np.zeros((14, 0)), B], axis=1)
    st = detect_structure(A, Bw, nx=14, ns=0)
    assert st is not None
    np.testing.assert_allclose(st, jax_detect(A_j, Bw, nx=14, ns=0), rtol=1e-6)
    boxer = MpcProblem(load_setup(config_path("boxerMpc.yaml")))
    assert constant_dynamics_jacobians(boxer.dims, boxer.dynamics) is None


def test_split_callbacks_match_jax(problems):
    tp, jp = problems
    ts, js = tp.split_callbacks(), jp.split_callbacks()
    for key in ("q_seg", "aff_seg", "n_q"):
        assert ts[key] == js[key]
    np.testing.assert_array_equal(ts["S_aff"], js["S_aff"])
    n = tp.dims.n
    z, p = _stage_inputs(tp)
    zt, pt = torch.as_tensor(z), torch.as_tensor(p)
    vq_t, Jq_t = ts["q_rows"](zt[:, :n], pt)
    jq = jax.jit(jax.vmap(js["q_rows"]))
    jJ = jax.jit(jax.vmap(jax.jacfwd(js["q_rows"])))
    np.testing.assert_allclose(vq_t.numpy(), np.asarray(jq(z[:, :n], p)), atol=ATOL)
    np.testing.assert_allclose(Jq_t.numpy(), np.asarray(jJ(z[:, :n], p)), atol=ATOL)
    np.testing.assert_allclose(
        ts["aff_rows"](zt, pt).numpy(), np.asarray(jax.vmap(js["aff_rows"])(z, p)), atol=ATOL
    )
    for w_t, w_j in zip(ts["weights_split"](pt), jax.vmap(js["weights_split"])(p)):
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)


@pytest.mark.parametrize("slack", [False, True])
def test_diffdrive_dynamics_jacobians_match_jax(slack):
    """Boxer's per-stage (A, B) as the solver builds them, against the JAX
    solver's ``all_dyn_jacobians`` (jax.jacfwd per stage) on the same (X, W):
    the slack columns of B are zero and stage N-1 has A = B = 0."""
    d = boxer_setup()
    d["mpc"]["slack"] = slack
    tp, jp = MpcProblem(Setup.from_dict(d)), JaxProblem(JaxSetup.from_dict(d))
    dims = tp.dims
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4, dims.N, dims.nx)).astype(np.float32)
    W = rng.normal(size=(4, dims.N, dims.ns + dims.nu)).astype(np.float32)
    A_j, B_j = jax.vmap(jp.build_solver()._internals["all_dyn_jacobians"])(X, W)
    A_t, B_t = tp.build_solver(device="cpu")._internals["all_dyn_jacobians"](
        torch.as_tensor(X), torch.as_tensor(W)
    )
    assert A_t.shape == (4, dims.N, dims.nx, dims.nx)
    assert B_t.shape == (4, dims.N, dims.nx, dims.ns + dims.nu)
    np.testing.assert_allclose(A_t.numpy()[:, :-1], np.asarray(A_j)[:, :-1], atol=ATOL)
    np.testing.assert_allclose(B_t.numpy()[:, :-1], np.asarray(B_j)[:, :-1], atol=ATOL)
    assert torch.all(A_t[:, -1] == 0) and torch.all(B_t[:, -1] == 0)
    assert torch.all(B_t[..., : dims.ns] == 0)


@pytest.mark.parametrize("integrator", ["euler", "erk2", "erk4"])
def test_diffdrive_jacobians_by_integrator_match_jax(integrator):
    """``dynamics_jacobians`` (the solver's diff-drive Jacobians: forward-mode
    autodiff over any leading dims) against ``jax.jacfwd`` of the JAX
    package's discrete dynamics, for each integrator."""
    name = "boxerMpc.yaml"
    dims = MpcProblem(load_setup(config_path(name))).dims
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, dims.nx)).astype(np.float32)
    u = rng.normal(size=(3, 5, dims.nu)).astype(np.float32)
    F_j = jax_discrete(JaxProblem(jax_load_setup(config_path(name))).dims, 0.1, integrator, 4)
    jac_j = jax.vmap(jax.vmap(jax.jacfwd(F_j, argnums=(0, 1))))
    A_j, B_j = jac_j(jnp.asarray(x), jnp.asarray(u))
    F = make_discrete_dynamics(dims, 0.1, integrator, 4)
    A, Bu = dynamics_jacobians(F)(torch.as_tensor(x), torch.as_tensor(u))
    assert A.shape == (3, 5, dims.nx, dims.nx) and Bu.shape == (3, 5, dims.nx, dims.nu)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), atol=ATOL)
    np.testing.assert_allclose(Bu.numpy(), np.asarray(B_j), atol=ATOL)
