"""The port's structured Riccati sweep against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it must match
the JAX Pallas kernel (in interpret mode, as the JAX package's own tests run
it) and the JAX scan backward at the tolerances of
``tests/test_riccati_packed.py:88-89`` (rtol 2e-3, atol 2e-5: f32, with sums
in another order and the Schur-form vs full-form value update). The CUDA
kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_mpcs_tpu.ops.riccati_packed import detect_structure as jax_detect
from robot_mpcs_tpu.ops.riccati_packed import riccati_backward_packed as jax_packed
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp
from tests.test_riccati_packed import _random_data, _scan_backward, _structured_dyn

torch.set_num_threads(2)

DIMS = [(3, 0, 6), (7, 0, 20), (3, 1, 5)]
ABC = (0.05, 0.00125, 0.05)


def _port(args, **kw):
    return rp.riccati_backward_packed(*map(torch.as_tensor, args), **kw)


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_jax_kernel_and_scan(dims):
    n, ns, N = dims
    nx, nw, B = 2 * n, ns + n, 5
    A, Bm = _structured_dyn(n, ns, *map(np.float32, ABC))
    st = rp.detect_structure(A, Bm, nx=nx, ns=ns)
    assert st is not None
    np.testing.assert_allclose(st, jax_detect(A, Bm, nx=nx, ns=ns))
    data = _random_data(B, N, nx, nw)
    kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=st[0], b1=st[1], b2=st[2])

    launches = rp.riccati_backward_packed.launches
    k_t, K_t, f_t = _port(data, **kw)
    assert rp.riccati_backward_packed.launches == launches  # a CPU call is not a launch
    assert k_t.dtype == K_t.dtype == torch.float32 and f_t.dtype == torch.bool

    k_p, K_p, f_p = jax_packed(*map(jnp.asarray, data), **kw)
    Af = np.broadcast_to(A, (B, N, nx, nx)).copy()
    Bf = np.broadcast_to(Bm, (B, N, nx, nw)).copy()
    Af[:, -1] = 0.0
    Bf[:, -1] = 0.0
    lx, lw, lxx, lxw, lww, reg = data
    backward = _scan_backward(nx, nw, ns, N)
    k_s, K_s, f_s = jax.vmap(backward)(*map(jnp.asarray, (lx, lw, lxx, lxw, lww, Af, Bf, reg)))

    assert not f_t.any() and not np.asarray(f_p).any() and not np.asarray(f_s).any()
    for k_ref, K_ref in ((k_p, K_p), (k_s, K_s)):
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_ref), rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(K_t.numpy(), np.asarray(K_ref), rtol=2e-3, atol=2e-5)


def test_failed_lane_contract_matches_jax():
    n, ns, N, B = 3, 0, 4, 4
    nx, nw = 2 * n, n
    data = list(_random_data(B, N, nx, nw, seed=3))
    data[2][2, 1] = np.nan  # poison one lane mid-horizon
    kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=0.1, b1=0.005, b2=0.1)
    k, K, failed = _port(data, **kw)
    assert failed.tolist() == [False, False, True, False]
    assert torch.isfinite(k[[0, 1, 3]]).all() and torch.isfinite(K[[0, 1, 3]]).all()
    k_j, K_j, f_j = jax_packed(*map(jnp.asarray, data), **kw)
    assert np.asarray(f_j).tolist() == failed.tolist()
    np.testing.assert_allclose(k.numpy()[[0, 1, 3]], np.asarray(k_j)[[0, 1, 3]], rtol=2e-3, atol=2e-5)


def test_bad_pivot_zeroes_gains():
    """A negative-definite lww stage: pivot replaced by 1, gains zeroed (not
    NaN), lane failed, other lanes untouched."""
    n, N, B = 3, 3, 3
    data = list(_random_data(B, N, 2 * n, n, seed=5))
    data[4][1, 2] = -10.0 * np.eye(n, dtype=np.float32)
    k, K, failed = _port(data, N=N, nx=2 * n, nw=n, ns=0, a=0.1, b1=0.005, b2=0.1)
    assert failed.tolist() == [False, True, False]
    assert torch.all(k[1, 2] == 0) and torch.all(K[1, 2] == 0)
    assert torch.isfinite(k).all() and torch.isfinite(K).all()


def test_detect_structure_rejects_non_structured():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    B = rng.normal(size=(6, 3)).astype(np.float32)
    assert rp.detect_structure(A, B, nx=6, ns=0) is None
    assert rp.detect_structure(np.eye(5), np.zeros((5, 2)), nx=5, ns=0) is None


def test_non_cpu_non_cuda_tensor_raises():
    """Only a CPU tensor reaches the plain version; other devices never do."""
    data = [torch.as_tensor(a, device="meta") for a in _random_data(2, 3, 6, 3)]
    with pytest.raises(ValueError, match="no kernel for device"):
        rp.riccati_backward_packed(*data, N=3, nx=6, nw=3, ns=0, a=0.1, b1=0.005, b2=0.1)


_CASE = re.compile(r"^\s*RICCATI_CASE\(([\d,\s]+)\)", re.M)


def _instantiations(source):
    """The integer tuples of the RICCATI_CASE lines of ``csrc/<source>``."""
    text = (_build.CSRC / source).read_text()
    return [tuple(int(v) for v in case.split(",")) for case in _CASE.findall(text)]


@pytest.mark.parametrize("slack", [False, True], ids=["no_slack", "slack"])
@pytest.mark.parametrize("robot", ["pointRobot", "panda", "boxer"])
def test_every_solver_shape_is_instantiated(robot, slack):
    """Each shape the solver hands a CUDA kernel, for every robot with and
    without the slack column, has a RICCATI_CASE line, and that line's team
    size T passes the kernel's static_asserts: a team within one warp, with
    more threads than the 1 + nx solve columns (structured kernel: the rest
    assemble Qww) or at least as many (general kernel)."""
    setups = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}
    d = setups[robot]()
    d["mpc"]["slack"] = slack
    problem = MpcProblem(Setup.from_dict(d))
    dims = problem.dims
    nx, ns, nw = dims.nx, dims.ns, dims.ns + dims.nu
    stage = problem.solver_callbacks()[0]
    structured = None
    if isinstance(stage.dyn_jac, tuple):  # as build_solver selects the kernel
        A = np.asarray(stage.dyn_jac[0])
        B = np.concatenate([np.zeros((nx, ns)), np.asarray(stage.dyn_jac[1])], 1)
        structured = rp.detect_structure(A, B, nx=nx, ns=ns)
    assert (structured is not None) == (robot != "boxer")
    if structured is not None:
        teams = {c[:3]: c[3] for c in _instantiations("riccati_packed.cu")}
        T = teams.get((nx, nw, ns))
        assert T is not None and 32 % T == 0 and 1 + nx < T, ((nx, nw, ns), teams)
    else:
        teams = {c[:2]: c[2] for c in _instantiations("riccati_batched.cu")}
        T = teams.get((nx, nw))
        assert T is not None and 32 % T == 0 and 1 + nx <= T, ((nx, nw), teams)


def test_build_key_covers_included_headers():
    """Both kernel sources include the shared header, so an edit to it
    changes the library's hash (no stale library is loaded)."""
    header = _build.CSRC / "riccati_common.cuh"
    for stem in ("riccati_packed", "riccati_batched"):
        assert _build.source_files(_build.CSRC / f"{stem}.cu") == [
            _build.CSRC / f"{stem}.cu", header
        ]


@pytest.mark.parametrize("module", [rp, rb], ids=["packed", "batched"])
def test_missing_nvcc_raises(module, tmp_path, monkeypatch):
    """No nvcc: each kernel's build raises instead of falling back."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        module.build_kernel()
