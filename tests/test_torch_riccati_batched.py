"""The port's general Riccati sweep, its stage scan and its small Cholesky
solve against the JAX package.

On the CPU the port's ``riccati_backward_batched`` runs its plain PyTorch
version; it must match the JAX Pallas kernel (in interpret mode, as
``tests/test_riccati_pallas.py`` runs it) at that file's tolerances, rtol
2e-3 / atol 2e-4: both compute in f32, summing in other orders, with the
same LDL^T stage solve and full-form value update. The port's
``riccati_backend="scan"`` sweep must match the JAX scan backward (Cholesky,
full form) at the same tolerances. The CUDA kernel itself runs only on the
card (``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_mpcs_tpu.ops.linalg_small import chol_solve_unrolled as jax_chol
from robot_mpcs_tpu.ops.riccati_pallas import riccati_backward_batched as jax_batched
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops.linalg_small import chol_solve_unrolled
from robot_mpcs_tpu_torch.solver.al_ilqr import riccati_backward_scan
from tests.test_riccati_pallas import _random_lqr, _scan_backward

torch.set_num_threads(2)

#: (nx, nw, N): the JAX test dims (test_riccati_pallas.py:60) and boxer
DIMS = [(6, 3, 5), (14, 7, 20), (8, 2, 10)]
TOL = dict(rtol=2e-3, atol=2e-4)


def _data(B, N, nx, nw, batched_dyn, seed=0):
    """numpy stage data; batch-constant dynamics are lane 0's (N, ...) blocks."""
    data = [np.array(a) for a in _random_lqr(B, N, nx, nw, seed=seed)]
    if not batched_dyn:
        data[5], data[6] = data[5][0].copy(), data[6][0].copy()
    return data


def _port(data, **kw):
    return rb.riccati_backward_batched(*map(torch.as_tensor, data), **kw)


@pytest.mark.parametrize("batched_dyn", [True, False], ids=["batched_AB", "constant_AB"])
@pytest.mark.parametrize("dims", DIMS, ids=[f"{nx}x{nw}xN{N}" for nx, nw, N in DIMS])
def test_plain_matches_jax_kernel(dims, batched_dyn):
    nx, nw, N = dims
    data = _data(4, N, nx, nw, batched_dyn)
    kw = dict(N=N, nx=nx, nw=nw)
    launches = rb.riccati_backward_batched.launches
    k_t, K_t, f_t = _port(data, **kw)
    assert rb.riccati_backward_batched.launches == launches  # a CPU call is not a launch
    assert k_t.dtype == K_t.dtype == torch.float32 and f_t.dtype == torch.bool
    k_j, K_j, f_j = jax_batched(*map(jnp.asarray, data), **kw)
    assert not f_t.any() and not np.asarray(f_j).any()
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), **TOL)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), **TOL)


def test_failed_lane_contract_matches_jax():
    """A negative-definite lww lane fails with all-zero gains and a NaN lane
    fails alone; the other lanes are untouched (test_riccati_pallas.py:78-90)."""
    nx, nw, N, B = 6, 3, 4, 4
    data = _data(B, N, nx, nw, True, seed=1)
    data[4][1] = -10.0 * np.eye(nw, dtype=np.float32)
    data[2][3, 1] = np.nan
    k, K, failed = _port(data, N=N, nx=nx, nw=nw)
    assert failed.tolist() == [False, True, False, True]
    assert torch.all(k[1] == 0) and torch.all(K[1] == 0)
    assert torch.isfinite(k[[0, 1, 2]]).all() and torch.isfinite(K[[0, 1, 2]]).all()
    k_j, K_j, f_j = jax_batched(*map(jnp.asarray, data), N=N, nx=nx, nw=nw)
    assert np.asarray(f_j).tolist() == failed.tolist()
    np.testing.assert_allclose(k.numpy()[[0, 2]], np.asarray(k_j)[[0, 2]], **TOL)
    np.testing.assert_allclose(K.numpy()[[0, 2]], np.asarray(K_j)[[0, 2]], **TOL)


@pytest.mark.parametrize("batched_dyn", [True, False], ids=["batched_AB", "constant_AB"])
@pytest.mark.parametrize("dims", [(8, 2, 10), (14, 7, 20)], ids=["8x2xN10", "14x7xN20"])
def test_scan_backward_matches_jax_scan(dims, batched_dyn):
    nx, nw, N = dims
    data = _data(4, N, nx, nw, batched_dyn, seed=2)
    dyn_axis = 0 if batched_dyn else None
    backward = jax.vmap(
        _scan_backward(nx, nw, N), in_axes=(0, 0, 0, 0, 0, dyn_axis, dyn_axis, 0)
    )
    k_j, K_j, f_j = backward(*map(jnp.asarray, data))
    k_t, K_t, f_t = riccati_backward_scan(*map(torch.as_tensor, data))
    assert not f_t.any() and not np.asarray(f_j).any()
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), **TOL)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), **TOL)
    # the scan and the LDL^T plain version are two factorizations of one sweep
    k_p, K_p, _ = _port(data, N=N, nx=nx, nw=nw)
    np.testing.assert_allclose(k_t.numpy(), k_p.numpy(), **TOL)
    np.testing.assert_allclose(K_t.numpy(), K_p.numpy(), **TOL)


def test_scan_backward_failed_stage_is_zero():
    nx, nw, N = 6, 3, 4
    data = _data(3, N, nx, nw, True, seed=3)
    data[4][1, 2] = -10.0 * np.eye(nw, dtype=np.float32)
    k, K, failed = riccati_backward_scan(*map(torch.as_tensor, data))
    assert failed.tolist() == [False, True, False]
    assert torch.all(k[1, 2] == 0) and torch.all(K[1, 2] == 0)
    assert torch.isfinite(k).all() and torch.isfinite(K).all()


@pytest.mark.parametrize("n,m", [(1, 1), (3, 4), (7, 15)])
def test_chol_solve_matches_jax(n, m):
    rng = np.random.default_rng(n * 100 + m)
    A = rng.standard_normal((5, n, n))
    Q = (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    Q[3, 0, 0] = -1.0 - np.abs(Q[3]).sum()  # a non-positive first pivot
    Q[4, n - 1, n - 1] = np.nan
    rhs = rng.standard_normal((5, n, m)).astype(np.float32)
    X_j, bad_j = jax.vmap(jax_chol)(jnp.asarray(Q), jnp.asarray(rhs))
    X_t, bad_t = chol_solve_unrolled(torch.as_tensor(Q), torch.as_tensor(rhs))
    assert bad_t.tolist() == np.asarray(bad_j).tolist() == [False, False, False, True, True]
    np.testing.assert_allclose(X_t.numpy()[:3], np.asarray(X_j)[:3], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(X_t.numpy()[:3], np.linalg.solve(Q[:3], rhs[:3]), rtol=2e-4, atol=2e-4)


def test_non_cpu_non_cuda_tensor_raises():
    """Only a CPU tensor reaches the plain version; other devices never do."""
    data = [torch.as_tensor(a, device="meta") for a in _data(2, 3, 6, 3, True)]
    with pytest.raises(ValueError, match="no kernel for device"):
        rb.riccati_backward_batched(*data, N=3, nx=6, nw=3)
