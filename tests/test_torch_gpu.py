"""Tests of the port that need a CUDA card (``gpu`` marker; they skip without
one). This file imports neither JAX nor ``tests/conftest.py``'s JAX setup, so
it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Each CUDA kernel is held against its plain PyTorch version on the same CUDA
tensors: the structured sweep at the tolerances of
``tests/test_riccati_packed.py:88-89`` (rtol 2e-3, atol 2e-5), the general
sweep at those of ``tests/test_riccati_pallas.py:70-75`` (rtol 2e-3, atol
2e-4): f32 with sums in another order, FMA contraction on the card.
"""

import pytest
import torch

from chip_smoke import random_general_inputs, random_sweep_inputs
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp

torch.set_num_threads(2)

#: (n, ns, N, B): the test dims, pointRobot's group shape, the panda fleet
#: shape, panda with a slack column
CASES = [(3, 0, 6, 5), (3, 1, 5, 5), (3, 0, 20, 1024), (7, 0, 20, 4096), (7, 1, 20, 64)]
#: (nx, nw, N, B, per-lane A/B): chip_smoke.py's general-sweep shapes
GENERAL_CASES = [
    (6, 3, 5, 5, True), (14, 7, 20, 64, True), (8, 2, 10, 1024, True),
    (8, 2, 10, 4096, True), (8, 3, 10, 64, True), (8, 2, 10, 4096, False),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case):
    _need_card()
    n, ns, N, B = case
    nx, nw = 2 * n, ns + n
    args = [torch.as_tensor(a, device="cuda") for a in random_sweep_inputs(B, N, nx, nw)]
    kw = dict(N=N, nx=nx, nw=nw, ns=ns, a=0.05, b1=0.00125, b2=0.05)
    before = rp.riccati_backward_packed.launches
    k, K, f = rp.riccati_backward_packed(*args, **kw)
    assert rp.riccati_backward_packed.launches == before + 1
    k_r, K_r, f_r = rp.riccati_backward_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k, k_r, rtol=2e-3, atol=2e-5)
    torch.testing.assert_close(K, K_r, rtol=2e-3, atol=2e-5)
    assert torch.equal(f, f_r) and not f.any()


@pytest.mark.gpu
def test_kernel_nan_lane_and_input_checks_on_card():
    _need_card()
    args = [torch.as_tensor(a, device="cuda") for a in random_sweep_inputs(4, 4, 6, 3, seed=3)]
    args[2][2, 1] = float("nan")
    kw = dict(N=4, nx=6, nw=3, ns=0, a=0.1, b1=0.005, b2=0.1)
    k, K, f = rp.riccati_backward_packed(*args, **kw)
    assert f.tolist() == [False, False, True, False]
    assert torch.isfinite(k[[0, 1, 3]]).all() and torch.isfinite(K[[0, 1, 3]]).all()
    # the wrapper refuses what the kernel does not take
    with pytest.raises(TypeError, match="float32"):
        rp.riccati_backward_packed(*(a.double() for a in args), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rp.riccati_backward_packed(args[0], args[1], args[2].transpose(2, 3), *args[3:], **kw)
    with pytest.raises(ValueError, match="no CUDA instantiation"):
        rp.riccati_backward_packed(*args, **dict(kw, ns=2))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(0, 5), (3, 0)])
def test_empty_sweep_is_not_a_launch(B, N):
    """An empty batch or horizon returns empty gains and no failed lane
    without launching, so the launch counters count only real launches."""
    _need_card()
    def cut(arrays):  # (B, N, ...) stage blocks and reg (B,), cut to B lanes and N stages
        return [torch.as_tensor(a, device="cuda")[:B, :N] if a.ndim >= 3
                else torch.as_tensor(a, device="cuda")[:B] for a in arrays]

    general = cut(random_general_inputs(max(B, 1), max(N, 1), 8, 2))
    packed = cut(random_sweep_inputs(max(B, 1), max(N, 1), 6, 3))
    before = (rb.riccati_backward_batched.launches, rp.riccati_backward_packed.launches)
    for k, K, f in (
        rb.riccati_backward_batched(*general, N=N, nx=8, nw=2),
        rp.riccati_backward_packed(*packed, N=N, nx=6, nw=3, ns=0, a=0.1, b1=0.005, b2=0.1),
    ):
        assert k.shape[:2] == K.shape[:2] == (B, N) and f.tolist() == [False] * B
    assert (rb.riccati_backward_batched.launches, rp.riccati_backward_packed.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", GENERAL_CASES)
def test_general_kernel_matches_plain_on_card(case):
    _need_card()
    nx, nw, N, B, batched_dyn = case
    args = [torch.as_tensor(a, device="cuda") for a in random_general_inputs(B, N, nx, nw, batched_dyn)]
    kw = dict(N=N, nx=nx, nw=nw)
    before = rb.riccati_backward_batched.launches
    k, K, f = rb.riccati_backward_batched(*args, **kw)
    assert rb.riccati_backward_batched.launches == before + 1
    k_r, K_r, f_r = rb.riccati_backward_batched_reference(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k, k_r, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(K, K_r, rtol=2e-3, atol=2e-4)
    assert torch.equal(f, f_r) and not f.any()


@pytest.mark.gpu
def test_general_kernel_bad_lanes_and_input_checks_on_card():
    _need_card()
    kw = dict(N=4, nx=8, nw=2)
    args = [torch.as_tensor(a, device="cuda") for a in random_general_inputs(4, 4, 8, 2, seed=5)]
    args[4][1] = -10.0 * torch.eye(2, device="cuda")  # negative-definite lww
    args[2][3, 1] = float("nan")
    k, K, f = rb.riccati_backward_batched(*args, **kw)
    assert f.tolist() == [False, True, False, True]
    assert torch.all(k[1] == 0) and torch.all(K[1] == 0)
    assert torch.isfinite(k[[0, 1, 2]]).all() and torch.isfinite(K[[0, 1, 2]]).all()
    # the wrapper refuses what the kernel does not take
    with pytest.raises(TypeError, match="float32"):
        rb.riccati_backward_batched(*(a.double() for a in args), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rb.riccati_backward_batched(*args[:2], args[2].transpose(2, 3), *args[3:], **kw)
    with pytest.raises(ValueError, match="shape"):
        rb.riccati_backward_batched(*args[:5], args[5][:, :3], *args[6:], **kw)
    with pytest.raises(ValueError, match="on cpu"):
        rb.riccati_backward_batched(*args[:5], args[5].cpu(), *args[6:], **kw)
    wide = [torch.as_tensor(a, device="cuda") for a in random_general_inputs(2, 3, 10, 2)]
    with pytest.raises(ValueError, match="no CUDA instantiation"):
        rb.riccati_backward_batched(*wide, N=3, nx=10, nw=2)


@pytest.mark.gpu
def test_entry_points_default_to_the_card():
    """With no device argument the solver and the fleet run on the card,
    through the general kernel for the diff-drive problem."""
    _need_card()
    from robot_mpcs_tpu_torch.config import Setup, boxer_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel import FleetGroup
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

    problem = MpcProblem(Setup.from_dict(boxer_setup()))
    assert FleetRunner(problem, 16, compaction_ratio=0).device.type == "cuda"
    group = FleetGroup({"boxer": (problem, 16)}, compaction_ratio=0)
    assert group.runners["boxer"].device.type == "cuda"
    scen = random_fleet_scenario(problem, 16, seed=0)
    dims = problem.dims
    z0 = torch.zeros((16, dims.N, dims.nz))
    z0[:, :, : dims.nx] = scen.xinit[:, None, :]
    before = rb.riccati_backward_batched.launches
    res = problem.build_solver()(scen.xinit, scen.params, z0, torch.zeros((16, dims.N, problem.n_con)))
    assert res.z.device.type == "cuda" and torch.isfinite(res.z).all()
    assert rb.riccati_backward_batched.launches > before
