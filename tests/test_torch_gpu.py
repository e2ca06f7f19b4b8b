"""Tests of the port that need a CUDA card (``gpu`` marker; they skip without
one). This file imports neither JAX nor ``tests/conftest.py``'s JAX setup, so
it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The CUDA kernel is held against its plain PyTorch version on the same CUDA
tensors at the tolerances of ``tests/test_riccati_packed.py:88-89`` (rtol
2e-3, atol 2e-5: f32 with sums in another order, FMA contraction on the card).
"""

import pytest
import torch

from chip_smoke import random_sweep_inputs
from robot_mpcs_tpu_torch.ops import riccati_packed as rp

torch.set_num_threads(2)

#: (n, ns, N, B): the test dims, the panda fleet shape, panda with a slack column
CASES = [(3, 0, 6, 5), (3, 1, 5, 5), (7, 0, 20, 4096), (7, 1, 20, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
