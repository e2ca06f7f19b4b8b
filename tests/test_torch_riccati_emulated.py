"""Both CUDA Riccati kernels compiled for the CPU and held against their
plain versions.

There is no card and no ``nvcc`` here, so ``tests/cuda_cpu_shim.h`` stands in
for the CUDA runtime: every CUDA thread is a host thread, the blocks of a
launch run one after another, ``__syncwarp``/``__syncthreads`` are barriers
over the threads of the warp/block, and a ``cp.async`` copy is done at
once. The sources are compiled with g++ after mechanical rewrites (the
shim for ``cuda_runtime.h``, the copy helpers' PTX, shared arrays as
statics of the one running block, launches through the shim). This checks
each kernel's indexing, team split, ring of stage buffers, ragged last
block and failure arithmetic on every tier-1 run; the card's memory model,
its compiler and the kernels' speed are checked on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). Tolerances are those of
the card tests: rtol 2e-3 with atol 2e-5 (structured) and 2e-4 (general).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import random_general_inputs, random_sweep_inputs
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp

torch.set_num_threads(2)

SHIM = Path(__file__).resolve().parent / "cuda_cpu_shim.h"
ABC = dict(a=0.05, b1=0.00125, b2=0.05)


def _rewrite(text, pattern, new, count=None):
    """``re.sub`` that fails if the source no longer holds ``pattern`` (or
    not ``count`` times)."""
    found = len(re.findall(pattern, text, re.S))
    assert found and (count is None or found == count), f"source changed: {pattern!r} found {found}x"
    return re.sub(pattern, new, text, flags=re.S)


def _compile(out_dir: Path, stem: str) -> Path:
    """g++ build of ``csrc/<stem>.cu`` against the shim; returns the library."""
    header = (_build.CSRC / "riccati_common.cuh").read_text()
    header = _rewrite(header, re.escape("#include <cuda_runtime.h>"), f'#include "{SHIM}"', 1)
    header = _rewrite(header, r"\n[^\n]*__cvta_generic_to_shared[^\n]*", "")
    header = _rewrite(header, r'asm volatile\("cp\.async\.ca[^\n]*', "*smem = *gmem;", 1)
    header = _rewrite(header, r'asm volatile\("cp\.async\.(commit|wait)_group[^\n]*', "", 2)
    (out_dir / "riccati_common.cuh").write_text(header)
    source = (_build.CSRC / f"{stem}.cu").read_text()
    if "extern __shared__" in source:
        source = _rewrite(source, re.escape("extern __shared__ float horizon[];"),
                          "float* horizon = emu_dynamic_shared();", 1)
    source = _rewrite(source, "__shared__", "static")
    source = _rewrite(source, r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                      r"emu_launch(\2, [&] { \1(\3); });")
    (out_dir / f"{stem}.cpp").write_text(source)
    lib = out_dir / f"lib{stem}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-o", str(lib),
         str(out_dir / f"{stem}.cpp")],
        check=True, capture_output=True, text=True,
    )
    return lib


def _load(lib: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    if hasattr(dll, "riccati_packed_launch"):
        dll.riccati_packed_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        )
    if hasattr(dll, "riccati_batched_launch"):
        dll.riccati_batched_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        )
    dll.emu_dynamic_bytes.restype = ctypes.c_size_t
    return dll


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernels for the CPU")
    out = tmp_path_factory.mktemp("emulated")
    return {stem: _compile(out, stem) for stem in ("riccati_packed", "riccati_batched")}


def _outputs(B, N, nx, nw):
    return (torch.full((B, N, nw), float("nan")), torch.full((B, N, nw, nx), float("nan")),
            torch.ones((B,), dtype=torch.bool))


def _packed(dll, args, N, nx, nw, ns, a, b1, b2):
    B = args[0].shape[0]
    k, K, f = _outputs(B, N, nx, nw)
    err = dll.riccati_packed_launch(*(t.data_ptr() for t in (*args, k, K, f)),
                                    B, N, nx, nw, ns, a, b1, b2, None)
    assert err == 0
    return k, K, f


def _general(dll, args, N, nx, nw):
    B = args[0].shape[0]
    A, Bm = args[5], args[6]
    k, K, f = _outputs(B, N, nx, nw)
    err = dll.riccati_batched_launch(*(t.data_ptr() for t in (*args, k, K, f)), B, N, nx, nw,
                                     N * nx * nx if A.dim() == 4 else 0,
                                     N * nx * nw if Bm.dim() == 4 else 0, None)
    assert err == 0
    return k, K, f


def _assert_matches(got, want, atol):
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=atol)
    assert torch.equal(got[2], want[2]) and not got[2].any()


#: (n, ns, N, B): 16- and 32-thread teams, with and without slack, ragged
#: last blocks, one-stage horizons
PACKED = [(3, 0, 6, 5), (3, 1, 5, 5), (7, 0, 20, 9), (7, 1, 20, 6), (3, 0, 1, 37), (7, 0, 3, 1)]
#: (nx, nw, N, B, per-lane A/B)
GENERAL = [(6, 3, 5, 5, True), (14, 7, 6, 5, True), (8, 2, 10, 9, True), (8, 3, 10, 6, True),
           (8, 2, 10, 17, False), (14, 7, 4, 5, False), (8, 2, 1, 37, True)]


@pytest.mark.parametrize("case", PACKED)
def test_packed_kernel_matches_plain(libs, case):
    n, ns, N, B = case
    args = [torch.as_tensor(v) for v in random_sweep_inputs(B, N, 2 * n, ns + n)]
    kw = dict(N=N, nx=2 * n, nw=ns + n, ns=ns, **ABC)
    got = _packed(_load(libs["riccati_packed"]), args, **kw)
    _assert_matches(got, rp.riccati_backward_packed_reference(*args, **kw), 2e-5)


@pytest.mark.parametrize("case", GENERAL)
def test_general_kernel_matches_plain(libs, case):
    nx, nw, N, B, per_lane = case
    args = [torch.as_tensor(v) for v in random_general_inputs(B, N, nx, nw, per_lane)]
    dll = _load(libs["riccati_batched"])
    got = _general(dll, args, N=N, nx=nx, nw=nw)
    # batch-constant A/B are staged once per block for the whole horizon
    assert dll.emu_dynamic_bytes() == (0 if per_lane else N * (nx * nx + nx * nw) * 4)
    _assert_matches(got, rb.riccati_backward_batched_reference(*args, N=N, nx=nx, nw=nw), 2e-4)


@pytest.mark.parametrize("shape", [(3,), (7,), (8, 2)], ids=["packed_T16", "packed_T32", "general_T16"])
def test_bad_lanes_mid_block_fail_alone(libs, shape):
    """A NaN lane (5) and a negative-definite lane (6) beside healthy lanes
    of the same block and warp: each fails alone, the second with zero gains."""
    B, nan_lane, neg_lane = 11, 5, 6
    if len(shape) == 1:
        n = shape[0]
        args = [torch.as_tensor(v) for v in random_sweep_inputs(B, 4, 2 * n, n, seed=3)]
        kw = dict(N=4, nx=2 * n, nw=n, ns=0, **ABC)
        sweep = lambda: _packed(_load(libs["riccati_packed"]), args, **kw)  # noqa: E731
        plain, atol = rp.riccati_backward_packed_reference, 2e-5
    else:
        args = [torch.as_tensor(v) for v in random_general_inputs(B, 4, *shape, seed=3)]
        kw = dict(N=4, nx=shape[0], nw=shape[1])
        sweep = lambda: _general(_load(libs["riccati_batched"]), args, **kw)  # noqa: E731
        plain, atol = rb.riccati_backward_batched_reference, 2e-4
    args[2][nan_lane, 1] = float("nan")
    args[4][neg_lane] = -10.0 * torch.eye(kw["nw"])
    k, K, f = sweep()
    assert f.tolist() == [i in (nan_lane, neg_lane) for i in range(B)]
    assert torch.all(k[neg_lane] == 0) and torch.all(K[neg_lane] == 0)
    good = [i for i in range(B) if i not in (nan_lane, neg_lane)]
    k_r, K_r, _ = plain(*args, **kw)
    torch.testing.assert_close(k[good], k_r[good], rtol=2e-3, atol=atol)
    torch.testing.assert_close(K[good], K_r[good], rtol=2e-3, atol=atol)


@pytest.mark.parametrize("kernel", ["packed", "general_per_lane", "general_constant"])
def test_lane_independence(libs, kernel):
    """Lane b swept alone equals lane b swept among 37, bit for bit."""
    B = 37
    if kernel == "packed":
        args = [torch.as_tensor(v) for v in random_sweep_inputs(B, 5, 14, 7, seed=4)]
        dll = _load(libs["riccati_packed"])
        sweep = lambda a: _packed(dll, a, N=5, nx=14, nw=7, ns=0, **ABC)  # noqa: E731
    else:
        per_lane = kernel == "general_per_lane"
        args = [torch.as_tensor(v) for v in random_general_inputs(B, 5, 8, 2, per_lane, seed=4)]
        dll = _load(libs["riccati_batched"])
        sweep = lambda a: _general(dll, a, N=5, nx=8, nw=2)  # noqa: E731
    k, K, f = sweep(args)
    for b in (0, 5, 13, B - 1):
        k1, K1, f1 = sweep([a[b:b + 1].clone() if a.shape[0] == B else a for a in args])
        assert torch.equal(k1[0], k[b]) and torch.equal(K1[0], K[b]) and f1[0] == f[b]


def test_constant_horizon_too_long_to_share_is_staged_per_team(libs, tmp_path):
    """Batch-constant A/B whose horizon passes the shared memory a block may
    have are staged by each team; the result does not change."""
    lib = tmp_path / "libriccati_batched_small.so"
    shutil.copy(libs["riccati_batched"], lib)  # a fresh copy reads the limit anew
    dll = _load(lib)
    dll.emu_set_shared_optin(1000)
    args = [torch.as_tensor(v) for v in random_general_inputs(9, 10, 8, 2, False)]
    got = _general(dll, args, N=10, nx=8, nw=2)
    assert dll.emu_dynamic_bytes() == 0
    _assert_matches(got, rb.riccati_backward_batched_reference(*args, N=10, nx=8, nw=2), 2e-4)
    assert np.isfinite(got[0].numpy()).all()
