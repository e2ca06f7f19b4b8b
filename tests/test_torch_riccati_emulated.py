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


def _compile_cmd(out_dir: Path, stem: str, shape) -> tuple:
    """The g++ command that builds ``csrc/<stem>.cu`` for ``shape`` against
    the shim (with ``_build.defines``, as nvcc gets them), and its library."""
    header = (_build.CSRC / "riccati_common.cuh").read_text()
    header = _rewrite(header, re.escape("#include <cuda_runtime.h>"), f'#include "{SHIM}"', 1)
    header = _rewrite(header, r"\n[^\n]*__cvta_generic_to_shared[^\n]*", "")
    header = _rewrite(header, r'asm volatile\("cp\.async\.ca[^\n]*', "*smem = *gmem;", 1)
    header = _rewrite(header, r'asm volatile\("cp\.async\.(commit|wait)_group[^\n]*', "", 2)
    (out_dir / "riccati_common.cuh").write_text(header)
    source = (_build.CSRC / f"{stem}.cu").read_text()
    # a source without the shared helpers (csrc/fk_walk.cu) includes the
    # runtime itself
    source = source.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')
    # each lane's workspace (and the general kernel's horizon) is dynamic
    # shared memory: the running block's buffer
    if "extern __shared__" in source:
        source = _rewrite(source, re.escape("extern __shared__ float smem[];"),
                          "float* smem = emu_dynamic_shared();", 1)
    source = _rewrite(source, r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                      r"emu_launch(\2, [&] { \1(\3); });")
    (out_dir / f"{stem}.cpp").write_text(source)
    tag = _build.source_key(stem, shape)[:16] if stem == "fk_walk" else "_".join(map(str, shape))
    lib = out_dir / f"lib{stem}_{tag}.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", *_build.defines(stem, shape),
           "-o", str(lib), str(out_dir / f"{stem}.cpp")]
    return cmd, lib


def _compile_all(out_dir: Path, pairs, jobs=4) -> dict:
    """g++ builds of each (stem, shape) of ``pairs``, ``jobs`` at a time;
    returns {(stem, shape): library}."""
    cmds = {pair: _compile_cmd(out_dir, *pair) for pair in pairs}
    libs, pending = {}, list(cmds.items())
    while pending:
        batch, pending = pending[:jobs], pending[jobs:]
        procs = [(pair, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True)) for pair, (cmd, lib) in batch]
        for pair, lib, proc in procs:
            out = proc.communicate()[0]
            assert proc.returncode == 0, f"g++ of {pair} failed:\n{out}"
            libs[pair] = lib
    return libs


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
    dll.emu_block_threads.restype = ctypes.c_uint
    dll.emu_grid_blocks.restype = ctypes.c_uint
    return dll


#: (n, ns, N, B): 16- and 32-thread teams, with and without slack, ragged
#: last blocks, one-stage horizons, and (17, 1): 1 + nx = 35 columns on a
#: 32-thread team (assembly and solve apart, two columns for threads 0-2)
PACKED = [(3, 0, 6, 5), (3, 1, 5, 5), (7, 0, 20, 9), (7, 1, 20, 6), (3, 0, 1, 37), (7, 0, 3, 1),
          (17, 1, 4, 5), (17, 1, 1, 1)]
#: (nx, nw, N, B, per-lane A/B): the earlier shapes; the mobile panda (22,
#: 9) and with slack (22, 10); (36, 16), a 14-dof arm on a diff-drive base:
#: 1 + nx = 37 columns on a 32-thread team, 3 lanes per block (61.5 KB
#: each), so B = 5 leaves a ragged last block
GENERAL = [(6, 3, 5, 5, True), (14, 7, 6, 5, True), (8, 2, 10, 9, True), (8, 3, 10, 6, True),
           (8, 2, 10, 17, False), (14, 7, 4, 5, False), (8, 2, 1, 37, True),
           (22, 9, 5, 9, True), (22, 10, 4, 6, False), (36, 16, 3, 5, True), (36, 16, 2, 4, False)]


def _packed_shape(n, ns):
    return (2 * n, n + ns, ns)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{(stem, shape): library} for every shape the tests below launch."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernels for the CPU")
    pairs = {("riccati_packed", _packed_shape(n, ns)) for n, ns, _, _ in PACKED}
    pairs |= {("riccati_batched", (nx, nw)) for nx, nw, *_ in GENERAL}
    return _compile_all(tmp_path_factory.mktemp("emulated"), sorted(pairs))


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


OPTIN = _build.SM90_SHARED_OPTIN  # the shim's card: an H100's opt-in shared memory


def _launch_config(stem, shape, B, horizon=0, optin=OPTIN):
    """(threads per block, blocks, dynamic shared bytes) that the launcher
    must choose: up to 128 / T lanes, as many as ``optin`` holds; a shared
    horizon only where it costs no lane."""
    T = _build.team_size(shape[0])
    lane = 4 * _build.lane_floats(stem, shape, _build.stage_depth(stem, shape))
    lanes = min(128 // T, optin // lane)
    if horizon and min(128 // T, (optin - horizon) // lane) < lanes:
        horizon = 0
    return lanes * T, -(-B // lanes), horizon + lanes * lane


@pytest.mark.parametrize("case", PACKED)
def test_packed_kernel_matches_plain(libs, case):
    n, ns, N, B = case
    args = [torch.as_tensor(v) for v in random_sweep_inputs(B, N, 2 * n, ns + n)]
    kw = dict(N=N, nx=2 * n, nw=ns + n, ns=ns, **ABC)
    dll = _load(libs[("riccati_packed", _packed_shape(n, ns))])
    got = _packed(dll, args, **kw)
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == _launch_config(
        "riccati_packed", _packed_shape(n, ns), B)
    _assert_matches(got, rp.riccati_backward_packed_reference(*args, **kw), 2e-5)


@pytest.mark.parametrize("case", GENERAL)
def test_general_kernel_matches_plain(libs, case):
    nx, nw, N, B, per_lane = case
    args = [torch.as_tensor(v) for v in random_general_inputs(B, N, nx, nw, per_lane)]
    dll = _load(libs[("riccati_batched", (nx, nw))])
    got = _general(dll, args, N=N, nx=nx, nw=nw)
    # batch-constant A/B are staged once per block for the whole horizon,
    # ahead of the lanes' workspaces
    horizon = 0 if per_lane else N * (nx * nx + nx * nw) * 4
    want = _launch_config("riccati_batched", (nx, nw), B, horizon)
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == want
    assert want[2] > horizon or per_lane
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
        dll = _load(libs[("riccati_packed", _packed_shape(n, 0))])
        sweep = lambda: _packed(dll, args, **kw)  # noqa: E731
        plain, atol = rp.riccati_backward_packed_reference, 2e-5
    else:
        args = [torch.as_tensor(v) for v in random_general_inputs(B, 4, *shape, seed=3)]
        kw = dict(N=4, nx=shape[0], nw=shape[1])
        dll = _load(libs[("riccati_batched", shape)])
        sweep = lambda: _general(dll, args, **kw)  # noqa: E731
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
        dll = _load(libs[("riccati_packed", (14, 7, 0))])
        sweep = lambda a: _packed(dll, a, N=5, nx=14, nw=7, ns=0, **ABC)  # noqa: E731
    else:
        per_lane = kernel == "general_per_lane"
        args = [torch.as_tensor(v) for v in random_general_inputs(B, 5, 8, 2, per_lane, seed=4)]
        dll = _load(libs[("riccati_batched", (8, 2))])
        sweep = lambda a: _general(dll, a, N=5, nx=8, nw=2)  # noqa: E731
    k, K, f = sweep(args)
    for b in (0, 5, 13, B - 1):
        k1, K1, f1 = sweep([a[b:b + 1].clone() if a.shape[0] == B else a for a in args])
        assert torch.equal(k1[0], k[b]) and torch.equal(K1[0], K[b]) and f1[0] == f[b]


def _fresh(libs, key, tmp_path):
    """A copy of a library under a new name: loaded anew, it reads the
    shim's shared-memory limit anew."""
    lib = tmp_path / f"lib{key[0]}_fresh.so"
    shutil.copy(libs[key], lib)
    return _load(lib)


def test_constant_horizon_too_long_to_share_is_staged_per_team(libs, tmp_path):
    """Batch-constant A/B whose horizon would cost the block a lane are
    staged by each team; the result does not change."""
    dll = _fresh(libs, ("riccati_batched", (8, 2)), tmp_path)
    lane = 4 * _build.lane_floats("riccati_batched", (8, 2), 3)
    dll.emu_set_shared_optin(8 * lane + 1000)  # 8 lanes, not the 3,200-byte horizon
    args = [torch.as_tensor(v) for v in random_general_inputs(9, 10, 8, 2, False)]
    got = _general(dll, args, N=10, nx=8, nw=2)
    assert dll.emu_dynamic_bytes() == 8 * lane and dll.emu_block_threads() == 128
    _assert_matches(got, rb.riccati_backward_batched_reference(*args, N=10, nx=8, nw=2), 2e-4)
    assert np.isfinite(got[0].numpy()).all()


#: (stem, shape, lanes the limit holds, B): fewer lanes per block than
#: 128 / T, with ragged last blocks; (8, 2) on one 16-thread lane, a block
#: of less than a warp
FEWER_LANES = [("riccati_batched", (22, 10), 2, 5), ("riccati_batched", (36, 16), 1, 3),
               ("riccati_batched", (8, 2), 1, 3), ("riccati_packed", (14, 7, 0), 3, 7),
               ("riccati_packed", (34, 18, 1), 2, 3)]


@pytest.mark.parametrize("stem,shape,lanes,B", FEWER_LANES)
def test_fewer_lanes_per_block_where_shared_memory_is_short(libs, tmp_path, stem, shape, lanes, B):
    """A card whose shared memory holds fewer lanes than 128 / T: the block
    shrinks to the lanes that fit and the sweep does not change."""
    dll = _fresh(libs, (stem, shape), tmp_path)
    lane = 4 * _build.lane_floats(stem, shape, _build.stage_depth(stem, shape))
    dll.emu_set_shared_optin(lanes * lane + lane // 2)
    nx, nw = shape[:2]
    if stem == "riccati_packed":
        args = [torch.as_tensor(v) for v in random_sweep_inputs(B, 3, nx, nw, seed=6)]
        kw = dict(N=3, nx=nx, nw=nw, ns=shape[2], **ABC)
        got, want, atol = _packed(dll, args, **kw), rp.riccati_backward_packed_reference(*args, **kw), 2e-5
    else:
        args = [torch.as_tensor(v) for v in random_general_inputs(B, 3, nx, nw, False, seed=6)]
        kw = dict(N=3, nx=nx, nw=nw)
        got, want, atol = _general(dll, args, **kw), rb.riccati_backward_batched_reference(*args, **kw), 2e-4
    want_launch = _launch_config(stem, shape, B, 4 * 3 * (nx * nx + nx * nw) if stem != "riccati_packed" else 0,
                                 optin=lanes * lane + lane // 2)
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == want_launch
    assert want_launch[0] == lanes * _build.team_size(nx)
    _assert_matches(got, want, atol)


@pytest.mark.parametrize("stem,shape", sorted(
    {("riccati_packed", _packed_shape(n, ns)) for n, ns, _, _ in PACKED}
    | {("riccati_batched", (nx, nw)) for nx, nw, *_ in GENERAL}))
def test_lane_bytes_and_launcher_refusals(libs, tmp_path, stem, shape):
    """The source's layout equals ``_build.lane_floats`` (what the wrapper
    checks before a build); its launcher refuses a shape other than its
    own (NO_INSTANTIATION) and, where not one lane fits, launches nothing
    (NO_ROOM)."""
    dll = _fresh(libs, (stem, shape), tmp_path)
    lane = 4 * _build.lane_floats(stem, shape, _build.stage_depth(stem, shape))
    assert getattr(dll, f"{stem}_lane_bytes")() == lane
    nx, nw = shape[:2]
    launch = getattr(dll, f"{stem}_launch")
    ptrs = [None] * (9 if stem == "riccati_packed" else 11)
    if stem == "riccati_packed":
        other = launch(*ptrs, 1, 1, nx, nw, 1 - shape[2], 0.1, 0.1, 0.1, None)
        dll.emu_set_shared_optin(lane - 4)
        none = launch(*ptrs, 1, 1, nx, nw, shape[2], 0.1, 0.1, 0.1, None)
    else:
        other = launch(*ptrs, 1, 1, nx, nw + 1, 0, 0, None)
        dll.emu_set_shared_optin(lane - 4)
        none = launch(*ptrs, 1, 1, nx, nw, 0, 0, None)
    assert (other, none) == (_build.NO_INSTANTIATION, _build.NO_ROOM)
    assert dll.emu_grid_blocks() == 0  # nothing was launched
