"""The split expansion's two CUDA kernels compiled for the CPU and held
against their plain versions.

As in ``tests/test_torch_riccati_emulated.py`` (whose g++ build this file
uses): there is no card and no ``nvcc`` here, so ``tests/cuda_cpu_shim.h``
stands in for the CUDA runtime (host threads for CUDA threads, barriers for
``__syncwarp``, the dynamic shared memory a buffer per block), and
``csrc/fk_walk.cu`` and ``csrc/gn_assemble.cu`` are compiled with g++ for
each chain or shape they are tested at, with ``_build.defines``. This
checks the FK walk's chain tables (the walk, its structural-zero folds,
the Jacobian's columns) for every robot, its staged q and its tiles' block
stores (ragged last blocks, an unaligned run, fewer rows where shared
memory is short), and the assembly's group staging, entry schedule, CSR
terms, slack column and mirror, at ragged last groups, with a persistent
grid that walks several groups a block and with one stage buffer or two,
on every tier-1 run; the card's compiler and speed are checked on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: the FK walk 1e-5 absolute on P and J (f32 with one sin/cos pair
per joint, as ``tests/test_torch_fk_walk.py`` holds the plain walk to the
JAX rule); the assembly each entry within 1e-4 of its own term scale,
the sum of its terms' magnitudes (``chip_smoke.gn_excess``: the kernel sums
each entry's rows in the JAX rule's order, the plain version in matrix
products), with live barrier rows away from the clamp and just above it.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import chain6_setup, gn_excess, gn_layout, mobile_panda_setup, random_gn_inputs
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.ops import fk_walk as fw
from robot_mpcs_tpu_torch.ops import gn_assemble as ga
from robot_mpcs_tpu_torch.utils import aot

from test_torch_riccati_emulated import _compile_all, _compile_cmd

torch.set_num_threads(2)


def _slack_point_setup():
    d = point_robot_setup()
    d["mpc"]["slack"] = True
    return d


def _panda_variant():
    """Panda with slack and velocity limits (``tests/test_torch_models.py``'s
    ``panda_variant_setup``): q-family constraint rows with a slack column."""
    d = panda_setup()
    d["mpc"]["slack"] = True
    d["mpc"]["constraints"] = d["mpc"]["constraints"] + ["VelLimitConstraints"]
    d["mpc"]["objectives"] = ["GoalMpcObjective", "ConstraintAvoidance"]
    d["mpc"]["weights"]["wconstr"] = [0.05, 0.0, 0.0, 0.0, 0.0]
    return d


#: robot -> its setup dict: the four fleet robots, pointRobot with slack,
#: panda with slack and velocity limits (q constraint rows with a slack
#: column) and the 6-dof chain
SETUPS = {"panda": panda_setup, "pointRobot": point_robot_setup, "boxer": boxer_setup,
          "mobilePanda": mobile_panda_setup, "chain6": chain6_setup,
          "pointRobotSlack": _slack_point_setup, "pandaSlack": _panda_variant}
#: (robot, rows M, with the Jacobian): ragged last blocks (and runs that end
#: in a scalar tail, 77 x 9 floats of P), one block of 5 rows
FK_CASES = [("panda", 300, True), ("panda", 77, False), ("pointRobot", 130, True), ("boxer", 129, True),
            ("mobilePanda", 257, True), ("mobilePanda", 5, False), ("chain6", 64, True)]
#: (robot, B, N): groups of 32 items with ragged last groups, the mobile
#: panda's nv = 31, the slack columns
GN_CASES = [("panda", 3, 5), ("boxer", 5, 3), ("mobilePanda", 2, 7), ("pointRobotSlack", 3, 3),
            ("pandaSlack", 2, 5), ("chain6", 1, 9)]
#: the card of the shim (``tests/cuda_cpu_shim.h``): an H100's opt-in shared
#: memory a block and its SMs
OPTIN, SMS = _build.SM90_SHARED_OPTIN, 132


def fk_launch(M, row_bytes, optin=OPTIN, sms=SMS):
    """(threads, blocks, dynamic shared bytes) the walk's launcher must
    choose (``_build.fk_rows_per_block``)."""
    rows = _build.fk_rows_per_block(M, row_bytes, optin, sms)
    return rows, -(-M // rows), rows * row_bytes


def gn_launch(M, block_bytes, sms=SMS):
    """(threads, blocks, dynamic shared bytes) the assembly's launcher must
    choose (``_build.gn_grid``)."""
    return _build.GN_THREADS, _build.gn_grid(M, block_bytes, sms), block_bytes


@pytest.fixture(scope="module")
def problems():
    return {name: MpcProblem(Setup.from_dict(make())) for name, make in SETUPS.items()}


@pytest.fixture(scope="module")
def libs(problems, tmp_path_factory):
    """{(stem, shape): library} for every robot's two expansion kernels."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernels for the CPU")
    pairs = {pair for p in problems.values() for pair in aot.expansion_kernels(p)}
    return _compile_all(tmp_path_factory.mktemp("emulated"), sorted(pairs))


def _load(path):
    dll = ctypes.CDLL(str(path))
    if hasattr(dll, "fk_walk_launch"):
        dll.fk_walk_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    if hasattr(dll, "gn_assemble_launch"):
        dll.gn_assemble_launch.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                                           + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    dll.emu_dynamic_bytes.restype = ctypes.c_size_t
    dll.emu_block_threads.restype = ctypes.c_uint
    dll.emu_grid_blocks.restype = ctypes.c_uint
    return dll


def _fk_lib(libs, problem):
    return _load(libs[aot.expansion_kernels(problem)[0]])


def _gn_lib(libs, problem):
    return _load(libs[aot.expansion_kernels(problem)[1]])


def random_q(problem, M, seed=0, stride=None):
    """``M`` configurations in [-pi, pi] (rows ``stride`` floats apart when
    given: a slice of wider rows, as the solver's states are)."""
    rng = np.random.default_rng(seed)
    n = problem.kin.n
    rows = rng.uniform(-np.pi, np.pi, size=(M, stride or n)).astype(np.float32)
    return torch.as_tensor(rows)[:, :n]


def emulated_walk(dll, problem, q, want_jac, offset=0):
    """The kernel's (P, J) of ``problem.walk_links`` at ``q (M, n)``;
    ``offset`` > 0 places P and J that many floats into their buffers (runs
    that are not 16-byte aligned)."""
    table = fw.walk_table(problem.kin, problem.walk_links)
    M, n, L = q.shape[0], table.n, table.n_links
    P = torch.full((offset + M * L * 3,), float("nan"))[offset:].view(M, L, 3)
    J = torch.full((offset + M * L * 3 * n,), float("nan"))[offset:].view(M, L, 3, n) if want_jac else None
    err = dll.fk_walk_launch(q.data_ptr(), q.stride(0), M, n, L, P.data_ptr(),
                             J.data_ptr() if want_jac else None, int(want_jac), None)
    assert err == 0
    return P, J


@pytest.mark.parametrize("case", FK_CASES, ids=[f"{r}-M{m}-{'jac' if j else 'pos'}" for r, m, j in FK_CASES])
def test_fk_walk_kernel_matches_plain(libs, problems, case):
    robot, M, want_jac = case
    problem = problems[robot]
    dll = _fk_lib(libs, problem)
    q = random_q(problem, M, seed=M, stride=problem.dims.nx)  # read in place, rows nx apart
    assert not q.is_contiguous() or problem.dims.nx == problem.kin.n
    P, J = emulated_walk(dll, problem, q, want_jac)
    P_ref, J_ref = fw.fk_walk_reference(problem.kin, q, problem.walk_links, want_jac)
    torch.testing.assert_close(P, P_ref, rtol=0, atol=1e-5)
    if want_jac:
        torch.testing.assert_close(J, J_ref, rtol=0, atol=1e-5)
    # a thread per row; the block's tiles take _build's figure a row
    shape = aot.expansion_kernels(problem)[0][1]
    row_bytes = 4 * _build.fk_row_floats(shape, want_jac)
    assert dll.fk_walk_row_bytes(int(want_jac)) == row_bytes
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == fk_launch(M, row_bytes)


def _fresh(libs, key, tmp_path, tag="fresh"):
    """A copy of a library under a new name: loaded anew, it reads the
    shim's card (shared memory, SMs) anew at its first launch."""
    lib = tmp_path / f"lib{key[0]}_{tag}.so"
    shutil.copy(libs[key], lib)
    return _load(lib)


@pytest.mark.parametrize("offset", [1, 2], ids=["P-J-off-by-4B", "P-J-off-by-8B"])
def test_fk_walk_unaligned_runs_store_float_by_float(libs, problems, offset):
    """P and J that do not start 16-byte aligned (views into larger
    buffers) are stored float by float, with the same result, bit for bit,
    as the aligned runs' 16-byte vectors."""
    problem = problems["panda"]
    dll = _fk_lib(libs, problem)
    q = random_q(problem, 203, seed=2, stride=problem.dims.nx)
    P, J = emulated_walk(dll, problem, q, True, offset=offset)
    P0, J0 = emulated_walk(dll, problem, q, True)
    assert P.data_ptr() % 16 and torch.equal(P, P0) and torch.equal(J, J0)
    P_ref, J_ref = fw.fk_walk_reference(problem.kin, q, problem.walk_links, True)
    torch.testing.assert_close(J, J_ref, rtol=0, atol=1e-5)


#: (robot, rows the card's shared memory holds, M): 40 rows give blocks of
#: 32, 10 give blocks of 8 (a multiple of 4 below a warp), 128 rows of the
#: mobile panda's J at 58 KB
FK_SHORT = [("panda", 40, 300), ("panda", 10, 45), ("mobilePanda", 128, 600)]


@pytest.mark.parametrize("robot,fit,M", FK_SHORT)
def test_fk_walk_fewer_rows_where_shared_memory_is_short(libs, problems, tmp_path, robot, fit, M):
    """A card whose shared memory holds fewer than 128 rows' tiles: the
    block shrinks to the rows that fit and the walk does not change; where
    not 4 rows fit, the launcher launches nothing (NO_ROOM)."""
    problem = problems[robot]
    key = aot.expansion_kernels(problem)[0]
    dll = _fresh(libs, key, tmp_path)
    row_bytes = 4 * _build.fk_row_floats(key[1], True)
    dll.emu_set_sm_count(1)  # no halving for an idle card: the rows are the limit's
    dll.emu_set_shared_optin(fit * row_bytes + row_bytes // 2)
    q = random_q(problem, M, seed=M, stride=problem.dims.nx)
    P, J = emulated_walk(dll, problem, q, True)
    want = fk_launch(M, row_bytes, optin=fit * row_bytes + row_bytes // 2, sms=1)
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == want
    P_ref, J_ref = fw.fk_walk_reference(problem.kin, q, problem.walk_links, True)
    torch.testing.assert_close(P, P_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(J, J_ref, rtol=0, atol=1e-5)
    none = _fresh(libs, key, tmp_path, "none")
    none.emu_set_shared_optin(4 * row_bytes - 4)
    before = none.emu_grid_blocks()
    n, L = q.shape[1], P.shape[1]
    assert none.fk_walk_launch(q.data_ptr(), q.stride(0), M, n, L, P.data_ptr(), J.data_ptr(), 1,
                               None) == _build.NO_ROOM
    assert none.emu_grid_blocks() == before


def test_fk_walk_launcher_refuses_another_chain(libs, problems):
    """A library launched for a width or link count other than its chain's
    returns NO_INSTANTIATION and launches nothing."""
    dll = _fk_lib(libs, problems["panda"])
    before = dll.emu_grid_blocks()
    assert dll.fk_walk_launch(None, 7, 1, 8, 3, None, None, 1, None) == _build.NO_INSTANTIATION
    assert dll.fk_walk_launch(None, 7, 1, 7, 2, None, None, 0, None) == _build.NO_INSTANTIATION
    assert dll.emu_grid_blocks() == before


def split_rows(problem, X, W, P):
    """The assembly's inputs before the multipliers at states ``X``, inputs
    ``W`` and parameters ``P``, as the solver's split
    ``stage_expansion_blocks`` forms them: ``(vq, Jq, va, wrq, wbq, wra,
    wba)``."""
    split = problem.split_callbacks()
    vq, Jq = split["q_rows"](X[..., : split["n_q"]], P, True)
    va = split["aff_rows"](torch.cat([X, W], -1), P)
    return (vq, Jq, va, *split["weights_split"](P))


def gn_inputs(problem, B, N, seed=0, near_clamp=False):
    """Rows, weights and multipliers of a split expansion at (B, N)
    (``chip_smoke.random_gn_inputs``: penalties 1e1 to 1e5 over the lanes,
    active constraint rows, dead barrier rows and live ones, the stage-0
    pins) as CPU tensors, and the problem's ``GnLayout``."""
    arrays, c_off = random_gn_inputs(problem, B, N, seed, near_clamp=near_clamp)
    return tuple(torch.as_tensor(a) for a in arrays), gn_layout(problem, torch.as_tensor(c_off))


def emulated_assembly(dll, inputs, layout):
    vq = inputs[0]
    B, N = vq.shape[:2]
    nx, nw = layout.nx, layout.nw
    outs = tuple(torch.full(s, float("nan")) for s in ((B, N, nx), (B, N, nw), (B, N, nx, nx),
                                                        (B, N, nx, nw), (B, N, nw, nw)))
    ins = [t.contiguous() for t in (*inputs[:9], layout.c_off, inputs[9])]
    sched, terms = layout.tables
    err = dll.gn_assemble_launch(*(t.data_ptr() for t in ins), sched.data_ptr(), layout.n_live, terms.data_ptr(),
                                 layout.n_terms, *(t.data_ptr() for t in outs), B, N, *layout.shape, None)
    assert err == 0
    return outs


@pytest.mark.parametrize("near_clamp", [False, True], ids=["live", "near-clamp"])
@pytest.mark.parametrize("case", GN_CASES, ids=[f"{r}-B{b}-N{n}" for r, b, n in GN_CASES])
def test_gn_assemble_kernel_matches_plain(libs, problems, case, near_clamp):
    robot, B, N = case
    problem = problems[robot]
    inputs, layout = gn_inputs(problem, B, N, seed=B * N, near_clamp=near_clamp)
    dll = _gn_lib(libs, problem)
    got = emulated_assembly(dll, inputs, layout)
    want = ga.gn_assemble_reference(*inputs, layout=layout)
    assert gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout)) <= 1.0
    # H is exactly symmetric: the mirrored blocks equal their transposes
    assert torch.equal(got[2], got[2].transpose(-1, -2)) and torch.equal(got[4], got[4].transpose(-1, -2))
    # 8 warps on groups of 32 items; the block takes _build's figure
    block = 4 * _build.gn_block_floats(layout.shape, _build.stage_depth("gn_assemble", layout.shape))
    assert dll.gn_assemble_block_bytes() == block
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == gn_launch(B * N, block)


def _depth_one(tmp_path, problem):
    """The assembly of ``problem`` g++-built with one stage buffer
    (``-DGN_D=1``, what ``_build`` picks where two do not fit a block)."""
    key = aot.expansion_kernels(problem)[1]
    cmd, lib = _compile_cmd(tmp_path, *key)
    cmd = [f for f in cmd if not f.startswith("-DGN_D=")] + ["-DGN_D=1"]
    lib1 = lib.with_name("libgn_assemble_d1.so")
    cmd[cmd.index(str(lib))] = str(lib1)
    subprocess.run(cmd, check=True, capture_output=True)
    return _load(lib1)


#: (robot, B, N, SMs of the shim's card, stage buffers): more groups than
#: the card's resident blocks, so each persistent block walks several, its
#: last group ragged; with two stage buffers and with one
GN_PERSISTENT = [("panda", 5, 20, 1, 2), ("pandaSlack", 7, 10, 1, 2), ("mobilePanda", 3, 20, 1, 2),
                 ("panda", 5, 20, 1, 1), ("pointRobotSlack", 12, 25, 1, 1)]


@pytest.mark.parametrize("case", GN_PERSISTENT, ids=[f"{r}-B{b}-N{n}-sm{s}-d{d}" for r, b, n, s, d in GN_PERSISTENT])
def test_gn_assemble_persistent_blocks_walk_several_groups(libs, problems, tmp_path, case):
    robot, B, N, sms, depth = case
    problem = problems[robot]
    if depth == 2:
        dll = _fresh(libs, aot.expansion_kernels(problem)[1], tmp_path)
    else:
        dll = _depth_one(tmp_path, problem)
    dll.emu_set_sm_count(sms)
    inputs, layout = gn_inputs(problem, B, N, seed=B + N)
    got = emulated_assembly(dll, inputs, layout)
    block = 4 * _build.gn_block_floats(layout.shape, depth)
    assert dll.gn_assemble_block_bytes() == block
    threads, grid, nbytes = gn_launch(B * N, block, sms=sms)
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == (threads, grid, nbytes)
    assert -(-B * N // _build.GN_ITEMS) > grid  # some block walks more than one group
    want = ga.gn_assemble_reference(*inputs, layout=layout)
    assert gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout)) <= 1.0
    # the same items in other groups and blocks: the same bits
    again = emulated_assembly(_load(libs[aot.expansion_kernels(problem)[1]]), inputs, layout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gn_assemble_is_lane_independent(libs, problems):
    """Lane b assembled alone equals lane b assembled among 5, bit for bit."""
    problem = problems["pandaSlack"]
    inputs, layout = gn_inputs(problem, 5, 4, seed=11)
    dll = _gn_lib(libs, problem)
    whole = emulated_assembly(dll, inputs, layout)
    for b in (0, 3):
        one = emulated_assembly(dll, [t[b:b + 1].clone() for t in inputs], layout)
        assert all(torch.equal(o[0], w[b]) for o, w in zip(one, whole))


def test_gn_assemble_launcher_refuses_another_shape(libs, problems):
    problem = problems["panda"]
    dll = _gn_lib(libs, problem)
    shape = list(aot.expansion_kernels(problem)[1][1])
    shape[0] += 1
    before = dll.emu_grid_blocks()
    assert dll.gn_assemble_launch(*([None] * 12), 0, None, 0, *([None] * 5), 1, 1, *shape,
                                  None) == _build.NO_INSTANTIATION
    assert dll.emu_grid_blocks() == before


def test_gn_assemble_refuses_what_does_not_fit(libs, problems, tmp_path):
    """Where the block's shared memory passes the card's, or the schedule or
    the terms pass their tables' room, the launcher launches nothing
    (NO_ROOM)."""
    problem = problems["panda"]
    key = aot.expansion_kernels(problem)[1]
    shape = list(key[1])
    dll = _fresh(libs, key, tmp_path)
    block = 4 * _build.gn_block_floats(key[1], _build.stage_depth(*key))
    dll.emu_set_shared_optin(block - 4)
    ptrs, outs = [None] * 12, [None] * 5
    assert dll.gn_assemble_launch(*ptrs, 0, None, 0, *outs, 1, 1, *shape, None) == _build.NO_ROOM
    full = _load(libs[key])
    before = full.emu_grid_blocks()
    nv = shape[7] + shape[8]
    too_many = _build.gn_terms_max(key[1]) + 1
    assert full.gn_assemble_launch(*ptrs, 0, None, too_many, *outs, 1, 1, *shape, None) == _build.NO_ROOM
    assert full.gn_assemble_launch(*ptrs, nv + nv * (nv + 1) // 2 + 1, None, 0, *outs, 1, 1, *shape,
                                   None) == _build.NO_ROOM
    assert full.emu_grid_blocks() == before and dll.emu_grid_blocks() == 0
