"""The split expansion's two CUDA kernels compiled for the CPU and held
against their plain versions.

As in ``tests/test_torch_riccati_emulated.py`` (whose g++ build this file
uses): there is no card and no ``nvcc`` here, so ``tests/cuda_cpu_shim.h``
stands in for the CUDA runtime (host threads for CUDA threads, barriers for
``__syncwarp``, the dynamic shared memory a buffer per block), and
``csrc/fk_walk.cu`` and ``csrc/gn_assemble.cu`` are compiled with g++ for
each chain or shape they are tested at, with ``_build.defines``. This
checks the FK walk's chain tables (the walk, its structural-zero folds,
the Jacobian's columns) for every robot and the assembly's team split, CSR
tables, slack column and mirror, at ragged last blocks, on every tier-1
run; the card's compiler and speed are checked on the card
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

from test_torch_riccati_emulated import _compile_all

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
#: (robot, rows M, with the Jacobian): ragged last blocks of 128 threads
FK_CASES = [("panda", 300, True), ("panda", 77, False), ("pointRobot", 130, True), ("boxer", 129, True),
            ("mobilePanda", 257, True), ("mobilePanda", 5, False), ("chain6", 64, True)]
#: (robot, B, N): items of a 4-warp block with ragged last blocks, the
#: mobile panda's nv = 31, the slack columns
GN_CASES = [("panda", 3, 5), ("boxer", 5, 3), ("mobilePanda", 2, 7), ("pointRobotSlack", 3, 3),
            ("pandaSlack", 2, 5), ("chain6", 1, 9)]


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
        dll.gn_assemble_launch.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
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


def emulated_walk(dll, problem, q, want_jac):
    """The kernel's (P, J) of ``problem.walk_links`` at ``q (M, n)``."""
    table = fw.walk_table(problem.kin, problem.walk_links)
    M, n, L = q.shape[0], table.n, table.n_links
    P = torch.full((M, L, 3), float("nan"))
    J = torch.full((M, L, 3, n), float("nan")) if want_jac else None
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
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == (128, -(-M // 128), 0)


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
    err = dll.gn_assemble_launch(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in layout.tables),
                                 *(t.data_ptr() for t in outs), B, N, *layout.shape, None)
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
    # a warp per (lane, stage), 4 items a block, each its GnLayout
    item = 4 * _build.lane_floats("gn_assemble", layout.shape, 1)
    assert dll.gn_assemble_lane_bytes() == item
    items = 128 // _build.GN_TEAM
    assert (dll.emu_block_threads(), dll.emu_grid_blocks(), dll.emu_dynamic_bytes()) == (
        128, -(-B * N // items), items * item)


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
    assert dll.gn_assemble_launch(*([None] * 22), 1, 1, *shape, None) == _build.NO_INSTANTIATION
    assert dll.emu_grid_blocks() == before
