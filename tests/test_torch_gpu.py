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

import chip_smoke
from chip_smoke import random_general_inputs, random_sweep_inputs
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp

torch.set_num_threads(2)

#: (n, ns, N, B): the test dims, pointRobot's group shape, the panda fleet
#: shape, panda with a slack column, the panda rescue tier's shape
CASES = [(3, 0, 6, 5), (3, 1, 5, 5), (3, 0, 20, 1024), (7, 0, 20, 4096), (7, 1, 20, 64),
         (7, 0, 20, 512)]
#: (nx, nw, N, B, per-lane A/B): chip_smoke.py's general-sweep shapes and
#: boxer's rescue tier
GENERAL_CASES = [
    (6, 3, 5, 5, True), (14, 7, 20, 64, True), (8, 2, 10, 1024, True),
    (8, 2, 10, 4096, True), (8, 3, 10, 64, True), (8, 2, 10, 4096, False),
    (8, 2, 10, 128, True),
]
#: (B, N): batches that are no multiple of a block's lanes (8 for 16-thread
#: teams, 4 for 32-thread teams), and a one-stage horizon
RAGGED = [(1, 20), (37, 20), (1023, 20), (37, 1)]
ABC = dict(a=0.05, b1=0.00125, b2=0.05)


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


def _packed(B, N, n, seed=0):
    args = [torch.as_tensor(a, device="cuda") for a in random_sweep_inputs(B, N, 2 * n, n, seed)]
    return args, dict(N=N, nx=2 * n, nw=n, ns=0, **ABC)


def _general(B, N, nx, nw, per_lane=True, seed=0):
    args = [torch.as_tensor(a, device="cuda")
            for a in random_general_inputs(B, N, nx, nw, per_lane, seed)]
    return args, dict(N=N, nx=nx, nw=nw)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", RAGGED)
def test_ragged_batches_match_plain_on_card(B, N):
    """Both kernels, with 16- and 32-thread teams, at batches whose last
    block is part-filled (its spare teams store nothing) and at N=1."""
    _need_card()
    for n in (3, 7):
        args, kw = _packed(B, N, n)
        k, K, f = rp.riccati_backward_packed(*args, **kw)
        k_r, K_r, f_r = rp.riccati_backward_packed_reference(*args, **kw)
        torch.testing.assert_close(k, k_r, rtol=2e-3, atol=2e-5)
        torch.testing.assert_close(K, K_r, rtol=2e-3, atol=2e-5)
        assert torch.equal(f, f_r) and not f.any()
    for nx, nw in ((8, 2), (14, 7)):
        args, kw = _general(B, N, nx, nw)
        k, K, f = rb.riccati_backward_batched(*args, **kw)
        k_r, K_r, f_r = rb.riccati_backward_batched_reference(*args, **kw)
        torch.testing.assert_close(k, k_r, rtol=2e-3, atol=2e-4)
        torch.testing.assert_close(K, K_r, rtol=2e-3, atol=2e-4)
        assert torch.equal(f, f_r) and not f.any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3,), (7,), (8, 2)], ids=["packed_T16", "packed_T32", "general_T16"])
def test_bad_lanes_mid_block_fail_alone_on_card(shape):
    """A NaN lane (5) and a negative-definite lane (6) inside a block, beside
    healthy lanes of the same block and warp: each fails alone, the second
    with all-zero gains; the healthy lanes match the plain version."""
    _need_card()
    B, nan_lane, neg_lane = 11, 5, 6
    if len(shape) == 1:
        args, kw = _packed(B, 4, shape[0], seed=3)
        sweep, plain, tol = rp.riccati_backward_packed, rp.riccati_backward_packed_reference, 2e-5
    else:
        args, kw = _general(B, 4, *shape, seed=3)
        sweep, plain, tol = rb.riccati_backward_batched, rb.riccati_backward_batched_reference, 2e-4
    nw = kw["nw"]
    args[2][nan_lane, 1] = float("nan")
    args[4][neg_lane] = -10.0 * torch.eye(nw, device="cuda")
    k, K, f = sweep(*args, **kw)
    assert f.tolist() == [i in (nan_lane, neg_lane) for i in range(B)]
    assert torch.all(k[neg_lane] == 0) and torch.all(K[neg_lane] == 0)
    good = [i for i in range(B) if i not in (nan_lane, neg_lane)]
    k_r, K_r, _ = plain(*args, **kw)
    torch.testing.assert_close(k[good], k_r[good], rtol=2e-3, atol=tol)
    torch.testing.assert_close(K[good], K_r[good], rtol=2e-3, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["packed", "general_per_lane", "general_constant"])
def test_lane_independence_on_card(kernel):
    """Lane b swept alone equals lane b swept inside B=4096 bit for bit: a
    team's arithmetic does not depend on its block, its warp or its
    neighbours; shared-memory cross-talk between teams would break it."""
    _need_card()
    B = 4096
    if kernel == "packed":
        args, kw = _packed(B, 20, 7, seed=4)
        sweep = rp.riccati_backward_packed
    else:
        args, kw = _general(B, 10, 8, 2, per_lane=kernel == "general_per_lane", seed=4)
        sweep = rb.riccati_backward_batched
    k, K, f = sweep(*args, **kw)
    for b in (0, 1, 5, 1234, B - 1):
        alone = [a[b:b + 1].contiguous() if a.shape[0] == B else a for a in args]
        k1, K1, f1 = sweep(*alone, **kw)
        assert torch.equal(k1[0], k[b]) and torch.equal(K1[0], K[b]) and f1[0] == f[b]


@pytest.mark.gpu
def test_general_kernel_long_constant_horizon_on_card():
    """Batch-constant A/B whose horizon does not fit in a block's shared
    memory (700 stages of (8, 2)) are staged by each team instead, with the
    same result as the plain version."""
    _need_card()
    args, kw = _general(3, 700, 8, 2, per_lane=False, seed=6)
    args[5] *= 0.8  # a stable A keeps 700 stages of random data finite
    k, K, f = rb.riccati_backward_batched(*args, **kw)
    k_r, K_r, f_r = rb.riccati_backward_batched_reference(*args, **kw)
    torch.testing.assert_close(k, k_r, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(K, K_r, rtol=2e-3, atol=2e-4)
    assert torch.equal(f, f_r) and not f.any()


#: the single-robot planner's kernel shapes (B=1), from chip_smoke.py
PLANNER_PACKED = {k: v for k, v in chip_smoke.PACKED_SHAPES.items() if "planner" in k}
PLANNER_GENERAL = {k: v for k, v in chip_smoke.GENERAL_SHAPES.items() if "planner" in k}


@pytest.mark.gpu
@pytest.mark.parametrize("label", sorted(PLANNER_PACKED) + sorted(PLANNER_GENERAL))
def test_planner_shapes_match_plain_on_card(label):
    """Both kernels at the planner's B=1 (one team in a block of 4 or 8
    lanes, the rest dead) against their plain versions."""
    _need_card()
    if label in PLANNER_PACKED:
        B, N, n, _ = PLANNER_PACKED[label]
        args, kw = _packed(B, N, n, seed=1)
        sweep, plain, tol = rp.riccati_backward_packed, rp.riccati_backward_packed_reference, 2e-5
    else:
        B, N, nx, nw, per_lane = PLANNER_GENERAL[label]
        args, kw = _general(B, N, nx, nw, per_lane, seed=1)
        sweep, plain, tol = rb.riccati_backward_batched, rb.riccati_backward_batched_reference, 2e-4
    assert B == 1
    before = sweep.launches
    k, K, f = sweep(*args, **kw)
    assert sweep.launches == before + 1
    k_r, K_r, f_r = plain(*args, **kw)
    torch.testing.assert_close(k, k_r, rtol=2e-3, atol=tol)
    torch.testing.assert_close(K, K_r, rtol=2e-3, atol=tol)
    assert torch.equal(f, f_r) and not f.any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind,cap", [("panda", 100), ("pointRobot", 100), ("boxer", 10)])
def test_planner_scenarios_on_card(kind, cap):
    """chip_smoke.py's planner runs at reduced caps: every exit flag >= 0
    (checked in ``planner_run``), the robot's kernel launched at B=1 only,
    panda and pointRobot at their goals."""
    _need_card()
    sweep = rb.riccati_backward_batched if kind == "boxer" else rp.riccati_backward_packed
    with chip_smoke.launches_by_batch(1) as tally:
        before = sweep.launches
        sc, rec = chip_smoke.planner_run(kind, "cuda", cap)
    assert sweep.launches > before
    assert tally and all(B == 1 for _, B in tally)
    assert sc["planner"]._device.type == sc["sim"]._device.type == "cuda"
    if kind != "boxer":
        assert rec["reached_at"] is not None, rec["final_distance"]
    if kind == "pointRobot":
        assert rec["min_clearance"] > -0.05


@pytest.mark.gpu
def test_perception_and_global_planner_on_card():
    """The free-space carve and the obstacle enlargement on the card match
    their CPU runs (carve atol 1e-4, ``tests/test_perception.py``'s bar; the
    0/1 map's enlargement exactly), and both default to the card."""
    _need_card()
    import numpy as np

    from robot_mpcs_tpu_torch.global_planner.global_planner import GlobalPlanner, enlarge_obstacles
    from robot_mpcs_tpu_torch.perception import FreeSpaceDecomposition, free_space_halfplanes

    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-3, 3, size=(10, 64, 3)), dtype=torch.float32)
    pos = torch.as_tensor(rng.uniform(-0.5, 0.5, size=(10, 3)), dtype=torch.float32)
    card = free_space_halfplanes(pts.cuda(), pos.cuda(), number_constraints=6, max_radius=4.0)
    cpu = free_space_halfplanes(pts, pos, number_constraints=6, max_radius=4.0)
    assert card.device.type == "cuda"
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-4)
    assert FreeSpaceDecomposition()._device.type == "cuda"
    occ = (rng.random((128, 128)) < 0.15).astype(np.float32)
    assert np.array_equal(enlarge_obstacles(occ, 2, 0.29), enlarge_obstacles(occ, 2, 0.29, device="cpu"))
    assert GlobalPlanner([10, 10, 1], [-5.0, -5.0, 0.0], [5.0, 5.0, 1.0]).device.type == "cuda"
    chip_smoke.global_planner_phase()
