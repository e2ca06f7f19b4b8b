"""Tests of the port that need a CUDA card (``gpu`` marker; they skip without
one). This file imports neither JAX nor ``tests/conftest.py``'s JAX setup, so
it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Each CUDA kernel is held against its plain PyTorch version on the same CUDA
tensors: the structured sweep at the tolerances of
``tests/test_riccati_packed.py:88-89`` (rtol 2e-3, atol 2e-5), the general
sweep at those of ``tests/test_riccati_pallas.py:70-75`` (rtol 2e-3, atol
2e-4): f32 with sums in another order, FMA contraction on the card. The
split expansion's FK walk at 1e-5 absolute on P and J and its Gauss-Newton
assembly with each entry within 1e-4 of its own term scale (the sum of the
magnitudes of its terms, ``ops.gn_assemble.gn_term_scale``), the bars of
``tests/test_torch_fk_walk.py`` and ``tests/test_torch_gn_assemble.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import random_general_inputs, random_sweep_inputs
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp

torch.set_num_threads(2)

#: (n, ns, N, B): the test dims, pointRobot's group shape, the panda fleet
#: shape, panda with a slack column, the panda rescue tier's shape; shapes
#: compiled at first use: the 6-dof chain, 2 and 15 dof with slack, and 17
#: dof with slack (1 + nx = 35 solve columns on a 32-thread team)
CASES = [(3, 0, 6, 5), (3, 1, 5, 5), (3, 0, 20, 1024), (7, 0, 20, 4096), (7, 1, 20, 64),
         (7, 0, 20, 512), (6, 0, 20, 64), (2, 1, 20, 1024), (15, 1, 20, 1024), (17, 1, 20, 37)]
#: (nx, nw, N, B, per-lane A/B): chip_smoke.py's general-sweep shapes and
#: boxer's rescue tier; the mobile panda (22, 9) at its fleet's phase 1,
#: rescue tier and B=1, with slack (22, 10) batch-constant, and (36, 16):
#: 37 solve columns on a 32-thread team, 3 lanes per block, ragged at B=5
GENERAL_CASES = [
    (6, 3, 5, 5, True), (14, 7, 20, 64, True), (8, 2, 10, 1024, True),
    (8, 2, 10, 4096, True), (8, 3, 10, 64, True), (8, 2, 10, 4096, False),
    (8, 2, 10, 128, True), (22, 9, 20, 1024, True), (22, 9, 20, 128, True), (22, 9, 20, 1, True),
    (22, 10, 20, 1024, False), (36, 16, 20, 128, True), (36, 16, 20, 5, False),
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
    with pytest.raises(ValueError, match="not a holonomic shape"):
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
    # a shape of which not one lane fits a block's shared memory: refused,
    # naming the scan, nothing launched
    nx, nw = chip_smoke.OVERSIZED
    wide = [torch.as_tensor(a, device="cuda") for a in random_general_inputs(2, 3, nx, nw)]
    before = rb.riccati_backward_batched.launches
    with pytest.raises(ValueError, match='riccati_backend="scan"'):
        rb.riccati_backward_batched(*wide, N=3, nx=nx, nw=nw)
    assert rb.riccati_backward_batched.launches == before


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


def _fleet_problem(name):
    from robot_mpcs_tpu_torch.config import Setup, panda_setup, point_robot_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem

    return MpcProblem(Setup.from_dict({"panda": panda_setup, "pointRobot": point_robot_setup}[name]()))


@pytest.mark.gpu
def test_nccl_world1_step_equals_the_plain_step_on_card():
    """With a world-1 NCCL group the fleet step runs its two metric
    all-reduces and is otherwise the plain step: states equal to 1e-6,
    metrics and exit flags equal (chip_smoke.py's distributed phase at
    pointRobot B=256)."""
    _need_card()
    from robot_mpcs_tpu_torch.parallel import distributed
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.parallel.mesh import make_mesh

    problem = _fleet_problem("pointRobot")
    scenario = random_fleet_scenario(problem, 256, seed=0, **chip_smoke.sampler("pointRobot"))
    assert distributed.initialize(f"127.0.0.1:{chip_smoke.free_port()}", 1, 0, backend="nccl",
                                  device="cuda:0")
    try:
        runner = FleetRunner(problem, 256, mesh=make_mesh(), kick_scale=0.0)
        assert runner.mesh.group is not None and runner.device == torch.device("cuda", 0)
        s1, m1, _, f1 = chip_smoke.run_steps(torch, runner, runner.shard_scenario(scenario), 2)
    finally:
        distributed.shutdown()
    plain = FleetRunner(problem, 256, device="cuda", kick_scale=0.0)
    s0, m0, _, f0 = chip_smoke.run_steps(torch, plain, plain.to_device(scenario), 2)
    diff = chip_smoke.state_diff(torch, s1, s0)
    assert diff is not None and diff <= 1e-6
    assert m1 == m0 and torch.equal(f1, f0)


@pytest.mark.gpu
def test_two_gloo_ranks_share_one_card(tmp_path):
    """tests/torch_distributed_worker.py with both ranks on cuda:0: metrics
    identical on both ranks, each shard equal to a world-1 runner on its
    half on the card (flags equal, states within 1e-6)."""
    _need_card()
    import os
    import subprocess
    import sys

    import numpy as np

    from robot_mpcs_tpu_torch import interop
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario, random_fleet_scenario
    from robot_mpcs_tpu_torch.utils.checkpoint import save_fleet_state

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch_distributed_worker as worker

    problem = _fleet_problem("pointRobot")
    scenario = random_fleet_scenario(problem, worker.B, seed=worker.SEED, **worker.SAMPLER)
    w1, _ = FleetRunner(problem, worker.B, device="cuda", **worker.RUNNER_KW).run(scenario, 1)
    save_fleet_state(str(tmp_path / "w1.npz"), w1, extra={"world": 1})
    port = chip_smoke.free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(here, "torch_distributed_worker.py"), str(tmp_path), "cuda:0"],
            env=dict(os.environ, ROBOT_MPCS_COORDINATOR=f"127.0.0.1:{port}",
                     ROBOT_MPCS_NUM_PROCESSES="2", ROBOT_MPCS_PROCESS_ID=str(r),
                     PYTHONPATH=os.path.dirname(here)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [log[-3000:] for log in logs]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    metric_keys = [k for k in ranks[0] if k.startswith("m")]
    assert metric_keys and all(float(ranks[0][k]) == float(ranks[1][k]) for k in metric_keys)
    half = worker.B // 2
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        runner = FleetRunner(problem, half, device="cuda", **worker.RUNNER_KW)
        state, _, _, flags = chip_smoke.run_steps(
            torch, runner, runner.to_device(FleetScenario(scenario.xinit[rows], scenario.params[rows])),
            worker.STEPS)
        last = {k[len(f"s{worker.STEPS - 1}_"):]: v for k, v in ranks[r].items()
                if k.startswith(f"s{worker.STEPS - 1}_")}
        diff = chip_smoke.state_diff(torch, interop.state_from_numpy(last), state)
        assert diff is not None and diff <= 1e-6, (r, diff)
        assert np.array_equal(ranks[r]["flags"], flags.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("generic", [False, True], ids=["values", "generic"])
def test_reference_form_solves_on_card(generic):
    """The values path against the split path, and the generic path against
    itself on the CPU, at pointRobot B=64 (chip_smoke.hold_solves' bars);
    both run through the structured kernel."""
    _need_card()
    from robot_mpcs_tpu_torch.parallel.fleet import random_fleet_scenario
    from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

    problem = _fleet_problem("pointRobot")
    B = 64
    sc = random_fleet_scenario(problem, B, seed=0, **chip_smoke.sampler("pointRobot"))
    d = problem.dims
    z0 = torch.zeros((B, d.N, d.nz))
    z0[:, :, : d.nx] = sc.xinit[:, None, :]
    args = (sc.xinit, sc.params, z0, torch.zeros((B, d.N, problem.n_con)))
    stage, w_lb, w_ub = problem.solver_callbacks()
    if generic:
        stage = stage._replace(values=None, weights=None)

    def solver(device):
        return build_solver(stage, nx=d.nx, ns=d.ns, nu=d.nu, N=d.N, n_con=problem.n_con,
                            n_res=problem.n_res, n_bar=problem.n_bar, w_lb=w_lb, w_ub=w_ub,
                            cfg=problem.setup.solver,
                            pinned_rows=problem.reference_constraint_rows()[1], device=device)

    before = rp.riccati_backward_packed.launches
    res = solver("cuda")(*args)
    assert res.z.device.type == "cuda" and rp.riccati_backward_packed.launches > before
    other = solver("cpu")(*args) if generic else problem.build_solver(device="cuda")(*args)
    chip_smoke.hold_solves(torch, "values vs split" if not generic else "generic card vs CPU",
                           res, other)


@pytest.mark.gpu
def test_example_reaches_its_goal_on_card(capsys):
    """The pointRobot example's full episode on the card through the
    command line's path: goal reached, only the structured kernel and the
    split expansion's two launched, every launch at B=1."""
    _need_card()
    from robot_mpcs_tpu_torch.examples import point_robot_example

    with chip_smoke.launches_by_batch(1) as tally:
        before = rp.riccati_backward_packed.launches
        assert point_robot_example.main([]) == 0
    assert "goal reached at step" in capsys.readouterr().out
    assert rp.riccati_backward_packed.launches > before
    assert {name for name, _ in tally} == {"riccati_backward_packed", "fk_walk", "gn_assemble"}
    assert all(B == 1 for _, B in tally)


@pytest.mark.gpu
def test_artifact_loads_with_nvcc_unreachable_on_card(tmp_path):
    """``make_solver`` exports the panda artifact; a process without nvcc
    loads its library and solves as this one does; an altered fingerprint is
    declined and the kernel rebuilt (``chip_smoke.deploy_check``)."""
    _need_card()
    rec = chip_smoke.deploy_check("panda", str(tmp_path))
    assert rec["export"]["action_diff"] <= rec["export"]["bar"]


@pytest.mark.gpu
def test_mobile_panda_artifact_loads_with_nvcc_unreachable_on_card(tmp_path):
    """The mobile panda's artifact holds the general kernel compiled for
    (22, 9); a process without nvcc loads it and solves as this one does."""
    _need_card()
    rec = chip_smoke.deploy_check("mobilePanda", str(tmp_path), altered=False)
    assert rec["export"]["action_diff"] <= rec["export"]["bar"]


@pytest.mark.gpu
def test_one_library_per_shape_on_card():
    """A shape is built once and then loaded from the kernel cache; another
    shape is another library; its launcher refuses any shape but its own."""
    _need_card()
    from robot_mpcs_tpu_torch.ops import _build

    lib = rb.build_kernel(22, 9)
    assert rb.build_kernel(22, 9) is lib and _build.load_library("riccati_batched", [22, 9]) is lib
    path, log = _build.build_library("riccati_batched", (22, 9))
    assert log == "" and path.name == lib._name.rsplit("/", 1)[-1]
    assert rb.build_kernel(22, 10) is not lib
    args, _ = _general(2, 3, 22, 9)
    k = torch.empty((2, 3, 10), device="cuda")
    K = torch.empty((2, 3, 10, 22), device="cuda")
    f = torch.empty((2,), dtype=torch.bool, device="cuda")
    err = lib.riccati_batched_launch(*(t.data_ptr() for t in (*args, k, K, f)), 2, 3, 22, 10, 0, 0,
                                     torch.cuda.current_stream().cuda_stream)
    assert err == _build.NO_INSTANTIATION


@pytest.mark.gpu
def test_mobile_panda_fleet_on_card():
    """The mobile panda's fleet (B=256, 2 steps, rescue tier at 1/8) runs
    through the general kernel at (256, 20, 22, 9) and (32, 20, 22, 9)."""
    _need_card()
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

    problem = MpcProblem(Setup.from_dict(chip_smoke.mobile_panda_setup()))
    runner = FleetRunner(problem, 256, device="cuda", kick_scale=0.0)
    scen = runner.to_device(random_fleet_scenario(problem, 256, seed=0, **chip_smoke.MOBILE_SAMPLER))
    state = runner.init_state(scen)
    with chip_smoke.launches_by_batch(2) as tally:
        for _ in range(2):
            state, m = runner.step(state, scen)
    assert {B for name, B in tally if name == "riccati_backward_batched"} == {256, 32}
    assert torch.isfinite(state.x).all() and float(m.max_violation_converged) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("step,rank", chip_smoke.KICK_KEYS)
def test_kick_draw_on_card_equals_cpu(step, rank):
    """The kick's key, bits, uniforms and normals (``utils/prng.py``) on the
    card equal the CPU's bit for bit: integer ops, float32 ops that round
    alike, and ``log1p`` in float64 rounded once."""
    _need_card()
    card = chip_smoke.kick_draw(torch, step, rank, "cuda")
    host = chip_smoke.kick_draw(torch, step, rank, "cpu")
    for a, b in zip(card, host):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kick_fleet_on_card():
    """The kick fleet (B=256, 3 steps, kick after 2): lanes kicked at step 2
    with the CPU's draw, through the structured kernel at B=256 and 32."""
    _need_card()
    with chip_smoke.launches_by_batch(3) as tally:
        records = chip_smoke.kick_fleet_run(torch, "cuda", batch=256, steps=3)
    assert records[2]["kicked"] > 0 and records[2]["noise_vs_cpu_draw"] <= 1e-5
    assert {B for name, B in tally if name == "riccati_backward_packed"} == {256, 32}


@pytest.mark.gpu
def test_ros_logic_on_card():
    _need_card()
    before = rb.riccati_backward_batched.launches
    v, ticks = chip_smoke.ros_ticks("cuda")
    assert len(ticks) == 8 and v[0] > 0.05
    assert rb.riccati_backward_batched.launches > before


@pytest.mark.gpu
def test_bench_on_card(capsys, monkeypatch):
    """The port's benchmark on the card at B=512, extras off: two result
    lines that name the card and count the structured kernel's launches in
    the timed window; converged lanes feasible to tol_constraint."""
    _need_card()
    import json

    from robot_mpcs_tpu_torch import bench

    for k in ("ROBOT_MPCS_COORDINATOR", "MASTER_ADDR"):  # world 1: no rendezvous
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(BENCH_BATCH="512", BENCH_STEPS="2", BENCH_LATENCY="0",
                     BENCH_MULTICLASS="0").items():
        monkeypatch.setenv(k, v)
    assert bench.main([]) == 0
    head, last = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    extra = last["extra"]
    assert head["extra"]["device"] == extra["device"]
    assert extra["device"].startswith(torch.cuda.get_device_name(0))
    assert extra["riccati_launches"]["riccati_backward_packed"]["panda"] > 0
    assert extra["batch"] == 512 and extra["max_violation_converged"] <= 1e-4


def _panda_cold(B):
    from robot_mpcs_tpu_torch.config import Setup, panda_setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from robot_mpcs_tpu_torch.parallel.fleet import random_fleet_scenario

    problem = MpcProblem(Setup.from_dict(panda_setup()))
    sc = random_fleet_scenario(problem, B, seed=0, **chip_smoke.sampler("panda"))
    d = problem.dims
    z0 = torch.zeros((B, d.N, d.nz))
    z0[:, :, : d.nx] = sc.xinit[:, None, :]
    return problem, [t.cuda() for t in (sc.xinit, sc.params, z0, torch.zeros((B, d.N, problem.n_con)))]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
def test_graphed_solve_equals_eager_on_card(B):
    """The solve captured as one CUDA graph (its loops WHILE nodes) computes
    the eager loop's solve bit for bit, with the same kernel launches by
    batch size; a later solve is one replay with no host read, and returns
    tensors a later solve does not overwrite."""
    _need_card()
    from robot_mpcs_tpu_torch.solver import units

    problem, args = _panda_cold(B)
    with units._eager(), chip_smoke.launches_by_batch(1) as eager_tally:
        want = problem.build_solver(device="cuda")(*args)
    solve = problem.build_solver(device="cuda")
    first = solve(*args)  # warm-up and capture
    replays = units.replays
    with chip_smoke.launches_by_batch(1) as tally, chip_smoke.program_calls() as calls:
        again = solve(*args)
    assert units.replays == replays + 1 and tally == eager_tally
    assert [(reads, replayed) for _, reads, replayed, _ in calls] == [(0, 1)]  # one replay, no host read
    for name, a, b, c in zip(want._fields, want, first, again):
        assert torch.equal(a, b) and torch.equal(a, c), name
    other = [args[0] + 0.01] + args[1:]
    solve(*other)
    assert torch.equal(again.z, want.z)  # fresh tensors, not the carry


@pytest.mark.gpu
def test_unit_that_cannot_be_captured_raises_on_card():
    """A unit whose callbacks read a value on the host cannot be captured:
    the solve raises naming the unit, and never carries on eagerly. The
    read is in the split path's FK rows (``q_rows``), which the warm-up runs
    eagerly and the AL head is the first captured unit to call."""
    _need_card()
    from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver

    problem, args = _panda_cold(8)
    stage, split, w_lb, w_ub = problem.split_solver_callbacks()
    q_rows = stage.q_rows

    def reading(q, p, jac):
        vq, Jq = q_rows(q, p, jac)
        return vq * float(vq.abs().max() >= 0.0), Jq  # a host read

    d = problem.dims
    solve = build_solver(stage._replace(q_rows=reading), nx=d.nx, ns=d.ns, nu=d.nu, N=d.N,
                         n_con=problem.n_con, w_lb=w_lb, w_ub=w_ub, cfg=problem.setup.solver,
                         n_q=split["n_q"], q_seg=split["q_seg"], aff_seg=split["aff_seg"],
                         S_aff=split["S_aff"], device="cuda")
    with pytest.raises(RuntimeError, match="solver unit 'al_head' could not be captured"):
        solve(*args)


def _fleet_steps(runner, scen, steps):
    """``steps`` steps from the initial state: per step the state, metrics
    and merged exit flags on the CPU, the host reads and replays inside the
    step; with the launches by (kernel, B)."""
    from robot_mpcs_tpu_torch.solver import units

    state, out = runner.init_state(scen), []
    with chip_smoke.launches_by_batch(steps) as tally:
        for _ in range(steps):
            replays = units.replays
            with chip_smoke.host_reads() as reads:
                state, m = runner.step(state, scen)
            out.append(([t.cpu() for t in state], [t.cpu() for t in m],
                        runner._last_program.carry["exitflag"].cpu(), reads[0], units.replays - replays))
    return out, dict(tally)


@pytest.mark.gpu
@pytest.mark.parametrize("B,steps,kick_after", [(512, 3, 2), (4096, 2, 25)])
def test_whole_step_graph_equals_eager_on_card(B, steps, kick_after):
    """``FleetRunner.step`` captured whole (phase 1, the rescue tier, the
    post-step, the kick's draw, the metrics) equals the eager units bit for
    bit, the kick live at B=512; launches by (kernel, B), counted on the
    device under the graph, equal the eager counts (the structured sweep 16
    at 4096 + 50 at 512 a step at full width, the split expansion's kernels
    at both widths); each step after the first is one replay with no host
    read."""
    _need_card()
    from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
    from robot_mpcs_tpu_torch.solver import units

    problem, _ = _panda_cold(1)
    scenario = random_fleet_scenario(problem, B, seed=0, **chip_smoke.sampler("panda"))
    runs = {}
    for mode in ("eager", "graphed"):
        runner = FleetRunner(problem, B, device="cuda", kick_after=kick_after)
        with units._eager() if mode == "eager" else contextlib.nullcontext():
            runs[mode] = _fleet_steps(runner, runner.to_device(scenario), steps)
    (eager, eager_tally), (graphed, tally) = runs["eager"], runs["graphed"]
    assert tally == eager_tally
    if B == 4096:
        sweeps = {k: n for k, n in tally.items() if k[0] == "riccati_backward_packed"}
        assert sweeps == {("riccati_backward_packed", 4096): 16 * steps, ("riccati_backward_packed", 512): 50 * steps}
        assert {k for k in tally if k[0] != "riccati_backward_packed"} == {
            (name, b) for name in ("fk_walk", "gn_assemble") for b in (4096, 512)}
    for i, (e, g) in enumerate(zip(eager, graphed)):
        for a, b in zip(e[0] + e[1] + [e[2]], g[0] + g[1] + [g[2]]):
            assert torch.equal(a, b), i
        if i:
            assert g[3:] == (0, 1), i  # no host read, one replay


@pytest.mark.gpu
def test_planner_solve_is_one_replay_on_card():
    """A B=1 planner solve after the first is one graph replay with no host
    read inside it, and its action equals the eager planner's."""
    _need_card()
    from robot_mpcs_tpu_torch.solver import units

    runs = {}
    for mode in ("eager", "graphed"):
        with (units._eager() if mode == "eager" else contextlib.nullcontext()), \
                chip_smoke.program_calls() as calls:
            runs[mode] = (chip_smoke.planner_run("panda", "cuda", 4, replay=0)[1], calls)
    (e, _), (g, calls) = runs["eager"], runs["graphed"]
    assert all(np.array_equal(a, b) for a, b in zip(e["actions"], g["actions"])) and e["flags"] == g["flags"]
    assert [(reads, replays) for _, reads, replays, _ in calls[1:]] == [(0, 1)] * (len(calls) - 1)


@pytest.mark.gpu
def test_solver_without_conditional_nodes_raises_on_card(monkeypatch):
    """No fallback: where the card or driver has no conditional WHILE nodes
    (the capability check forced false), a solve raises naming them before
    it runs anything, and never carries on eagerly or per unit."""
    _need_card()
    from robot_mpcs_tpu_torch.ops import graph_cond

    problem, args = _panda_cold(8)
    monkeypatch.setattr(graph_cond, "missing", lambda device: "forced off by the test")
    solve = problem.build_solver(device="cuda")
    before = rp.riccati_backward_packed.launches
    with pytest.raises(RuntimeError, match="conditional graph nodes.*forced off"):
        solve(*args)
    assert rp.riccati_backward_packed.launches == before


#: the split expansion's kernels on the card: robots and (B, N), a width of
#: a 128-thread block and a ragged one (37 lanes)
EXPANSION_ROBOTS = ["panda", "pointRobot", "boxer", "mobilePanda", "chain6", "pointRobotSlack", "pandaSlack"]


def _expansion_problem(robot):
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem
    from test_torch_fk_gn_emulated import SETUPS

    return MpcProblem(Setup.from_dict(SETUPS[robot]()))


@pytest.mark.gpu
@pytest.mark.parametrize("robot", EXPANSION_ROBOTS)
@pytest.mark.parametrize("B", [64, 37])
def test_fk_walk_matches_plain_on_card(robot, B):
    """The FK walk kernel, with and without the Jacobian, reading q in place
    from states of width nx, against the plain walk on the same tensors; one
    counted launch a call."""
    _need_card()
    from robot_mpcs_tpu_torch.ops import fk_walk as fw

    problem = _expansion_problem(robot)
    d = problem.dims
    rng = np.random.default_rng(B)
    X = torch.as_tensor(rng.uniform(-np.pi, np.pi, size=(B, d.N, d.nx)).astype(np.float32), device="cuda")
    for jac in (True, False):
        before = fw.fk_walk.launches
        P, J = fw.fk_walk(problem.kin, X[..., : d.n], problem.walk_links, jac)
        assert fw.fk_walk.launches == before + 1
        P_r, J_r = fw.fk_walk_reference(problem.kin, X[..., : d.n], problem.walk_links, jac)
        torch.testing.assert_close(P, P_r, rtol=0, atol=1e-5)
        if jac:
            torch.testing.assert_close(J, J_r, rtol=0, atol=1e-5)
        else:
            assert J is None


@pytest.mark.gpu
@pytest.mark.parametrize("robot", EXPANSION_ROBOTS)
@pytest.mark.parametrize("B", [64, 37])
def test_gn_assemble_matches_plain_on_card(robot, B):
    """The assembly kernel against the plain version on the same tensors
    (penalties 1e1 to 1e5, active rows, dead barriers, the stage-0 pins;
    live barriers away from the clamp, then just above it), each entry within
    1e-4 of its own term scale (``chip_smoke.gn_excess``);
    lxx and lww exactly symmetric; one counted launch a call; each lane's
    blocks the same assembled alone."""
    _need_card()
    from robot_mpcs_tpu_torch.ops import gn_assemble as ga

    problem = _expansion_problem(robot)
    arrays, c_off = chip_smoke.random_gn_inputs(problem, B, problem.dims.N, seed=B)
    inputs = [torch.as_tensor(a, device="cuda") for a in arrays]
    layout = chip_smoke.gn_layout(problem, torch.as_tensor(c_off, device="cuda"))
    before = ga.gn_assemble.launches
    got = ga.gn_assemble(*inputs, layout=layout)
    assert ga.gn_assemble.launches == before + 1
    want = ga.gn_assemble_reference(*inputs, layout=layout)
    assert chip_smoke.gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout)) <= 1.0
    assert torch.equal(got[2], got[2].transpose(-1, -2)) and torch.equal(got[4], got[4].transpose(-1, -2))
    one = ga.gn_assemble(*(t[5:6] for t in inputs), layout=layout)
    assert all(torch.equal(o[0], g[5]) for o, g in zip(one, got))
    # live barriers just above the clamp, whose curvatures outweigh the rest
    arrays, _ = chip_smoke.random_gn_inputs(problem, B, problem.dims.N, seed=B, near_clamp=True)
    inputs = [torch.as_tensor(a, device="cuda") for a in arrays]
    got, want = ga.gn_assemble(*inputs, layout=layout), ga.gn_assemble_reference(*inputs, layout=layout)
    assert chip_smoke.gn_excess(got, want, ga.gn_term_scale(*inputs, layout=layout)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("robot", ["panda", "boxer", "pandaSlack"])
def test_split_expansion_runs_the_kernels_on_card(robot, monkeypatch):
    """The solver's split expansion on the card goes through both kernels
    (one launch of each a call, counted by B), and its blocks equal the same
    expansion assembled by the plain assembly from the same rows (each entry
    within 1e-4 of its own term scale). The rows are the walk kernel's in both,
    which ``test_fk_walk_matches_plain_on_card`` holds to the plain walk:
    rows composed from the walk (a clearance's norm, the legacy goal
    objective's scaled residuals) carry its rounding with cancellation, and
    a constraint row's rounding moves its PHR term by the penalty (up to 1e5
    here), so the whole expansion is not held to the plain walk's."""
    _need_card()
    from robot_mpcs_tpu_torch.ops import fk_walk as fw
    from robot_mpcs_tpu_torch.ops import gn_assemble as ga
    from robot_mpcs_tpu_torch.solver import al_ilqr
    from test_torch_fk_gn_emulated import split_rows

    problem = _expansion_problem(robot)
    d = problem.dims
    rng = np.random.default_rng(0)
    B = 16
    arrays = [(0.6 * rng.normal(size=(B, d.N, d.nx))).astype(np.float32),
              (0.4 * rng.normal(size=(B, d.N, d.nu + d.ns))).astype(np.float32),
              (np.abs(rng.normal(size=(B, d.N, problem.npar))) * 0.5 + 0.1).astype(np.float32),
              np.abs(rng.normal(size=(B, d.N, problem.n_con))).astype(np.float32),
              (10.0 ** rng.uniform(1, 5, size=(B,))).astype(np.float32)]
    if d.ns:
        arrays[1][..., 0] = np.abs(arrays[1][..., 0])
    args = [torch.as_tensor(a, device="cuda") for a in arrays]
    with chip_smoke.launches_by_batch(1) as tally:
        got = problem.build_solver(device="cuda")._internals["stage_expansion_blocks"](*args)
    assert dict(tally) == {("fk_walk", B): 1, ("gn_assemble", B): 1}
    assert fw.fk_walk.launches > 0 and ga.gn_assemble.launches > 0

    monkeypatch.setattr(al_ilqr, "gn_assemble", ga.gn_assemble_reference)
    solve = problem.build_solver(device="cuda")
    want = solve._internals["stage_expansion_blocks"](*args)
    X, W, P, lam, mu = args
    scale = ga.gn_term_scale(*split_rows(problem, X, W, P), lam, mu, W,
                             layout=chip_smoke.gn_layout(problem, solve._internals["C_OFF"]))
    assert chip_smoke.gn_excess(got, want, scale) <= 1.0
