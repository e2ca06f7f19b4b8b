"""The port's global planner, fleet checkpoints, profiling helpers and
visualizer against the JAX package's, on the CPU.

Tolerances, and why:

* ``enlarge_obstacles``: equal maps. The grids are 0/1 occupancy, so a
  blurred cell is a count over the kernel's cells and no f32 rounding of
  the box sum lands on the threshold;
* A* (the Python fallback, with or without ``native/libastar.so``) is the
  same host code on both sides: equal paths;
* a fleet step resumed from a JAX-written checkpoint: converged fraction
  equal and mean goal distance within 2% of the JAX step's (the fleet bars
  of ``tests/test_torch_fleet.py``).
"""

import json
import os
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import robot_mpcs_tpu.global_planner.astar as jax_astar
from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.global_planner.global_planner import (
    GlobalPlanner as JaxGlobalPlanner,
    enlarge_obstacles as jax_enlarge,
)
from robot_mpcs_tpu.global_planner.grid_map import OccupancyGridMap as JaxGridMap
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.fleet import random_fleet_scenario as jax_scenario
from robot_mpcs_tpu.parallel.mesh import make_mesh
from robot_mpcs_tpu.utils.checkpoint import save_fleet_state as jax_save
import robot_mpcs_tpu_torch.global_planner.astar as astar
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.config import Setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.global_planner import GlobalPlanner, OccupancyGridMap, a_star
from robot_mpcs_tpu_torch.global_planner.global_planner import enlarge_obstacles
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
from robot_mpcs_tpu_torch.utils import StepTimer, load_fleet_state, save_fleet_state, timed, trace

torch.set_num_threads(2)

B = 16
SAMPLER = dict(  # bench.py's pointRobot sampler
    goal_box=((-2.0, -2.0, 0.05), (2.0, 2.0, 0.05)),
    obstacle_box=((-1.5, -1.5, 0.05), (1.5, 1.5, 0.05)),
)
RUNNER_KW = dict(compaction_ratio=2, kick_scale=0.0)  # rescue tier on, no random kick


def _occupancy(seed, shape=(64, 64), p=0.15):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.float32)


@pytest.mark.parametrize("seed,k,threshold", [(0, 2, 0.29), (1, 1, 0.1), (2, 4, 0.29)])
def test_enlarge_obstacles_matches_jax(seed, k, threshold):
    occ = _occupancy(seed)
    got = enlarge_obstacles(occ, k, threshold, device="cpu")
    want = jax_enlarge(occ, k, threshold)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # border cells keep their original (binarized) value
    np.testing.assert_array_equal(got[:k], (occ[:k] > threshold).astype(np.float32))


def _maze(seed):
    grid = _occupancy(seed, (40, 40), 0.2)
    grid[:, 20] = 1.0
    grid[30:33, 20] = 0.0  # one gap in the wall
    grid[2, 2] = grid[37, 37] = 0.0
    return grid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_astar_fallback_matches_jax(seed, connectivity):
    grid = _maze(seed)
    got = astar.astar_grid(grid, (2, 2), (37, 37), connectivity=connectivity, use_native=False)
    want = jax_astar.astar_grid(grid, (2, 2), (37, 37), connectivity=connectivity, use_native=False)
    assert got == want
    if got:
        assert got[0] == (2, 2) and got[-1] == (37, 37)
        assert all(grid[y, x] < 0.8 for x, y in got)


def test_a_star_meters_and_global_planner_match_jax(monkeypatch):
    """Without the native library (as in a checkout that never built it)."""
    monkeypatch.setattr(astar, "_NATIVE", None)
    monkeypatch.setattr(jax_astar, "_NATIVE", None)
    grid = _maze(2)
    got = a_star((0.5, 0.5), (9.0, 9.0), OccupancyGridMap(grid, 0.25))
    want = jax_astar.a_star((0.5, 0.5), (9.0, 9.0), JaxGridMap(grid, 0.25))
    assert got == want and got[0]
    with pytest.raises(ValueError, match="not traversable"):
        astar.astar_grid(grid, (20, 0), (37, 37))

    kw = dict(dim_pixels=np.array([40, 40, 1]), limits_low=np.array([-5.0, -5.0, 0.0]),
              limits_high=np.array([5.0, 5.0, 1.0]), threshold_local_goal=1.0)
    ours, ref = GlobalPlanner(device="cpu", **kw), JaxGlobalPlanner(**kw)
    occ3d = np.zeros((40, 40, 1), np.float32)
    occ3d[15:25, 18:22, 0] = 1.0  # central block
    for gp in (ours, ref):
        gp.get_occupancy_map(None, occ3d)
    np.testing.assert_array_equal(ours.get_enlarged_obstacles(), ref.get_enlarged_obstacles())
    start, goal = np.array([-3.0, -3.0, 0.0]), np.array([3.0, 3.0, 0.0])
    path, path_px = ours.get_global_path_astar(start, goal)
    want_path, want_px = ref.get_global_path_astar(start, goal)
    assert path_px == want_px and len(path) > 0
    np.testing.assert_array_equal(np.asarray(path), np.asarray(want_path))
    for pos in ([-3.0, -3.0], [5.0, 5.0], path[1][:2]):
        np.testing.assert_array_equal(ours.get_local_goal(pos, path), ref.get_local_goal(pos, path))


@pytest.fixture(scope="module")
def point_problems():
    return (MpcProblem(Setup.from_dict(point_robot_setup())),
            JaxProblem(JaxSetup.from_dict(point_robot_setup())))


def test_checkpoint_round_trip(point_problems, tmp_path):
    tp, _ = point_problems
    runner = FleetRunner(tp, 8, device="cpu", compaction_ratio=0, kick_scale=0.0)
    scen = random_fleet_scenario(tp, 8, seed=5, **SAMPLER)
    state = runner.init_state(scen)
    for _ in range(2):
        state, _ = runner.step(state, scen)
    path = str(tmp_path / "sub" / "fleet.npz")
    save_fleet_state(path, state, extra={"seed": 5})
    assert os.listdir(tmp_path / "sub") == ["fleet.npz"]  # no temp file left
    restored, extra = load_fleet_state(path, problem=tp, batch_size=8, device="cpu")
    assert extra == {"seed": 5}
    assert int(restored.step) == 2
    for k, v in state._asdict().items():
        got = getattr(restored, k)
        assert got.dtype == v.dtype and got.device.type == "cpu"
        assert torch.equal(got, v), k
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
    assert meta["version"] == 2
    assert meta["dims"] == {"batch": 8, "nx": 6, "N": 20, "nz": 9, "n_con": tp.n_con}


def test_checkpoint_rejects_wrong_problem(point_problems, tmp_path):
    tp, _ = point_problems
    runner = FleetRunner(tp, 8, device="cpu", compaction_ratio=0, kick_scale=0.0)
    path = str(tmp_path / "ckpt.npz")
    save_fleet_state(path, runner.init_state(random_fleet_scenario(tp, 8, seed=0, **SAMPLER)))
    load_fleet_state(path, problem=tp, batch_size=8, device="cpu")
    panda = MpcProblem(Setup.from_dict(panda_setup()))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_fleet_state(path, problem=panda, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        load_fleet_state(path, problem=tp, batch_size=16, device="cpu")


def test_resume_from_jax_checkpoint_matches_jax_step(point_problems, tmp_path):
    tp, jp = point_problems
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jscen = jax_scenario(jp, B, seed=0, **SAMPLER)
    runner = JaxRunner(jp, B, mesh=make_mesh(devices=jax.devices()[:1]), **RUNNER_KW)
    sc = runner.shard_scenario(jscen)
    state, _ = runner.step(runner.init_state(sc), sc)
    path = str(tmp_path / "jax.npz")
    jax_save(path, state, extra={"writer": "jax"})
    _, jm = runner.step(state, sc)
    jm = {k: float(v) for k, v in jm._asdict().items()}

    restored, extra = load_fleet_state(path, problem=tp, batch_size=B, device="cpu")
    assert extra == {"writer": "jax"} and int(restored.step) == 1
    ours = FleetRunner(tp, B, device="cpu", **RUNNER_KW)
    scen = interop.scenario_from_numpy(np.asarray(jscen.xinit), np.asarray(jscen.params), device="cpu")
    new, m = ours.step(restored, scen)
    m = {k: float(v) for k, v in m._asdict().items()}
    assert int(new.step) == 2
    assert m["converged_fraction"] == jm["converged_fraction"], (m, jm)
    assert abs(m["mean_goal_distance"] - jm["mean_goal_distance"]) <= 0.02 * jm["mean_goal_distance"]


def test_profiling_helpers_on_cpu(tmp_path):
    calls = []

    def work(n):
        calls.append(n)
        return torch.ones(n).sum()

    out, sec = timed(work, 4, reps=3)
    assert float(out) == 4.0 and len(calls) == 4 and sec >= 0.0
    timer = StepTimer()
    assert timer.summary() == {"count": 0}
    for _ in range(3):
        with timer:
            time.sleep(0.002)
    s = timer.summary()
    assert timer.count == s["count"] == 3
    assert 2.0 <= s["p50_ms"] <= s["p95_ms"] <= s["max_ms"]
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_visualizer_renders_a_file(tmp_path):
    pytest.importorskip("matplotlib")
    from robot_mpcs_tpu_torch.planner.visualizer import Visualizer

    class Sphere:
        def position(self):
            return [1.0, 1.0, 0.0]

        def radius(self):
            return 0.5

    vis = Visualizer()
    vis.add_trace_point([0.0, 0.0])
    vis.add_trace_point([0.5, 0.2])
    out = vis.render(plan_xy=np.array([[0.5, 0.2], [0.8, 0.4]]), goal=[2.0, 2.0], obstacles=[Sphere()],
                     halfplanes=np.array([[1.0, 1.0, 0.0, -3.0], [1.0, 0.0, 0.0, -4.0]]), r_body=0.2,
                     path=[(0.0, 0.0), (2.0, 2.0)], save_to=str(tmp_path / "frame.png"))
    assert os.path.getsize(out) > 0
