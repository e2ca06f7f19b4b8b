"""The traffic: the staggered reset schedule, tasks drawn from the seed, and
the end-to-end and per-layer arithmetic on synthetic timings."""

import json
from pathlib import Path

import numpy as np
import pytest

from mpcbench import readers, run, sampler
from mpcbench.drivers.fleet import reset_lanes, task_index
from mpcbench.reference.model import Robot

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "mpcbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("B,P", [(4096, 100), (1024, 100), (64, 10)])
def test_reset_schedule(B, P):
    seen = np.zeros(B, int)
    for t in range(1, P + 1):
        lanes = reset_lanes(t, B, P)
        assert len(lanes) in (B // P, -(-B // P))
        assert np.all((t + lanes) % P == 0)
        seen[lanes] += 1
    assert np.all(seen == 1), "every lane starts one task a period"
    lanes = np.arange(B)
    k0, k1 = task_index(P - 1, lanes, P, 6), task_index(P, lanes, P, 6)
    changed = np.nonzero(k0 != k1)[0]
    assert np.array_equal(changed, reset_lanes(P, B, P))


@pytest.mark.parametrize("name", ["panda", "boxer"])
def test_tasks_follow_the_seed(name):
    cfg = _cfg(name)
    robot = Robot(cfg)
    ids = [(lane, k) for lane in range(6) for k in range(2)]
    a = sampler.draw_tasks(cfg, robot, 2 ** 31 + 11, ids)
    b = sampler.draw_tasks(cfg, robot, 2 ** 31 + 11, ids)
    c = sampler.draw_tasks(cfg, robot, 2 ** 31 + 12, ids)
    # one task is a function of (seed, lane, k) alone, whatever else is drawn
    d = sampler.draw_tasks(cfg, robot, 2 ** 31 + 11, [ids[5]])
    for key in ("x0", "goal", "obst"):
        assert np.array_equal(a[key], b[key])
        assert np.array_equal(a[key][5], d[key][0])
    assert not np.array_equal(a["x0"], c["x0"])
    assert np.all(a["rejected"] == 0)
    if name == "panda":
        lo, hi = np.array(cfg["sampler"]["goal_box"])
        assert np.all((a["goal"] >= lo - 1e-6) & (a["goal"] <= hi + 1e-6))


def test_percentiles_and_rates_over_all_steps():
    steps = list(np.linspace(0.1, 0.2, 101))
    assert readers.percentile_ms(steps, 90) == pytest.approx(190.0)
    assert readers.percentile_ms(steps, 95) == pytest.approx(195.0)
    # one slow step among 200 moves p95 of none, and the tail takes all steps
    tail = [0.1] * 199 + [5.0]
    assert readers.percentile_ms(tail, 95) == pytest.approx(100.0)
    assert readers.percentile_ms([0.1] * 180 + [1.0] * 20, 90) == pytest.approx(1e3 * (0.1 + 0.9 * 0.1))
    totals = {"attempted": 4096 * 10, "converged": 40000.0}
    assert run.end_to_end("converged_solves_per_s", totals, 2.5, 30.0) == pytest.approx(16000.0)
    assert run.end_to_end("setup_s", totals, 2.5, 30.0) == 30.0
    rec = {"totals": {"attempted": 4096 * 10, "converged": 40000.0, "iterations": 4096 * 10 * 8.5},
           "times_s": steps, "batch": 4096, "iteration_flops": 1e5,
           "profile": {"graphed_ms": 200.0, "busy_ms": 180.0, "device_events": 1000,
                       "kernel_ms": {"fk_walk": 2.0, "gn_assemble": 0.0}, "kernel_bound_ms": {"fk_walk": 1.5}}}
    assert readers.iterations_per_solve(rec) == pytest.approx(8.5)
    assert readers.idle_share(rec) == pytest.approx(10.0)
    assert readers.roofline(rec, "fk_walk") == pytest.approx(75.0)
    assert readers.roofline(rec, "gn_assemble") is None, "nothing to read: no number, never 0"
    assert readers.hand_kernel_busy_share(rec) == pytest.approx(100 * 2.0 / 180.0)
    assert readers.step_mfu(rec) == pytest.approx(100 * 4096 * 8.5 * 1e5 / (0.2 * 67e12))
    assert readers.median_ms(steps) == pytest.approx(150.0)
    assert readers.roofline({"profile": None}, "fk_walk") is None


def test_the_tail_reader_takes_every_step():
    """``step_ms_p90`` is the 90th percentile of every step of the window,
    read by its own file as BENCHMARK.json names it."""
    entry = next(m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                 if m["name"] == "step_ms_p90")
    times = list(np.linspace(0.001, 0.1, 100))
    assert run.load_reader(entry).read({"times_s": times}) == pytest.approx(1e3 * np.percentile(times, 90))
    assert run.load_reader(entry).read({"times_s": []}) is None


def test_every_seed_runs_the_same_tasks():
    """The seed deals the fleet's pool to the lanes within each reset phase:
    at every step the same tasks run for every seed, in other lanes."""
    cfg = _cfg("panda")
    robot = Robot(cfg)
    traffic = {"batch": 40, "tasks_per_lane": 3, "reset_period": 10, "pool_seed": 5}
    a = sampler.fleet_tasks(cfg, robot, traffic, 2 ** 31 + 1)
    b = sampler.fleet_tasks(cfg, robot, traffic, 2 ** 31 + 1)
    c = sampler.fleet_tasks(cfg, robot, traffic, 2 ** 31 + 2)
    assert np.array_equal(a["goal"], b["goal"])
    assert not np.array_equal(a["goal"], c["goal"])
    lanes = np.arange(40)
    for t in (0, 7, 10, 23):
        rows = lanes * 3 + task_index(t, lanes, 10, 3)
        assert sorted(map(tuple, a["goal"][rows])) == sorted(map(tuple, c["goal"][rows]))
