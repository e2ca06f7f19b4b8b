"""The port's mixed-robot fleet (``parallel/fleet_group.py``).

Scenario draws must equal the JAX package's (same numpy seeds per class);
grouped stepping must be bit-identical to stepping each class alone on the
CPU (grouping is a scheduling construct, not a numerical one: the port of
``tests/test_fleet_group.py:97-115``); the aggregate must weight each class
by its batch size.
"""

import warnings

import numpy as np
import pytest
import torch

from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.parallel.fleet_group import mixed_fleet_scenarios as jax_mixed
from robot_mpcs_tpu_torch.config import Setup, boxer_setup, panda_setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel import FleetGroup, mixed_fleet_scenarios
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner

torch.set_num_threads(2)

SETUPS = {"pointRobot": point_robot_setup, "panda": panda_setup, "boxer": boxer_setup}
SAMPLERS = {  # tests/test_fleet_group.py:43-56
    "pointRobot": dict(goal_box=((-2, -2, 0.05), (2, 2, 0.05)), obstacle_box=((5, 5, 0.05), (6, 6, 0.05))),
    "panda": dict(goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 1.0)), obstacle_box=((5, 5, 0.2), (6, 6, 1.0))),
    "boxer": dict(goal_box=((-2, -2, 0.0), (2, 2, 0.0)), obstacle_box=((5, 5, 0.0), (6, 6, 0.0))),
}
#: unequal sub-batches, so a plain mean would differ from the weighted one
SIZES = {"pointRobot": 16, "boxer": 32}
RUNNER_KW = dict(compaction_ratio=2)  # a rescue tier at these batch sizes
STEPS = 3


@pytest.fixture(scope="module")
def problems():
    return {k: MpcProblem(Setup.from_dict(make())) for k, make in SETUPS.items()}


@pytest.fixture(scope="module")
def group_run(problems):
    sub = {k: (problems[k], b) for k, b in SIZES.items()}
    scenarios = mixed_fleet_scenarios(sub, seed=3, sampler_kwargs=SAMPLERS)
    group = FleetGroup(sub, device="cpu", **RUNNER_KW)
    states, metrics = group.run(scenarios, n_steps=STEPS)
    return sub, scenarios, states, metrics


def test_mixed_fleet_scenarios_match_jax(problems):
    sub = {k: (p, 8) for k, p in problems.items()}
    jsub = {k: (JaxProblem(JaxSetup.from_dict(make())), 8) for k, make in SETUPS.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = mixed_fleet_scenarios(sub, seed=11, sampler_kwargs=SAMPLERS)
        want = jax_mixed(jsub, seed=11, sampler_kwargs=SAMPLERS)
    assert list(got) == list(want) == list(SETUPS)
    for name in SETUPS:
        np.testing.assert_array_equal(got[name].xinit.numpy(), np.asarray(want[name].xinit))
        np.testing.assert_allclose(got[name].params.numpy(), np.asarray(want[name].params), atol=1e-6)


def test_grouped_steps_equal_isolated_runners(group_run):
    sub, scenarios, g_states, metrics = group_run
    assert set(metrics.per_class) == set(SIZES)
    for name, (problem, batch) in sub.items():
        runner = FleetRunner(problem, batch, device="cpu", **RUNNER_KW)
        s_state, _ = runner.run(scenarios[name], n_steps=STEPS)
        for field, got in g_states[name]._asdict().items():
            assert torch.equal(got, getattr(s_state, field)), (name, field)


def test_aggregate_is_batch_weighted(group_run):
    _, _, _, metrics = group_run
    total = sum(SIZES.values())
    per = {k: {f: float(v) for f, v in m._asdict().items()} for k, m in metrics.per_class.items()}
    overall = {f: float(v) for f, v in metrics.overall._asdict().items()}
    for field in ("converged_fraction", "mean_cost", "mean_goal_distance", "mean_iterations"):
        want = sum(SIZES[k] / total * per[k][field] for k in SIZES)
        assert overall[field] == pytest.approx(want, rel=1e-6), field
    for field in ("max_violation", "max_iterations", "max_violation0_raw"):
        assert overall[field] == max(per[k][field] for k in SIZES), field
    for name, m in per.items():
        assert all(np.isfinite(v) for v in m.values()), (name, m)
        assert m["converged_fraction"] > 0.5, (name, m)
