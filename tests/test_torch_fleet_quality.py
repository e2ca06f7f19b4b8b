"""Long-horizon panda-fleet quality on the port: the counterpart of
``tests/test_fleet_panda_quality.py`` (slow; not in tier-1).

The same scenario (``pandaMpc.yaml`` with ``wconstr = [0.005, 0, 0, 0]``,
B=64 scenarios from seed 17 with reachable goals and ``r_body`` 0.2, 300
closed-loop steps with the default rescue tier and the warm-start kick)
through the port's ``FleetRunner``, under the same bars: zero resets,
``mean_goal_distance`` < 0.1, converged fraction > 0.95 and at most 2 of 64
lanes more than 0.2 m from their goal, with the arms clear of themselves and
of the obstacle. Behaviour is compared, not trajectories: the kick draws
``jax.random``'s noise (``utils/prng.py``), but over 300 steps the f32
differences of the two solvers decide which lanes plateau and when.

    python -m pytest tests/test_torch_fleet_quality.py -m slow -q                  # CPU
    python -m pytest tests/test_torch_fleet_quality.py -m "slow and gpu" -q --noconftest  # card
"""

import os

import numpy as np
import pytest
import torch

from robot_mpcs_tpu_torch.config import load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario

torch.set_num_threads(4)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                      "config", "pandaMpc.yaml")


@pytest.mark.slow
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_panda_fleet_reaches_goals_long_horizon(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    setup = load_setup(CONFIG)
    # the JAX test's parking weight for the soft repulsion (its comment)
    setup.mpc.weights["wconstr"] = [0.005, 0.0, 0.0, 0.0]
    problem = MpcProblem(setup)
    B, r_body = 64, 0.2
    runner = FleetRunner(problem, batch_size=B, device=device)
    scenario = random_fleet_scenario(
        problem, B, seed=17, r_body=r_body,
        goal_box=((-0.5, -0.5, 0.2), (0.5, 0.5, 0.9)),
        obstacle_box=((-0.8, -0.8, 0.2), (0.8, 0.8, 1.0)),
        reachable_goals=True,
    )
    state, metrics = runner.run(scenario, n_steps=300)
    m = {k: float(v) for k, v in metrics._asdict().items()}
    print(f"{device}: last-step metrics {m}")

    assert m["reset_fraction"] == 0.0
    assert m["mean_goal_distance"] < 0.1, m
    assert m["converged_fraction"] > 0.95, m

    params0 = scenario.params[:, 0].numpy()
    pm = problem.param_map
    g_start, g_k = pm.entries["goal"]
    goals = params0[:, g_start : g_start + g_k]
    q = state.x[:, : problem.dims.n].cpu()
    ee = problem.kin.fk_pos(q, problem.robot.end_link).numpy()
    lane_gdist = np.linalg.norm(ee[:, :g_k] - goals, axis=1)
    n_stuck = int((lane_gdist > 0.2).sum())
    print(f"{device}: lanes > 0.2 m from goal {n_stuck}; worst {np.sort(lane_gdist)[-6:]}")
    assert n_stuck <= 2, f"{n_stuck}/64 lanes stuck > 0.2 m from goal: {np.sort(lane_gdist)[-6:]}"

    # no self-collision anywhere in the final fleet state
    pairs = problem.robot.self_collision_pairs
    assert pairs
    clear = torch.stack([
        torch.linalg.norm(problem.kin.fk_pos(q, a) - problem.kin.fk_pos(q, b), dim=-1)
        for a, b in pairs
    ], -1)
    assert float(clear.min()) > 2 * r_body - 1e-3, f"self-collision clearance {float(clear.min()):.4f}"

    # obstacle safety comes from the hard RadialConstraints
    P = problem.kin.fk_pos_links(q, list(problem.robot.collision_links)).numpy()  # (B, L, 3)
    start, _ = pm.entries["obst"]
    obst = params0[:, start : start + 4]  # one obstacle: (x, y, z, r)
    obstacle_clear = (np.linalg.norm(P - obst[:, None, :3], axis=-1) - obst[:, None, 3] - r_body).min()
    assert obstacle_clear > -1e-3, f"obstacle clearance violated: {obstacle_clear:.4f}"
