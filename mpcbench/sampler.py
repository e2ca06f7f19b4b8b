"""Tasks drawn from the seed: start state, goal, obstacles and limits.

A frozen, vectorised copy of the port's fleet sampler
(``random_fleet_scenario``, robot_mpcs_tpu_torch/parallel/fleet.py:497-652,
with the boxes of ``CLASS_SPECS``, robot_mpcs_tpu_torch/bench.py:90-125).
It keeps that sampler's distributions and rejection rules (reachable goals,
self-collision clearance at the start, obstacles clear of the start pose and
the goal) but draws every task from its own stream: task ``(i, k)`` is a
function of ``(seed, i, k)`` alone, whatever else is drawn. A fleet's
tasks are a fixed pool dealt to the lanes by the run's seed
(``fleet_tasks``), so that every seed runs the same tasks. Each
rule tries a fixed number of candidates (``candidates``) and keeps the first
that passes, else the last.

The kinematics used for the rejection are the reference's
(``reference/model.py``), in float64 on the CPU.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mpcbench.reference.model import Robot


def _stream(seed: int, lane: int, k: int) -> np.random.Generator:
    # the task id sits in the counter's high words; draws advance the low one
    return np.random.Generator(np.random.Philox(key=int(seed) & (2 ** 64 - 1), counter=[0, 0, lane, k]))


def _first_passing(ok: np.ndarray) -> np.ndarray:
    """Index of the first True candidate per task, else the last: ok (T, C)."""
    C = ok.shape[1]
    return np.where(ok.any(1), np.argmax(ok, 1), C - 1)


def draw_tasks(cfg: Dict, robot: Robot, seed: int, ids: Sequence) -> Dict[str, np.ndarray]:
    """Tasks for ``ids``, a list of (lane, k): float32 arrays with a leading
    task axis: ``x0 (T, nx)``, ``goal (T, 3)``, ``obst (T, n_obst, 4)``,
    ``planes (T, n_obst, 4)``, ``r_body (T,)``, ``q_lim (T, n, 2)``,
    ``u_lim (T, nu, 2)``, ``wgoal (T, 3)``, ``wu (T, nu)``; and
    ``rejected (T,)``, the rules that found no passing candidate."""
    s = cfg["sampler"]
    C, T, n, nx, nu = int(s["candidates"]), len(ids), robot.n, robot.nx, robot.nu
    n_obst = robot.n_obst
    rngs = [_stream(seed, lane, k) for lane, k in ids]
    # one block of uniforms per task, in a fixed order: start, goal, obstacles
    width = C * n + C * n + C * n_obst * 4 + 3
    u = np.stack([r.random(width) for r in rngs])  # (T, width)
    u_start = u[:, : C * n].reshape(T, C, n)
    u_goalq = u[:, C * n: 2 * C * n].reshape(T, C, n)
    u_obst = u[:, 2 * C * n: 2 * C * n + C * n_obst * 4].reshape(T, C, n_obst, 4)
    u_goal = u[:, -3:]
    rejected = np.zeros(T, np.int32)

    def cpu(a):
        return torch.as_tensor(a, dtype=torch.float64)

    lo, hi = s["start_box"]
    x0 = np.zeros((T, nx))
    starts = lo + (hi - lo) * u_start  # (T, C, n)
    if robot.base == "holonomic" and robot.pairs and "SelfCollisionAvoidanceConstraints" in robot.constraints:
        links = sorted({l for p in robot.pairs for l in p})
        P = robot.fk(cpu(starts), links)
        clear = torch.stack([torch.linalg.vector_norm(P[a] - P[b], dim=-1) for a, b in robot.pairs], -1)
        ok = (clear.amin(-1) - 2.0 * s["r_body"] >= 0.05).numpy()
        pick = _first_passing(ok)
        rejected += ~ok.any(1)
        x0[:, :n] = starts[np.arange(T), pick]
    elif robot.base == "holonomic":
        x0[:, :n] = starts[:, 0]
    else:
        x0[:, :3] = starts[:, 0, :3]

    glo, ghi = np.asarray(s["goal_box"][0]), np.asarray(s["goal_box"][1])
    if s["reachable_goals"]:
        qlo = np.full(n, float(s["goal_q_box"][0]))
        qhi = np.full(n, float(s["goal_q_box"][1]))
        off = n - len(robot.arm)
        qlo[off:] = np.maximum(qlo[off:], robot.limits[:, 0])
        qhi[off:] = np.minimum(qhi[off:], robot.limits[:, 1])
        qs = qlo + (qhi - qlo) * u_goalq
        ee = robot.fk(cpu(qs), [robot.end_link])[robot.end_link].numpy()  # (T, C, 3)
        ok = np.all((ee >= glo) & (ee <= ghi), -1)
        pick = _first_passing(ok)
        rejected += ~ok.any(1)
        goal = ee[np.arange(T), pick]
    else:
        goal = glo + (ghi - glo) * u_goal

    obst = np.zeros((T, n_obst, 4))
    if "RadialConstraints" in robot.constraints:
        olo, ohi = np.asarray(s["obstacle_box"][0]), np.asarray(s["obstacle_box"][1])
        rlo, rhi = s["obstacle_radius"]
        pos = olo + (ohi - olo) * u_obst[..., :3]  # (T, C, n_obst, 3)
        rad = rlo + (rhi - rlo) * u_obst[..., 3]  # (T, C, n_obst)
        P = robot.fk(cpu(x0[:, :n]), robot.collision_links)
        links = np.stack([P[l].numpy() for l in robot.collision_links], 1)  # (T, L, 3)
        d_start = np.linalg.norm(links[:, None, :, None, :] - pos[:, :, None, :, :], axis=-1)
        clear = (d_start - rad[:, :, None, :] - s["r_body"]).min(axis=(2, 3))
        d_goal = np.linalg.norm(goal[:, None, None, :] - pos, axis=-1) - rad - s["r_body"]
        ok = (clear >= 0.1) & (d_goal.min(-1) >= 0.1)
        pick = _first_passing(ok)
        rejected += ~ok.any(1)
        obst[..., :3] = pos[np.arange(T), pick]
        obst[..., 3] = rad[np.arange(T), pick]
    planes = np.tile(np.asarray(s.get("inactive_plane", [1.0, 0.0, 0.0, -100.0])), (T, n_obst, 1))

    w = cfg["mpc"]["weights"]
    ql, ul = float(s["joint_limit"]), float(s["u_limit"])
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return {
        "x0": f32(x0), "goal": f32(goal), "obst": f32(obst), "planes": f32(planes),
        "r_body": f32(np.full(T, s["r_body"])),
        "q_lim": f32(np.tile([-ql, ql], (T, n, 1))), "u_lim": f32(np.tile([-ul, ul], (T, nu, 1))),
        "wgoal": f32(np.full((T, 3), float(w["w"]))), "wu": f32(np.full((T, nu), float(w["wu"]))),
        "rejected": rejected,
    }


def task_tensors(tasks: Dict[str, np.ndarray], idx, device) -> Dict[str, torch.Tensor]:
    """The float64 task fields of rows ``idx`` on ``device`` (the reference's
    view of the same float32 numbers)."""
    keys = ("x0", "goal", "obst", "planes", "r_body", "q_lim", "u_lim", "wgoal", "wu")
    return {k: torch.as_tensor(tasks[k][idx], dtype=torch.float64, device=device) for k in keys}


def fleet_tasks(cfg: Dict, robot: Robot, traffic: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The fleet's ``batch`` x ``tasks_per_lane`` tasks, row ``lane * K + k``:
    the traffic's pool (drawn from its fixed ``pool_seed``, lane ``j``'s k-th
    task a function of (pool_seed, j, k)), dealt by ``seed``: lane ``i``
    runs the tasks of lane ``perm[i]``, where ``perm`` shuffles the lanes
    within each phase of the reset schedule (``perm[i] = i mod P``). At
    every step the lanes then hold the same tasks, at the same ages, for
    every seed, only in other places, so the seed does not change the work
    (which tasks converge sets most of it); the same seed deals the same."""
    B, K, P = int(traffic["batch"]), int(traffic["tasks_per_lane"]), int(traffic["reset_period"])
    pool = draw_tasks(cfg, robot, int(traffic["pool_seed"]), [(j, k) for j in range(B) for k in range(K)])
    rng = np.random.default_rng([int(seed), 3])
    perm = np.arange(B)
    for r in range(min(P, B)):
        phase = np.arange(r, B, P)
        perm[phase] = rng.permutation(phase)
    rows = (perm[:, None] * K + np.arange(K)).reshape(-1)
    return {k: v[rows] for k, v in pool.items()}
