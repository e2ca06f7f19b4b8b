"""The comparison that decides ``correct``: the plain float64 model of
``model.py`` judges what the timed path produced, solve by solve.

A solve answers with a plan (the inputs over the horizon and the states they
lead to) and an exit flag; flag 1 claims the plan feasible and stationary.
The reference re-derives from the task's own inputs (start state, goal,
obstacles, limits; never the program's packed parameters) and checks:

* ``plan_gap``: every plan is a trajectory of the plant from the state the
  solve was given (the relative gap of each stage's state to the float64
  integration of the stage before), and the fleet's new plant state is the
  integration of the applied input;
* ``viol_converged``: the largest constraint violation of a flag-1 plan;
* ``kkt_median`` and ``kkt_converged``: the stationarity of a sample of
  flag-1 plans, their median and their largest: the largest entry of the
  gradient of the cost along the inputs (through the plant) that no
  non-negative combination of the near-active constraints' gradients
  explains, ``min_{lam >= 0} |g - J_a' lam|_inf`` (non-negative least
  squares), over ``max(1, |g|_inf)``;
* ``goal_dist_gap`` (fleet): the fleet's best goal distance against the
  float64 distance of the new plant state;
* ``solves_per_converged``: the window's solves over those that came
  back with flag 1 (the planner's from every solve's flag, the fleet's from
  its converged count, itself checked against the flags; infinite where
  none did), so that a solver cut short to run faster does not pass;
* ``exact_mismatch``: rules that hold exactly, counted: the reset lanes'
  fresh state, the stall counter, the step counter, the converged count
  against the exit flags, the no-improvement counter and the kick, the
  warm start's shift (its last stage repeated), the action against the
  plan's first input.

The fleet's plan of a step is read from its outputs: the new warm start is
the plan shifted by one stage, and the applied input is read off the new
plant state (``Robot.action_from_step``). A lane whose warm start was reset
cold, or that may have been kicked, has no plan to read; its plant
integration is still checked.

Printed, not compared: ``at_goal``, the share of tasks whose robot is
within ``GOAL_TOL`` of its goal when the task ends (the fleet's lanes that
reset at the step after a compared one; the planner's last solve of each
task).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mpcbench import sampler
from mpcbench.drivers.fleet import reset_lanes

F64 = torch.float64
#: the goal tolerance of ``at_goal`` (m): the panda planner's own criterion
GOAL_TOL = 0.05


def _rel_gap(a, b):
    return (torch.abs(a - b).amax(-1) / (1.0 + torch.abs(b).amax(-1)))


def rollout_gaps(robot, X, U):
    """Per plan, the largest relative gap of stage k+1's state to the plant
    from stage k: X (L, N, nx), U (L, N, nu)."""
    if X.shape[0] == 0:
        return X.new_zeros(0)
    nxt = robot.step(X[:, :-1], U[:, :-1])
    return _rel_gap(nxt, X[:, 1:]).amax(-1)


def violations(robot, X, U, task):
    if X.shape[0] == 0:
        return X.new_zeros(0)
    R, live = robot.rows(X, U, task)
    return torch.where(live, torch.clamp(-R, min=0.0), 0.0).flatten(1).amax(-1)


#: the near-active thresholds whose residuals are printed beside the one compared
KKT_PROBES = (0.01, 0.03, 0.1, 0.3)


def kkt_residuals(robot, x0, U, task, act_eps: float):
    """Relative stationarity residual of each plan (see the module's text),
    and the largest at each of ``KKT_PROBES``' thresholds."""
    from scipy.optimize import nnls
    from torch.func import jacfwd, jacrev, vmap

    if x0.shape[0] == 0:
        return np.zeros(0), {}
    N, nu = robot.N, robot.nu

    def cost(u, x, tk):
        X = robot.rollout(x, u)
        return robot.stage_cost(X[None], u[None], {k: v[None] for k, v in tk.items()})[0].sum()

    def rows(u, x, tk):
        X = robot.rollout(x, u)
        return robot.rows(X[None], u[None], {k: v[None] for k, v in tk.items()})[0][0]

    g = vmap(jacrev(cost))(U, x0, task)  # (L, N, nu)
    J = vmap(jacfwd(rows))(U, x0, task)  # (L, N, R, N, nu)
    X = robot.rollout(x0, U)
    R, live = robot.rows(X, U, task)
    active = (R <= act_eps) & live
    out = []
    gn = g.reshape(g.shape[0], -1).cpu().numpy()
    Jn = J.reshape(J.shape[0], -1, N * nu).cpu().numpy()
    act = active.reshape(active.shape[0], -1).cpu().numpy()
    Rn = R.reshape(R.shape[0], -1).cpu().numpy()
    liven = np.broadcast_to(live.reshape(1, -1).cpu().numpy(), Rn.shape)

    def residual(b, A):
        r = b - A @ nnls(A, b, maxiter=50 * max(1, A.shape[1]))[0] if A.shape[1] else b
        return np.abs(r).max() / max(1.0, np.abs(b).max())

    probes = dict.fromkeys(KKT_PROBES, 0.0)
    for i in range(gn.shape[0]):
        out.append(residual(gn[i], Jn[i][act[i]].T))
        for eps in KKT_PROBES:
            a = liven[i] & (Rn[i] <= eps)
            probes[eps] = max(probes[eps], residual(gn[i], Jn[i][a].T))
    return np.asarray(out), probes


def _per_converged(attempted, converged) -> float:
    return attempted / converged if converged >= 0.5 else float("inf")


def _sample(rng, idx: np.ndarray, k: int) -> np.ndarray:
    return idx if len(idx) <= k else np.sort(rng.choice(idx, size=k, replace=False))


def fleet_numbers(robot, cfg, traffic, tasks, task_rows, snaps: Dict[int, Dict], totals: Dict, seed: int,
                  device) -> Dict:
    """The compared numbers of a fleet run from its snapshots (``t`` ->
    the step's input and output state, exit flags, converged fraction) and
    the window's totals."""
    dev = torch.device(device)
    run = traffic["runner"]
    stall_after, kick_after = int(run["stall_reset_after"]), int(run["kick_after"])
    kick_gdist = float(run["kick_gdist"])
    P, nx, nu, N = int(traffic["reset_period"]), robot.nx, robot.nu, robot.N
    act_eps, k_lanes = float(traffic["kkt_active"]), int(traffic["kkt_lanes"])
    worst = {"plan_gap": 0.0, "viol_converged": 0.0, "kkt_converged": 0.0, "kkt_median": 0.0,
             "goal_dist_gap": 0.0, "exact_mismatch": 0,
             "solves_per_converged": _per_converged(totals["attempted"], totals["converged"])}
    kkt_all, at_goal = [], []
    seen = {"plans": 0, "converged": 0, "kkt": 0, "cold": 0, "kick_candidates": 0, "kkt_at": {}}
    for t, s in sorted(snaps.items()):
        inp = {k: v.to(dev) for k, v in s["in"]._asdict().items()}
        out = {k: v.to(dev) for k, v in s["out"]._asdict().items()}
        flags = s["flags"].to(dev)
        B = flags.shape[0]
        rows = task_rows(t)
        tk = sampler.task_tensors(tasks, rows, dev)
        x_t, x_n, z_n = inp["x"].double(), out["x"].double(), out["z_warm"]
        mism = 0
        # reset lanes: a fresh state of the new task (init_state's rows)
        if t > 0:
            lanes = torch.as_tensor(reset_lanes(t, B, P), device=dev)
            x0 = torch.as_tensor(tasks["x0"][rows], device=dev)[lanes]
            cold = torch.zeros_like(inp["z_warm"][lanes])
            cold[:, :, :nx] = x0[:, None]
            mism += int((inp["x"][lanes] != x0).any(-1).sum())
            mism += int((inp["z_warm"][lanes] != cold).flatten(1).any(-1).sum())
            mism += int((inp["lam"][lanes] != 0).flatten(1).any(-1).sum())
            mism += int(((inp["stall"][lanes] != 0) | (inp["no_improve"][lanes] != 0)
                         | ~torch.isinf(inp["best_gdist"][lanes])).sum())
        # the step and stall counters, the converged count
        mism += int(out["step"] != inp["step"] + 1)
        stall = torch.where(flags == 1, 0, inp["stall"] + 1)
        stall = torch.where(stall >= stall_after, 0, stall) if stall_after > 0 else stall
        mism += int((out["stall"] != stall).sum())
        mism += int(abs(int((flags == 1).sum()) - float(s["converged_fraction"]) * B) > 0.5)
        # the goal distance, the no-improvement counter and the kick
        gdist = robot.goal_distance(x_n, tk["goal"])
        ending = torch.as_tensor(reset_lanes(t + 1, B, P), device=dev)
        at_goal.extend((gdist[ending] < GOAL_TOL).tolist())
        best = torch.minimum(inp["best_gdist"].double(), gdist)
        worst["goal_dist_gap"] = max(worst["goal_dist_gap"], float(torch.abs(out["best_gdist"].double() - best).max()))
        improved = out["best_gdist"] < inp["best_gdist"] - 5e-3
        cand = ~improved & (inp["no_improve"] + 1 >= kick_after) if kick_after > 0 else torch.zeros_like(improved)
        kicked = cand & (out["no_improve"] == 0)
        mism += int((~cand & (out["no_improve"] != torch.where(improved, 0, inp["no_improve"] + 1))).sum())
        mism += int((cand & ~kicked & (out["no_improve"] != inp["no_improve"] + 1)).sum())
        mism += int((kicked & (out["lam"] != 0).flatten(1).any(-1)).sum())
        mism += int((kicked & (gdist < kick_gdist - 1e-4)).sum() + (cand & ~kicked & (gdist > kick_gdist + 1e-4)).sum())
        seen["kick_candidates"] += int(cand.sum())
        # the plan: the applied input, then the shifted warm start
        u0 = robot.action_from_step(x_t, x_n)
        worst["plan_gap"] = max(worst["plan_gap"], float(_rel_gap(robot.step(x_t, u0), x_n).max()))
        cold_n = (z_n[..., :nx] == out["x"][:, None]).flatten(1).all(-1) & (z_n[..., nx:] == 0).flatten(1).all(-1)
        warm = ~cold_n & ~kicked
        seen["cold"] += int(cold_n.sum())
        mism += int((warm & ((z_n[:, -1] != z_n[:, -2]).any(-1) | (out["lam"][:, -1] != out["lam"][:, -2]).any(-1))).sum())
        idx = torch.nonzero(warm).flatten()
        X = torch.cat([x_t[idx, None], z_n[idx, : N - 1, :nx].double()], 1)
        U = torch.cat([u0[idx, None], z_n[idx, : N - 1, nx + (z_n.shape[-1] - nx - nu):].double()], 1)
        tki = {k: v[idx] for k, v in tk.items()}
        if len(idx):
            worst["plan_gap"] = max(worst["plan_gap"], float(rollout_gaps(robot, X, U).max()))
        conv = (flags[idx] == 1)
        seen["plans"] += len(idx)
        seen["converged"] += int(conv.sum())
        if conv.any():
            v = violations(robot, X[conv], U[conv], {k: v[conv] for k, v in tki.items()})
            worst["viol_converged"] = max(worst["viol_converged"], float(v.max()))
            rng = np.random.default_rng([seed, 2, t])
            pick = _sample(rng, torch.nonzero(conv).flatten().cpu().numpy(), k_lanes)
            pk = torch.as_tensor(pick, device=dev)
            r, probes = kkt_residuals(robot, X[pk, 0], U[pk], {k: v[pk] for k, v in tki.items()}, act_eps)
            for eps, v in probes.items():
                seen["kkt_at"][str(eps)] = max(seen["kkt_at"].get(str(eps), 0.0), v)
            seen["kkt"] += len(r)
            kkt_all.extend(r.tolist())
            worst["kkt_converged"] = max(worst["kkt_converged"], float(r.max()) if len(r) else 0.0)
        worst["exact_mismatch"] += mism
    worst["kkt_median"] = float(np.median(kkt_all)) if kkt_all else 0.0
    seen["at_goal"] = [float(np.mean(at_goal)) if at_goal else None, len(at_goal)]
    return {"numbers": worst, "seen": seen}


def planner_numbers(robot, cfg, traffic, tasks, records: List[Dict], seed: int, device) -> Dict:
    """The compared numbers of a planner run from its solves' records (the
    state given, the returned plan, action and exit flag, the task)."""
    dev = torch.device(device)
    nx, nu = robot.nx, robot.nu
    act_eps, k_solves = float(traffic["kkt_active"]), int(traffic["kkt_solves"])
    P = int(traffic["reset_period"])
    recs = [r for r in records if r["z"] is not None and r["flag"] >= 0]
    worst = {"plan_gap": 0.0, "viol_converged": 0.0, "kkt_converged": 0.0, "kkt_median": 0.0,
             "exact_mismatch": 0,
             "solves_per_converged": _per_converged(len(records), sum(r["flag"] == 1 for r in records))}
    seen = {"plans": len(recs), "converged": 0, "kkt": 0}
    ends = [r for r in records if (r["t"] + 1) % P == 0]
    if ends:
        tke = sampler.task_tensors(tasks, np.array([r["task"] for r in ends]), dev)
        xe = torch.as_tensor(np.stack([r["x"] for r in ends]), dtype=F64, device=dev)
        seen["at_goal"] = [float((robot.goal_distance(xe, tke["goal"]) < GOAL_TOL).double().mean()), len(ends)]
    if not recs:
        return {"numbers": worst, "seen": seen}
    Z = torch.as_tensor(np.stack([r["z"] for r in recs]), dtype=F64, device=dev)
    x = torch.as_tensor(np.stack([r["x"] for r in recs]), dtype=F64, device=dev)
    act = np.stack([r["action"] for r in recs])
    flags = np.array([r["flag"] for r in recs])
    tk = sampler.task_tensors(tasks, np.array([r["task"] for r in recs]), dev)
    X, U = Z[..., :nx], Z[..., -nu:]
    worst["plan_gap"] = max(float(_rel_gap(X[:, 0], x).max()), float(rollout_gaps(robot, X, U).max()))
    worst["exact_mismatch"] += int((act != np.stack([r["z"][0, -nu:] for r in recs])).any(-1).sum())
    conv = np.nonzero(flags == 1)[0]
    seen["converged"] = len(conv)
    if len(conv):
        c = torch.as_tensor(conv, device=dev)
        v = violations(robot, X[c], U[c], {k: v[c] for k, v in tk.items()})
        worst["viol_converged"] = float(v.max())
        pick = torch.as_tensor(_sample(np.random.default_rng([seed, 2]), conv, k_solves), device=dev)
        r, probes = kkt_residuals(robot, x[pick], U[pick], {k: v[pick] for k, v in tk.items()}, act_eps)
        seen["kkt"] = len(r)
        seen["kkt_at"] = {str(k): v for k, v in probes.items()}
        worst["kkt_converged"] = float(r.max()) if len(r) else 0.0
        worst["kkt_median"] = float(np.median(r)) if len(r) else 0.0
    return {"numbers": worst, "seen": seen}
