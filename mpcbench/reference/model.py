"""Plain float64 model of one configuration: kinematics, plant, constraint
rows and stage cost, batch-first, in plain PyTorch.

It reads only the configuration's file (``mpcbench/configs/<name>.json``):
its joint table, its ``mpc`` section and its plant. It imports nothing of the
program under test. The formulas follow the reference framework
(maxspahn/robot_mpcs) as the program states them; the lines each one was
frozen from are named beside it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

F64 = torch.float64
#: the barrier denominator's clamp (robot_mpcs_tpu_torch/models/components.py:45)
BARRIER_EPS = 1e-3
#: the default variable box (robot_mpcs_tpu_torch/models/problem.py:98-102,
#: reference mpcModel.py:23-27): every state and input within +-100
VAR_BOX = 100.0


def rpy_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw, R = Rz(y) Ry(p) Rx(r)
    (robot_mpcs_tpu_torch/models/urdf.py:49-58)."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = math.cos(r), math.sin(r), math.cos(p), math.sin(p), math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


class Robot:
    """One configuration's model in float64 on ``device``.

    Layout (reference mpcBase.py:54-80): holonomic ``x = [q, qdot]``,
    ``u = qddot``; diff-drive ``x = [q(3), qdot(3), v, omega]``,
    ``u = [a_v, a_omega]``, ``q = (x, y, theta)``."""

    def __init__(self, cfg: Dict, device="cpu"):
        self.device = torch.device(device)
        mpc, robot, kin = cfg["mpc"], cfg["robot"], cfg["kinematics"]
        self.base = kin["base_type"]
        self.N = int(mpc["time_horizon"])
        self.dt = float(mpc["time_step"])
        self.substeps = int(cfg["plant"]["substeps"])
        if cfg["plant"]["integrator"] != "erk2":
            raise ValueError("the reference integrates ERK2 only")
        self.constraints: List[str] = list(mpc["constraints"])
        self.wconstr = [float(w) for w in mpc["weights"]["wconstr"]]
        self.collision_links = list(robot["collision_links"])
        self.pairs = [tuple(p) for p in (robot["selfCollision"].get("pairs") or [])]
        self.end_link = robot["end_link"]
        self.n_obst = int(mpc["number_obstacles"])
        joints = {j["child"]: j for j in kin["joints"]}
        self._joints = joints
        self.root = kin["root_link"]
        # the actuated joints on the root -> end chain fix q's layout
        chain = self._chain(self.end_link)
        self.arm = [j["name"] for j in chain if j["type"] != "fixed"]
        self.limits = np.array([j.get("limits", [-np.inf, np.inf]) for j in chain if j["type"] != "fixed"])
        off = 3 if self.base == "diffdrive" else 0
        self.n = len(self.arm) + off
        self.nx = 2 * self.n + (2 if self.base == "diffdrive" else 0)
        self.nu = self.n if self.base == "holonomic" else 2 + len(self.arm)
        self._q_index = {name: off + i for i, name in enumerate(self.arm)}
        if self.n != int(mpc["n"]):
            raise ValueError(f"joint table gives n={self.n}, the configuration {mpc['n']}")

    # ------------------------------------------------------------ kinematics

    def _chain(self, link: str) -> List[Dict]:
        out = []
        while link != self.root:
            j = self._joints[link]
            out.append(j)
            link = j["parent"]
        return out[::-1]

    def fk(self, q: torch.Tensor, links: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Positions ``(..., 3)`` of ``links`` at ``q (..., n)`` (the chain
        composed link by link, robot_mpcs_tpu_torch/models/fk.py:181-230)."""
        lead = q.shape[:-1]
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        if self.base == "diffdrive":
            c, s = torch.cos(q[..., 2]), torch.sin(q[..., 2])
            z, o = torch.zeros_like(c), torch.ones_like(c)
            R0 = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                              torch.stack([z, z, o], -1)], -2)
            p0 = torch.stack([q[..., 0], q[..., 1], z], -1)
        else:
            R0 = eye.expand(lead + (3, 3))
            p0 = q.new_zeros(lead + (3,))
        out = {}
        for link in links:
            R, p = R0, p0
            for j in self._chain(link):
                pre_R = torch.as_tensor(rpy_matrix(j["rpy"]), dtype=q.dtype, device=q.device)
                pre_t = torch.as_tensor(j["xyz"], dtype=q.dtype, device=q.device)
                p = p + (R @ pre_t[:, None])[..., 0]
                R = R @ pre_R
                if j["type"] == "revolute":
                    a = np.asarray(j["axis"], float)
                    a = a / np.linalg.norm(a)
                    K = torch.as_tensor([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]],
                                        dtype=q.dtype, device=q.device)
                    qj = q[..., self._q_index[j["name"]], None, None]
                    R = R @ (eye + torch.sin(qj) * K + (1 - torch.cos(qj)) * (K @ K))
                elif j["type"] == "prismatic":
                    a = torch.as_tensor(j["axis"], dtype=q.dtype, device=q.device)
                    p = p + (R @ a[:, None])[..., 0] * q[..., self._q_index[j["name"]], None]
            out[link] = p
        return out

    # ----------------------------------------------------------------- plant

    def f(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Continuous dynamics (reference mpcModel.py:65-69,
        diff_drive_mpc_model.py:24-41)."""
        n = self.n
        if self.base == "holonomic":
            return torch.cat([x[..., n:], u], -1)
        th, v, w = x[..., 2], x[..., 2 * n], x[..., 2 * n + 1]
        base = torch.stack([torch.cos(th) * v, torch.sin(th) * v, w], -1)
        zeros = x.new_zeros(x.shape[:-1] + (3,))
        return torch.cat([base, x[..., n + 3: 2 * n], zeros, u[..., 2:], u[..., :2]], -1)

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One control period: ERK2 (midpoint) over ``substeps`` equal
        sub-intervals (ForcesPro's ERK2 with 5 nodes, mpcModel.py:118-120)."""
        h = self.dt / self.substeps
        for _ in range(self.substeps):
            x = x + h * self.f(x + 0.5 * h * self.f(x, u), u)
        return x

    def rollout(self, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """States ``(..., N, nx)`` of the inputs ``U (..., N, nu)`` from x0."""
        xs = [x0]
        for k in range(self.N - 1):
            xs.append(self.step(xs[-1], U[..., k, :]))
        return torch.stack(xs, -2)

    def action_from_step(self, x: torch.Tensor, x_next: torch.Tensor) -> torch.Tensor:
        """The input that takes ``x`` to ``x_next`` in one period, read off
        the rows the input integrates linearly (qdot, or (v, omega))."""
        n = self.n
        if self.base == "holonomic":
            return (x_next[..., n:] - x[..., n:]) / self.dt
        return (x_next[..., 2 * n:] - x[..., 2 * n:]) / self.dt

    # ------------------------------------------------------------ constraints

    def module_rows(self, X: torch.Tensor, U: torch.Tensor, task: Dict[str, torch.Tensor]):
        """Per module in configuration order: (name, rows (..., N, k), depends
        on the input). Feasible iff every row >= 0 (reference
        inequalities/*.py, as robot_mpcs_tpu_torch/models/inequalities.py)."""
        n = self.n
        q = X[..., :n]
        need = set(self.collision_links) | {l for p in self.pairs for l in p} | {self.end_link}
        P = self.fk(q, sorted(need))
        rb = task["r_body"][..., None, None]  # (..., 1, 1)
        out = []
        for name in self.constraints:
            if name == "RadialConstraints":
                ob = task["obst"][..., None, :, :]  # (..., 1, n_obst, 4)
                rows = [torch.linalg.vector_norm(P[l][..., None, :] - ob[..., :3], dim=-1) - ob[..., 3]
                        - rb for l in self.collision_links]
                out.append((name, torch.cat(rows, -1), False))
            elif name == "LinearConstraints":
                pl = task["planes"][..., None, :, :]  # (..., 1, n_obst, 4)
                nrm = torch.linalg.vector_norm(pl[..., :3], dim=-1)
                rows = [torch.abs(torch.sum(pl[..., :3] * P[l][..., None, :], -1) + pl[..., 3]) / nrm - rb
                        for l in self.collision_links]
                out.append((name, torch.cat(rows, -1), False))
            elif name == "SelfCollisionAvoidanceConstraints":
                if self.pairs:
                    rows = [torch.linalg.vector_norm(P[a] - P[b], dim=-1)[..., None] - 2 * rb
                            for a, b in self.pairs]
                    out.append((name, torch.cat(rows, -1), False))
            elif name == "JointLimitConstraints":
                lo, hi = task["q_lim"][..., None, :, 0], task["q_lim"][..., None, :, 1]
                out.append((name, torch.stack([q - lo, hi - q], -1).flatten(-2), False))
            elif name == "InputLimitConstraints":
                lo, hi = task["u_lim"][..., None, :, 0], task["u_lim"][..., None, :, 1]
                out.append((name, torch.stack([U - lo, hi - U], -1).flatten(-2), True))
            else:
                raise ValueError(f"the reference has no rows for {name}")
        return out, P

    def rows(self, X, U, task):
        """Every constraint row ``(..., N, R)``, the variable box included,
        and the (N, R) mask of live rows: a stage-0 row that does not depend
        on the input is pinned (x0 is data, robot_mpcs_tpu_torch/solver/
        al_ilqr.py:161-188)."""
        mods, _ = self.module_rows(X, U, task)
        cols, live_u = [], []
        for _, r, dep in mods:
            cols.append(r)
            live_u += [dep] * r.shape[-1]
        cols += [X + VAR_BOX, VAR_BOX - X, U + VAR_BOX, VAR_BOX - U]
        live_u += [False] * (2 * self.nx) + [True] * (2 * self.nu)
        R = torch.cat(cols, -1)
        live = torch.ones((self.N, R.shape[-1]), dtype=torch.bool, device=R.device)
        live[0] = torch.as_tensor(live_u, device=R.device)
        return R, live

    def stage_cost(self, X, U, task):
        """Stage costs ``(..., N)``: goal reaching, the constraint-avoidance
        barrier on each module's first row (N * wconstr_i / max(c, 1e-3),
        reference constraint_avoidance.py:22-31) and u' diag(wu) u
        (ObjectiveManager.py:28-42); the terminal cost is the stage cost."""
        mods, P = self.module_rows(X, U, task)
        ee = P[self.end_link]
        cost = torch.sum(task["wgoal"][..., None, :] * (ee - task["goal"][..., None, :]) ** 2, -1)
        for i, (_, r, _) in enumerate(m for m in mods if m[1].shape[-1] > 0):
            w = self.wconstr[i] if i < len(self.wconstr) else 0.0
            if w:
                cost = cost + self.N * w / torch.clamp(r[..., 0], min=BARRIER_EPS)
        return cost + torch.sum(task["wu"][..., None, :] * U * U, -1)

    def goal_distance(self, x: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """End-effector distance to the goal (robot_mpcs_tpu_torch/parallel/
        fleet.py:278-289)."""
        ee = self.fk(x[..., : self.n], [self.end_link])[self.end_link]
        return torch.linalg.vector_norm(ee - goal, dim=-1)
