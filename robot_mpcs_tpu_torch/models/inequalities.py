"""Inequality constraint components (feasible iff value >= 0), batch-first.

Port of ``robot_mpcs_tpu.models.inequalities``: the same rows, in the same
order, with the same reference-bug fixes:

* ``RadialConstraints.eval_constraint`` passes an undefined variable ``j``
  (reference ``RadialConstraints.py:22``) — here it evaluates the documented
  link x obstacle clearances;
* ``VelLimitConstraints`` declares ``_n_ineq = 2`` but emits 4 rows
  (``VelLimitConstraints.py:8`` vs :19-31) — here ``n_ineq`` is 4;
* the slack add in ``InequalityManager.eval_inequalities`` is a no-op
  (``InequalityManager.py:29-32`` rebinds the loop variable) — here slack is
  genuinely added to every row (the documented intent).
"""

from __future__ import annotations

import torch

from robot_mpcs_tpu_torch.models.components import (
    FkEval,
    InequalityComponent,
    ModelContext,
    empty_rows,
    norm_rows,
    obstacle_distances,
)
from robot_mpcs_tpu_torch.models.params import ParamMap
from robot_mpcs_tpu_torch.utils.geometry import point_to_plane


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``[lo_0, hi_0, lo_1, hi_1, ...]`` along the last axis."""
    return torch.stack([lo, hi], dim=-1).flatten(-2)


class JointLimitConstraints(InequalityComponent):
    """2n rows: ``[q_j - lb_j, ub_j - q_j]`` interleaved per dof
    (reference ``JointLimitConstraints.py:20-31``)."""

    name = "JointLimitConstraints"

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.n_ineq = 2 * self.dims.n

    def register_params(self, pm: ParamMap) -> None:
        pm.register("lower_limits", self.dims.n)
        pm.register("upper_limits", self.dims.n)

    def eval_constraint(self, z, p, pm):
        q, _, _ = self.dims.extract_variables(z)
        return _interleave(q - pm.get(p, "lower_limits"), pm.get(p, "upper_limits") - q)


class VelLimitConstraints(InequalityComponent):
    """4 rows boxing the last two velocity components (diff-drive forward and
    angular velocity; reference ``VelLimitConstraints.py:19-31``)."""

    name = "VelLimitConstraints"

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.n_ineq = 4

    def register_params(self, pm: ParamMap) -> None:
        pm.register("lower_limits_vel", 2)
        pm.register("upper_limits_vel", 2)

    def eval_constraint(self, z, p, pm):
        _, qdot, _ = self.dims.extract_variables(z)
        vel = qdot[..., -2:]
        return _interleave(vel - pm.get(p, "lower_limits_vel"), pm.get(p, "upper_limits_vel") - vel)


class InputLimitConstraints(InequalityComponent):
    """2·nu rows boxing ``u = z[-nu:]`` (reference ``InputLimitConstraints.py:18-29``)."""

    name = "InputLimitConstraints"

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.n_ineq = 2 * self.dims.nu

    def register_params(self, pm: ParamMap) -> None:
        pm.register("lower_limits_u", self.dims.nu)
        pm.register("upper_limits_u", self.dims.nu)

    def eval_constraint(self, z, p, pm):
        u = z[..., -self.dims.nu :]
        return _interleave(u - pm.get(p, "lower_limits_u"), pm.get(p, "upper_limits_u") - u)


class RadialConstraints(InequalityComponent):
    """Sphere-obstacle clearances per (collision link x obstacle slot)
    (reference ``RadialConstraints.py`` + ``mpcBase.py:82-101``)."""

    name = "RadialConstraints"
    q_dependent = True

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.n_ineq = self.dims.n_obst * len(ctx.collision_links)

    def register_params(self, pm: ParamMap) -> None:
        pm.register("r_body", 1)
        pm.register("obst", (self.dims.m_obst + 1) * self.dims.n_obst)

    def fk_links(self):
        return self.ctx.collision_links

    def eval_constraint_q(self, fk: FkEval, p, pm):
        return obstacle_distances(self.ctx, fk, p, pm)


class LinearConstraints(InequalityComponent):
    """Halfplane clearances: ``point_to_plane(fk(q, link), plane) - r_body``
    per (collision link x plane slot) (reference ``LinearConstraints.py:25-40``).
    Plane slots are per-stage parameters ``lin_constrs_<i>`` = [a, b, c, d]."""

    name = "LinearConstraints"
    q_dependent = True

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.n_ineq = self.dims.n_obst * len(ctx.collision_links)

    def register_params(self, pm: ParamMap) -> None:
        pm.register("r_body", 1)
        for i in range(self.dims.n_obst):
            pm.register(f"lin_constrs_{i}", 4)

    def fk_links(self):
        return self.ctx.collision_links

    def eval_constraint_q(self, fk: FkEval, p, pm):
        P, J = fk.links(self.ctx.collision_links)  # (..., L, 3), (..., L, 3, n)
        r_body = pm.get(p, "r_body")[..., 0]
        planes = torch.stack(
            [pm.get(p, f"lin_constrs_{i}") for i in range(self.dims.n_obst)], -2
        )[..., None, :, :]  # (..., 1, n_obst, 4)
        point = P[..., :, None, :]  # (..., L, 1, 3)
        val = (point_to_plane(point, planes) - r_body[..., None, None]).flatten(-2)
        if J is None:
            return val, None
        # d|n.p + d| / |n| = sign(n.p + d) n^T J / |n|  (sign +1 at 0, as
        # JAX's abs derivative)
        normal = planes[..., :3]
        signed = torch.sum(normal * point, dim=-1) + planes[..., 3]
        den = torch.sqrt(torch.sum(normal * normal, dim=-1) + 1e-12)
        sgn = torch.where(signed >= 0, 1.0, -1.0)
        jac = ((sgn / den)[..., None] * normal).unsqueeze(-2) @ J[..., :, None, :, :]
        return val, jac.squeeze(-2).flatten(-3, -2)


class SelfCollisionAvoidanceConstraints(InequalityComponent):
    """One row per configured link pair: ``||fk(l1) - fk(l2)|| - 2 r_body``
    (reference ``SelfCollisionAvoidanceConstraints.py:18-27``)."""

    name = "SelfCollisionAvoidanceConstraints"
    q_dependent = True

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.pairs = ctx.self_collision_pairs
        self.n_ineq = len(self.pairs)

    def register_params(self, pm: ParamMap) -> None:
        pm.register("r_body", 1)

    def fk_links(self):
        return [l for pair in self.pairs for l in pair]

    def eval_constraint_q(self, fk: FkEval, p, pm):
        if not self.pairs:
            return empty_rows(fk)
        r_body = pm.get(p, "r_body")[..., 0]
        vals, jacs = [], []
        for l1, l2 in self.pairs:
            Jd = None if not fk.has_jac else fk.jac(l1) - fk.jac(l2)
            dist, Jdist = norm_rows(fk.pos(l1) - fk.pos(l2), Jd)
            vals.append(dist - 2.0 * r_body)
            jacs.append(Jdist)
        return (
            torch.stack(vals, -1),
            torch.stack(jacs, -2) if fk.has_jac else None,
        )


INEQUALITY_REGISTRY = {
    cls.name: cls
    for cls in (
        JointLimitConstraints,
        VelLimitConstraints,
        InputLimitConstraints,
        RadialConstraints,
        LinearConstraints,
        SelfCollisionAvoidanceConstraints,
    )
}
