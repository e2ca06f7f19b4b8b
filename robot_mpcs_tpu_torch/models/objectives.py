"""Objective (stage cost) components, batch-first.

Port of ``robot_mpcs_tpu.models.objectives``. Each component exposes its cost
in structured form (diagonal-weighted residuals and/or inverse barriers, see
``ObjectiveComponent``) so the solver can assemble Gauss-Newton Hessians from
a single Jacobian pass. The total stage cost assembled in ``problem.py`` is

    sum(objective modules) + u' diag(wu) u + ws * s^2

matching ``ObjectiveManager.eval_objectives`` (reference
``ObjectiveManager.py:28-42``); the terminal cost equals the stage cost
(``eval_objectiveN``, :44-46).
"""

from __future__ import annotations

import torch

from robot_mpcs_tpu_torch.models.components import (
    BARRIER_EPS,
    FkEval,
    ModelContext,
    ObjectiveComponent,
    cat_rows,
    obstacle_distances,
    safe_barrier,
)
from robot_mpcs_tpu_torch.models.params import ParamMap


class GoalReaching(ObjectiveComponent):
    """``(fk_ee(q) - goal)' diag(wgoal) (fk_ee(q) - goal)``
    (reference ``goal_reaching.py:19-33``)."""

    name = "GoalReaching"

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        self.n_res = self.n_res_q = self.dims.m

    def register_params(self, pm: ParamMap) -> None:
        pm.register("goal", self.dims.m)
        pm.register("wgoal", self.dims.m)

    def fk_links(self):
        return [self.ctx.robot.end_link]

    def residuals_q(self, fk: FkEval, p, pm):
        m = self.dims.m
        end = self.ctx.robot.end_link
        J = fk.jac(end)
        return fk.pos(end)[..., :m] - pm.get(p, "goal"), None if J is None else J[..., :m, :]

    def weights(self, p, pm):
        e = p.new_zeros(p.shape[:-1] + (0,))
        return pm.get(p, "wgoal"), e, e, e


class ConstraintAvoidance(ObjectiveComponent):
    """Soft inverse-clearance repulsion from constraint boundaries.

    Reference ``constraint_avoidance.py:22-31`` adds, for each constraint
    module i, ``w_i / c_i0`` (only the module's FIRST inequality row) once per
    horizon stage index — i.e. the term is scaled by N inside a single stage
    cost. We reproduce that weighting (``N * w_i / c_i0``) so reference
    configs tune identically, and guard the reciprocal's pole.
    """

    name = "ConstraintAvoidance"

    def __init__(self, ctx: ModelContext, ineq_modules=()):
        super().__init__(ctx)
        self.ineq_modules = [m for m in ineq_modules if m.n_ineq > 0]
        # family split follows the module whose first row is penalized; the
        # q-family rows come first in the canonical [q; affine] row order
        self._mods_q = [(i, m) for i, m in enumerate(self.ineq_modules) if m.q_dependent]
        self._mods_aff = [(i, m) for i, m in enumerate(self.ineq_modules) if not m.q_dependent]
        self.n_bar = len(self.ineq_modules)
        self.n_bar_q = len(self._mods_q)
        self.n_bar_aff = len(self._mods_aff)

    def register_params(self, pm: ParamMap) -> None:
        pm.register("wconstr", len(self.ctx.mpc.constraints))

    def fk_links(self):
        return [l for _, m in self._mods_q for l in m.fk_links()]

    # RAW first rows — the barrier clamp (components.BARRIER_EPS) is applied
    # by the consumer so affine rows keep a constant Jacobian
    def barriers_q(self, fk: FkEval, p, pm):
        rows = []
        for _, m in self._mods_q:
            val, jac = m.eval_constraint_q(fk, p, pm)
            rows.append((val[..., :1], None if jac is None else jac[..., :1, :]))
        return cat_rows(rows, fk)

    def barriers_aff(self, z, p, pm):
        rows = [m.eval_constraint(z, p, pm)[..., :1] for _, m in self._mods_aff]
        return torch.cat(rows, -1) if rows else z.new_zeros(z.shape[:-1] + (0,))

    def weights(self, p, pm):
        w = pm.get(p, "wconstr")
        N = self.dims.N

        def stack(mods):
            if not mods:
                return p.new_zeros(p.shape[:-1] + (0,))
            return torch.stack([N * w[..., i] for i, _ in mods], -1)

        e = p.new_zeros(p.shape[:-1] + (0,))
        return e, stack(self._mods_q), e, stack(self._mods_aff)


class GoalMpcObjective(ObjectiveComponent):
    """Legacy monolithic objective (reference ``goal_mpc_objective.py:26-61``):
    goal tracking + velocity damping + inverse-square obstacle repulsion.

    The reference version references an unregistered ``wobst`` parameter
    (``goal_mpc_objective.py:51``) — here it is registered properly. The
    control-penalty term of the reference variant is provided by the shared
    assembly (wu), not duplicated here.
    """

    name = "GoalMpcObjective"

    def __init__(self, ctx: ModelContext):
        super().__init__(ctx)
        dims = self.dims
        self._n_obst_rows = dims.n_obst * len(ctx.collision_links)
        self.n_res = dims.m + (dims.nx - dims.n) + self._n_obst_rows
        self.n_res_q = dims.m + self._n_obst_rows
        self.n_res_aff = dims.nx - dims.n

    def register_params(self, pm: ParamMap) -> None:
        pm.register("wvel", self.dims.nx - self.dims.n)
        pm.register("w", self.dims.m)
        if self.dims.ns > 0:
            pm.register("ws", 1)
        pm.register("g", self.dims.m)
        pm.register("wobst", 1)

    def fk_links(self):
        return [self.ctx.robot.end_link] + self.ctx.collision_links

    def residuals_q(self, fk: FkEval, p, pm):
        m = self.dims.m
        end = self.ctx.robot.end_link
        J_ee = fk.jac(end)
        goal = (fk.pos(end)[..., :m] - pm.get(p, "g"), None if J_ee is None else J_ee[..., :m, :])
        if "obst" in pm:
            # inverse-square repulsion: residual 1/max(d, eps) with weight wobst
            d, Jd = obstacle_distances(self.ctx, fk, p, pm)
            inv = 1.0 / safe_barrier(d)
            J_inv = None
            if Jd is not None:
                # the clamp has zero slope inside the barrier plateau
                live = d > BARRIER_EPS
                J_inv = torch.where(live[..., None], -(inv * inv)[..., None] * Jd, 0.0)
        else:
            inv = p.new_zeros(p.shape[:-1] + (self._n_obst_rows,))
            J_inv = None if not fk.has_jac else p.new_zeros(inv.shape + (fk.n,))
        return cat_rows([goal, (inv, J_inv)], fk)

    def residuals_aff(self, z, p, pm):
        return z[..., self.dims.n : self.dims.nx]

    def weights(self, p, pm):
        wobst = pm.get(p, "wobst").expand(p.shape[:-1] + (self._n_obst_rows,))
        e = p.new_zeros(p.shape[:-1] + (0,))
        return torch.cat([pm.get(p, "w"), wobst], -1), e, pm.get(p, "wvel"), e


OBJECTIVE_REGISTRY = {
    cls.name: cls for cls in (GoalReaching, ConstraintAvoidance, GoalMpcObjective)
}
