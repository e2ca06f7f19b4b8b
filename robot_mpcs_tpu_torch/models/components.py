"""Base machinery for cost/constraint components, batch-first.

Port of ``robot_mpcs_tpu.models.components``. Components are functions over
``(z, p)`` with any leading batch dimensions (the solver passes
``(B, N, ·)``), registered in explicit registries (``inequalities.py`` /
``objectives.py``).

Rows that reach ``z`` only through the configuration ``q`` (forward
kinematics) read a shared ``FkEval``: the positions — and, for the solver's
Gauss-Newton expansion, the analytic geometric Jacobians — of every link the
stage needs, from one chain walk. Each such row returns ``(value, d value /
dq)``; the Jacobian is assembled by the chain rule from the FK Jacobian and
is ``None`` when the ``FkEval`` was built without one. (The JAX package gets
the same Jacobian from a ``custom_jvp`` on its FK primitive and lets XLA
deduplicate the repeated FK calls; eager PyTorch evaluates FK once instead.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from robot_mpcs_tpu_torch.config import MpcConfiguration, RobotConfiguration
from robot_mpcs_tpu_torch.models.dimensions import ProblemDimensions
from robot_mpcs_tpu_torch.models.fk import RobotKinematics
from robot_mpcs_tpu_torch.models.params import ParamMap

#: Barrier clamp: inverse-clearance barrier terms ``w / b`` are evaluated as
#: ``w / max(b, BARRIER_EPS)``. The reference's raw ``1/c`` becomes *negative*
#: on infeasible iterates (c < 0), rewarding the minimizer for diving through
#: obstacles — its interior-point solver never visits that region, but an AL
#: method does during intermediate iterations. The clamp caps the repulsion at
#: a large positive plateau (zero gradient inside violation; the hard AL
#: constraint supplies the restoring force) while matching the reference
#: exactly on the feasible set where b >= eps. Components emit RAW rows;
#: the clamp is applied by the consumer (the solver) so that
#: affine barrier rows keep a constant Jacobian.
BARRIER_EPS = 1e-3

#: A row block with its Jacobian: ``(value (..., k), d value / dq (..., k, n))``,
#: the Jacobian ``None`` when not requested.
Rows = Tuple[torch.Tensor, Optional[torch.Tensor]]


def safe_barrier(b: torch.Tensor, eps: float = BARRIER_EPS) -> torch.Tensor:
    """Clamp a barrier denominator to be strictly positive."""
    return torch.clamp(b, min=eps)


class FkEval:
    """Positions (and optionally geometric Jacobians) of a set of links at
    one batch of configurations ``q (..., n)``, from a single FK walk."""

    def __init__(self, kin: RobotKinematics, q: torch.Tensor, links: Sequence[str], jac: bool):
        links = list(dict.fromkeys(links))
        self.q = q
        self.n = kin.n
        self._index = {l: i for i, l in enumerate(links)}
        if not links:
            self.P, self.J = None, None
        elif jac:
            self.P, self.J = kin.fk_pos_links_with_jac(q, links)
        else:
            self.P, self.J = kin.fk_pos_links(q, links), None
        self.has_jac = jac

    def pos(self, link: str) -> torch.Tensor:
        return self.P[..., self._index[link], :]

    def jac(self, link: str) -> Optional[torch.Tensor]:
        return None if self.J is None else self.J[..., self._index[link], :, :]

    def links(self, links: Sequence[str]) -> Rows:
        """Stacked ``(P (..., L, 3), J (..., L, 3, n) | None)`` for ``links``."""
        P = torch.stack([self.pos(l) for l in links], -2)
        J = None if self.J is None else torch.stack([self.jac(l) for l in links], -3)
        return P, J


def empty_rows(fk: FkEval) -> Rows:
    """A zero-row block shaped like ``fk``'s batch."""
    q = fk.q
    val = q.new_zeros(q.shape[:-1] + (0,))
    return val, (q.new_zeros(q.shape[:-1] + (0, fk.n)) if fk.has_jac else None)


def cat_rows(blocks: Sequence[Rows], fk: FkEval) -> Rows:
    """Concatenate row blocks (and their Jacobians) along the row axis."""
    if not blocks:
        return empty_rows(fk)
    val = torch.cat([b[0] for b in blocks], -1)
    jac = torch.cat([b[1] for b in blocks], -2) if fk.has_jac else None
    return val, jac


def norm_rows(d: torch.Tensor, Jd: Optional[torch.Tensor]) -> Rows:
    """``sqrt(|d|^2 + 1e-12)`` over the last axis of ``d (..., 3)`` and its
    Jacobian from ``Jd (..., 3, n)``."""
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    if Jd is None:
        return dist, None
    return dist, ((d / dist[..., None]).unsqueeze(-2) @ Jd).squeeze(-2)


@dataclass
class ModelContext:
    """Static context shared by all components of one problem."""

    dims: ProblemDimensions
    kin: RobotKinematics
    mpc: MpcConfiguration
    robot: RobotConfiguration

    @property
    def collision_links(self) -> List[str]:
        return list(self.robot.collision_links)

    @property
    def self_collision_pairs(self) -> List[List[str]]:
        return self.robot.self_collision_pairs


class StageComponent:
    """A cost or constraint term evaluated per stage on ``(z, p)``.

    Subclasses declare parameters in ``register_params`` (run once, in config
    order — this fixes the paramMap ABI) and implement ``eval_*``.
    """

    name: str = "component"

    def __init__(self, ctx: ModelContext):
        self.ctx = ctx
        self.dims = ctx.dims

    def register_params(self, pm: ParamMap) -> None:  # pragma: no cover
        raise NotImplementedError

    def fk_links(self) -> List[str]:
        """Links whose FK the q-family rows of this component read."""
        return []


class InequalityComponent(StageComponent):
    #: number of inequality rows this component contributes per stage
    n_ineq: int = 0
    #: True iff the rows depend on z only through the configuration q
    #: (i.e. through forward kinematics). Such rows carry analytic
    #: q-Jacobians in the solver's Gauss-Newton expansion; all other
    #: (affine) rows get constant build-time Jacobians. See
    #: ``MpcProblem.split_callbacks``.
    q_dependent: bool = False

    def eval_constraint(self, z: torch.Tensor, p: torch.Tensor, pm: ParamMap) -> torch.Tensor:
        """Return ``(..., n_ineq)`` values, feasible iff >= 0 (affine rows)."""
        raise NotImplementedError

    def eval_constraint_q(self, fk: FkEval, p: torch.Tensor, pm: ParamMap) -> Rows:
        """q-only view of ``eval_constraint`` (defined iff ``q_dependent``)."""
        raise NotImplementedError


class ObjectiveComponent(StageComponent):
    """Objective terms in *structured* form, so the solver can build
    Gauss-Newton (PSD-by-construction) Hessians from one Jacobian pass:

    * residual rows ``r`` with weights ``w``: contribute ``sum(w * r^2)``;
    * barrier rows ``b`` with weights ``w``: contribute ``sum(w / b)``.

    Each family is split into q-dependent rows (``*_q``, read through
    ``FkEval``, with q-Jacobians) and affine rows (``*_aff``, constant
    Jacobian). Weights depend on ``p`` only (``weights``).
    """

    #: number of residual rows / barrier rows this component contributes
    n_res: int = 0
    n_bar: int = 0
    #: family split of the rows. Invariant: n_res == n_res_q + n_res_aff,
    #: n_bar == n_bar_q + n_bar_aff.
    n_res_q: int = 0
    n_res_aff: int = 0
    n_bar_q: int = 0
    n_bar_aff: int = 0

    def residuals_q(self, fk: FkEval, p, pm) -> Rows:
        return empty_rows(fk)

    def residuals_aff(self, z, p, pm) -> torch.Tensor:
        return z.new_zeros(z.shape[:-1] + (0,))

    def barriers_q(self, fk: FkEval, p, pm) -> Rows:
        return empty_rows(fk)

    def barriers_aff(self, z, p, pm) -> torch.Tensor:
        return z.new_zeros(z.shape[:-1] + (0,))

    def weights(self, p, pm):
        """``(w_res_q, w_bar_q, w_res_aff, w_bar_aff)``, each ``(..., k)``."""
        e = p.new_zeros(p.shape[:-1] + (0,))
        return e, e, e, e


def obstacle_distances(
    ctx: ModelContext, fk: FkEval, p: torch.Tensor, pm: ParamMap
) -> Rows:
    """Signed clearances between collision links and sphere obstacles.

    Reference ``mpcBase.py:82-101`` (``eval_obstacleDistances``): for each
    collision link (outer) and obstacle slot (inner),
    ``||fk(q, link) - obst_pos|| - obst_radius - r_body``. Obstacle slots
    hold ``[x, y, z, radius]``; empty slots use the -100 sentinel padding
    which makes the clearance large and inactive. Returns
    ``(..., n_links * n_obst)`` in link-major order.
    """
    dims = ctx.dims
    obst = pm.get(p, "obst").reshape(p.shape[:-1] + (dims.n_obst, dims.m_obst + 1))
    r_body = pm.get(p, "r_body")[..., 0]
    P, J = fk.links(ctx.collision_links)  # (..., L, 3), (..., L, 3, n)
    diff = P[..., :, None, :] - obst[..., None, :, : dims.m_obst]  # (..., L, n_obst, 3)
    dist, Jdist = norm_rows(diff, None if J is None else J[..., :, None, :, :])
    clearance = dist - obst[..., None, :, dims.m_obst] - r_body[..., None, None]
    flat = p.shape[:-1] + (-1,)
    return (
        clearance.reshape(flat),
        None if Jdist is None else Jdist.reshape(p.shape[:-1] + (-1, fk.n)),
    )
