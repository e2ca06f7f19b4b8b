"""Batched augmented-Lagrangian iLQR, batch-first (port of
``robot_mpcs_tpu.solver.al_ilqr``).

This replaces the ForcesPro-generated interior-point C solver the reference
drives (reference ``robotmpcs/models/mpcModel.py:74-129`` builds the problem,
``robotmpcs/planner/mpcPlanner.py:262`` calls ``solver.solve``):

* **Equality structure (stage dynamics)** is eliminated by a Riccati backward
  sweep over the horizon: the structured holonomic sweep of
  ``ops/riccati_packed.py`` where the dynamics have its block form, else the
  general sweep of ``ops/riccati_batched.py`` (each the CUDA kernel on the
  card, its plain version on the CPU), or with ``riccati_backend="scan"``
  the JAX package's stage scan (``riccati_backward_scan``).
* **Inequalities + variable bounds** are handled by a PHR augmented
  Lagrangian: outer iterations update multipliers and a per-lane penalty;
  the inner iLQR minimizes the AL objective.
* **Gauss-Newton expansion**, three paths as in the JAX package. The fast
  one takes two row families (``MpcProblem.split_callbacks``): FK-dependent
  rows with their analytic q-Jacobian, and affine rows with a constant
  build-time Jacobian ``S_aff``. The JAX package's two hand-written batch
  rules on this path are kernels here: the FK walk of the q rows
  (``ops/fk_walk.py``, ``_walk_scalar``) and the assembly of the Riccati
  blocks from the rows, fused with their per-row coefficients
  (``ops/gn_assemble.py``, ``_gn_assemble_vmap``); on the CPU both run their
  plain batched versions. For custom problems,
  the stacked ``values``/``weights`` form gets its Jacobian from one
  forward-mode pass (``torch.func.jacfwd`` under ``vmap``) over all stages,
  and a ``cost``/``ineq``-only problem the exact gradient and Hessian of its
  AL stage cost with a Gershgorin shift to positive definiteness.
* **Batching and early exit**: every tensor carries the scenario batch
  first. Each JAX ``lax.while_loop`` (inner iLQR, outer AL, line search)
  becomes a Python ``while`` over a per-lane ``active`` mask that ends when
  no lane is active or every lane hit its cap. A lane that is done is frozen
  with ``torch.where`` exactly as JAX's vmapped loop freezes it, so each
  lane's result does not depend on which other lanes share its batch.
* **Compiled on the card** (the counterpart of ``jax.jit`` over
  ``lax.while_loop``): each loop body is a unit over a carry preallocated
  per batch shape (``solver/units.py``). On a CUDA device the whole solve
  is captured once per batch shape as one CUDA graph whose three loops are
  conditional WHILE nodes testing their flags on the device
  (``ops/graph_cond.py``), and each later solve is one replay with no host
  read: every lane's iteration count, every kernel launch and the device
  work are the eager loop's. On the CPU the same units run eagerly and each
  loop reads its flag on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from robot_mpcs_tpu_torch.config import SolverConfiguration
from robot_mpcs_tpu_torch.models.components import BARRIER_EPS
from robot_mpcs_tpu_torch.models.dynamics import dynamics_jacobians
from robot_mpcs_tpu_torch.ops.gn_assemble import GnLayout, gn_assemble, gn_coefs
from robot_mpcs_tpu_torch.ops.linalg_small import chol_solve_unrolled
from robot_mpcs_tpu_torch.ops.riccati_batched import riccati_backward_batched, riccati_sweep
from robot_mpcs_tpu_torch.ops.riccati_packed import (
    detect_structure,
    riccati_backward_packed,
)
from robot_mpcs_tpu_torch.solver.types import SolveResult
from robot_mpcs_tpu_torch.solver.units import UnitProgram
from robot_mpcs_tpu_torch.utils.devices import resolve_device


class StageFunctions(NamedTuple):
    """Per-stage problem callbacks in the (x, w, p) convention, where
    ``w = [s, u]`` stacks slack + controls. Every argument carries leading
    batch dimensions (the solver passes ``(B, N)``; under ``torch.func``
    none), so a callback indexes its last axis only, and the ``cost``,
    ``ineq``, ``values`` and ``weights`` callbacks stay functional (no
    in-place writes, no branches on values) for ``torch.func`` to
    differentiate them.

    ``values``/``weights`` carry the structured (Gauss-Newton) form:
    ``values(x, w, p)`` returns the stacked ``[residuals; barriers;
    constraints]`` rows, ``weights(p)`` returns ``(w_res, w_bar)``; the stage
    cost is ``sum(w_res * r^2) + sum(w_bar / b)`` and feasibility is
    ``c >= 0``. With ``values=None`` the solver takes ``cost``/``ineq``
    with exact Hessians (generic fallback). The split form ``q_rows(q, p,
    jac)`` (FK-dependent rows and their q-Jacobian), ``aff_rows(v, p)``
    (affine rows) and ``weights_split(p)`` (see
    ``MpcProblem.split_callbacks``) is the fastest path and wins when set.
    """

    dynamics: Callable  # F(x, u) -> x_next
    cost: Optional[Callable] = None  # cost(x, w, p) -> (...,) true objective
    ineq: Optional[Callable] = None  # ineq(x, w, p) -> (..., n_con), feasible iff >= 0
    values: Optional[Callable] = None  # (x, w, p) -> (..., n_res + n_bar + n_con)
    weights: Optional[Callable] = None  # p -> (w_res, w_bar)
    #: (A, B) build-time constants, a batched fn(x, u) -> (A, Bu), or None
    #: (differentiate ``dynamics``)
    dyn_jac: Union[None, Tuple, Callable] = None
    q_rows: Optional[Callable] = None
    aff_rows: Optional[Callable] = None
    weights_split: Optional[Callable] = None


def _al_penalty(c: torch.Tensor, lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """PHR penalty for c >= 0: (1/2mu) * (max(0, lam - mu c)^2 - lam^2),
    summed over the last axis; ``mu`` broadcasts against ``c[..., 0]``."""
    active = torch.clamp(lam - mu[..., None] * c, min=0.0)
    return (0.5 / mu) * torch.sum(active * active - lam * lam, dim=-1)


def split_pinned_rows(q_seg, aff_seg, S_aff, nx: int, ns: int) -> np.ndarray:
    """The constraint rows the split form pins at stage 0, ``(n_con,)``
    bools in the split row order: a q-family row reaches z only through
    q ⊆ x (pinned unless a slack column makes it live), an affine row is
    pinned iff its constant Jacobian has no [s, u] column."""
    qr, qb, qc = q_seg
    ar, ab, ac = aff_seg
    S_np = np.asarray(S_aff, np.float32)
    return np.concatenate([
        np.full((qc,), ns == 0),
        np.abs(S_np[ar + ab :, nx:]).sum(axis=1) == 0.0,
    ])


def riccati_backward_scan(lx, lw, lxx, lxw, lww, A, Bm, reg):
    """The JAX package's stage-scan backward sweep (al_ilqr.py:485-535),
    batch-first: ``riccati_sweep`` with the unrolled Cholesky stage solve
    (``ops/linalg_small``, which the JAX package uses for every nw <= 24,
    i.e. every robot model here). Inputs and outputs as
    ``riccati_backward_batched``."""
    return riccati_sweep(lx, lw, lxx, lxw, lww, A, Bm, reg, chol_solve_unrolled)


def build_solver(
    stage: StageFunctions,
    *,
    nx: int,
    ns: int,
    nu: int,
    N: int,
    n_con: int,
    n_res: int = 0,
    n_bar: int = 0,
    w_lb,
    w_ub,
    cfg: Optional[SolverConfiguration] = None,
    n_q: int = 0,
    q_seg: Optional[Tuple[int, int, int]] = None,
    aff_seg: Optional[Tuple[int, int, int]] = None,
    S_aff=None,
    pinned_rows=None,
    device="cuda",
):
    """Build ``solve(xinit, params, z0, lam0) -> SolveResult`` for a batch:
    ``xinit (B, nx)``, ``params (B, N, npar)``, ``z0 (B, N, nx+ns+nu)`` (its
    ``[s, u]`` tail seeds the controls), ``lam0 (B, N, n_con)`` (multiplier
    warm start). Tensors are moved to ``device`` (default: the CUDA card;
    pass ``"cpu"`` for the CPU).

    The expansion path follows ``stage``: the split form when ``q_rows`` is
    set (``q_seg``, ``aff_seg``, ``S_aff`` and ``n_q`` describe it), else the
    stacked ``values`` (``n_res`` residual and ``n_bar`` barrier rows ahead of
    the ``n_con`` constraint rows), else ``cost``/``ineq``.
    ``pinned_rows`` (``(n_con,)`` bools) names the constraint rows masked at
    stage 0; by default the split form derives them, the other forms pin none.
    """
    cfg = cfg or SolverConfiguration()
    dev = resolve_device(device)
    nw = ns + nu
    nv = nx + nw
    fdev = dict(dtype=torch.float32, device=dev)
    split = stage.q_rows is not None
    structured = not split and stage.values is not None
    w_lb = torch.as_tensor(np.broadcast_to(np.asarray(w_lb, np.float32), (nw,)).copy(), **fdev)
    w_ub = torch.as_tensor(np.broadcast_to(np.asarray(w_ub, np.float32), (nw,)).copy(), **fdev)

    # ---------------- pinned stage-0 constraint rows ------------------------
    # x[0] = xinit is DATA, not a decision variable, so a stage-0 constraint
    # row with no dependence on [s, u] is a constant no solver can change;
    # folding it into the AL penalty would only ratchet the penalty to
    # penalty_max. Such rows are masked at stage 0 by an additive offset
    # (al_ilqr.py:406-437 of the JAX package).
    if split:
        qr, qb, qc = q_seg
        ar, ab, ac = aff_seg
        if n_con != qc + ac:
            raise ValueError(f"n_con {n_con} != q_con {qc} + aff_con {ac}")
        S_np = np.asarray(S_aff, np.float32)
    if pinned_rows is not None:
        pinned = np.asarray(pinned_rows, bool)
        if pinned.shape != (n_con,):
            raise ValueError(f"pinned_rows shape {pinned.shape} != ({n_con},)")
    elif split:
        pinned = split_pinned_rows(q_seg, aff_seg, S_aff, nx, ns)
    else:
        pinned = np.zeros((n_con,), bool)
    C_OFF = torch.zeros((N, n_con), **fdev)
    if pinned.any():
        C_OFF[0, torch.as_tensor(np.where(pinned)[0], device=dev)] = 1e6

    # ---------------- dynamics Jacobians (al_ilqr.py:439-464) ---------------
    # Stage N-1 has no outgoing dynamics: its A = B = 0 (al_ilqr.py:696-699).
    # The slack columns of B are zero.

    if isinstance(stage.dyn_jac, tuple):
        A_np = np.asarray(stage.dyn_jac[0], np.float32)
        B_np = np.concatenate(
            [np.zeros((nx, ns), np.float32), np.asarray(stage.dyn_jac[1], np.float32)], 1
        )
        A_const = torch.as_tensor(np.broadcast_to(A_np, (N, nx, nx)).copy(), **fdev)
        B_const = torch.as_tensor(np.broadcast_to(B_np, (N, nx, nw)).copy(), **fdev)
        A_const[-1] = 0.0
        B_const[-1] = 0.0

        def all_dyn_jacobians(X, W):
            """Batch-constant dynamics: ``(A (N, nx, nx), B (N, nx, nw))``."""
            return A_const, B_const

    else:
        jac_fn = stage.dyn_jac or dynamics_jacobians(stage.dynamics)

        def all_dyn_jacobians(X, W):
            """Per-lane ``(A (B, N, nx, nx), B (B, N, nx, nw))``."""
            A, Bu = jac_fn(X[:, :-1], W[:, :-1, ns:])
            Bsz = X.shape[0]
            A = torch.cat([A, A.new_zeros((Bsz, 1, nx, nx))], 1)
            Bu = torch.cat([Bu, Bu.new_zeros((Bsz, 1, nx, nu))], 1)
            return A, torch.cat([Bu.new_zeros((Bsz, N, nx, ns)), Bu], -1)

    # ---------------- backward sweep dispatch (al_ilqr.py:537-634) ----------
    # Unlike the JAX package, a shape of which one lane does not fit the
    # card's shared memory raises on the card instead of falling back to the
    # scan (which the caller can choose with riccati_backend="scan").

    packed = None
    if isinstance(stage.dyn_jac, tuple) and cfg.riccati_backend != "scan":
        packed = detect_structure(A_np, B_np, nx=nx, ns=ns)
    if packed is not None:
        a_s, b1_s, b2_s = packed

        def backward(X, W, lx, lw, lxx, lxw, lww, reg):
            """Structured sweep: the kernel bakes the holonomic (A, B) in, and
            its zero terminal value function is the stage N-1 A = B = 0."""
            return riccati_backward_packed(
                lx, lw, lxx, lxw, lww, reg,
                N=N, nx=nx, nw=nw, ns=ns, a=a_s, b1=b1_s, b2=b2_s,
            )

    else:

        def backward(X, W, lx, lw, lxx, lxw, lww, reg):
            A, Bm = all_dyn_jacobians(X, W)
            if cfg.riccati_backend == "scan":
                return riccati_backward_scan(lx, lw, lxx, lxw, lww, A, Bm, reg)
            return riccati_backward_batched(lx, lw, lxx, lxw, lww, A, Bm, reg, N=N, nx=nx, nw=nw)

    # ---------------- stage-level pieces (leading dims (B, N)) --------------
    # Each path defines true_cost (B, N), stage_ineq (B, N, n_con),
    # al_stage_cost (B, N) and stage_expansion_blocks, the Riccati blocks
    # (lx, lw, lxx, lxw, lww) of the AL model, each contiguous (B, N, ...).

    def blocks(g, H):
        return (
            g[..., :nx].contiguous(),
            g[..., nx:].contiguous(),
            H[..., :nx, :nx].contiguous(),
            H[..., :nx, nx:].contiguous(),
            H[..., nx:, nx:].contiguous(),
        )

    if split:
        gn = GnLayout(q_seg, aff_seg, S_np, nx=nx, ns=ns, n_q=n_q, c_off=C_OFF)

        def eval_families(X, W, P):
            """(vq, va): q-family rows (no Jacobian), affine rows."""
            vq, _ = stage.q_rows(X[..., :n_q], P, False)
            va = stage.aff_rows(torch.cat([X, W], -1), P)
            if ns and qc:
                # slack-shift the q-family module constraint rows (the affine
                # family shifts its own rows inside aff_rows)
                vq = torch.cat([vq[..., : qr + qb], vq[..., qr + qb :] + W[..., :1]], -1)
            return vq, va

        def family_cost(vq, va, P):
            """(true stage cost (B, N), stacked constraint rows [con_q; con_aff])."""
            wrq, wbq, wra, wba = stage.weights_split(P)
            total = torch.sum(wrq * vq[..., :qr] ** 2, -1) + torch.sum(wra * va[..., :ar] ** 2, -1)
            total = total + torch.sum(wbq / torch.clamp(vq[..., qr : qr + qb], min=BARRIER_EPS), -1)
            total = total + torch.sum(wba / torch.clamp(va[..., ar : ar + ab], min=BARRIER_EPS), -1)
            return total, torch.cat([vq[..., qr + qb :], va[..., ar + ab :]], -1)

        def true_cost(X, W, P):
            vq, va = eval_families(X, W, P)
            return family_cost(vq, va, P)[0]

        def stage_ineq(X, W, P):
            vq, va = eval_families(X, W, P)
            return torch.cat([vq[..., qr + qb :], va[..., ar + ab :]], -1)

        def al_stage_cost(X, W, P, lam, mu):
            """AL merit per stage, (B, N); ``mu`` is the per-lane penalty (B,)."""
            vq, va = eval_families(X, W, P)
            cost, c = family_cost(vq, va, P)
            return cost + _al_penalty(c + C_OFF, lam, mu[:, None])

        def stage_expansion_blocks(X, W, P, lam, mu):
            """Riccati blocks (lx, lw, lxx, lxw, lww) of the Gauss-Newton AL
            model at every stage, each contiguous ``(B, N, ...)``: the q rows
            with their Jacobian (the ``fk_walk`` kernel on the card) and the
            affine rows, assembled by ``gn_assemble`` (the kernel on the
            card), which also slack-shifts the q constraint rows."""
            vq, Jq = stage.q_rows(X[..., :n_q], P, True)
            va = stage.aff_rows(torch.cat([X, W], -1), P)
            return gn_assemble(vq, Jq, va, *stage.weights_split(P), lam, mu, W, layout=gn)

    elif structured:

        def split_vals(vals):
            return vals[..., :n_res], vals[..., n_res : n_res + n_bar], vals[..., n_res + n_bar :]

        def cost_from_vals(vals, P):
            r, b, _ = split_vals(vals)
            w_res, w_bar = stage.weights(P)
            total = torch.sum(w_res * r * r, -1)
            if n_bar:
                total = total + torch.sum(w_bar / torch.clamp(b, min=BARRIER_EPS), -1)
            return total

        def true_cost(X, W, P):
            return cost_from_vals(stage.values(X, W, P), P)

        def stage_ineq(X, W, P):
            return split_vals(stage.values(X, W, P))[2]

        def al_stage_cost(X, W, P, lam, mu):
            vals = stage.values(X, W, P)
            c = split_vals(vals)[2] + C_OFF
            return cost_from_vals(vals, P) + _al_penalty(c, lam, mu[:, None])

        def _vals(v, p):
            out = stage.values(v[:nx], v[nx:], p)
            return out, out

        # one forward-mode pass over every (lane, stage): (J, values)
        vals_jac = torch.func.vmap(torch.func.jacfwd(_vals, has_aux=True))

        def stage_expansion_blocks(X, W, P, lam, mu):
            """Gauss-Newton model from the rows' Jacobian (al_ilqr.py:337-372):
            the same per-row coefficients as the split path, one dense J."""
            lead = X.shape[:-1]
            J, vals = vals_jac(torch.cat([X, W], -1).reshape(-1, nv), P.reshape(-1, P.shape[-1]))
            # forward mode may carry a python-scalar term's tangent in f64
            J = J.reshape(lead + J.shape[-2:]).to(torch.float32)
            r, b, c = split_vals(vals.reshape(lead + vals.shape[-1:]))
            w_res, w_bar = stage.weights(P)
            g_row, h_row = gn_coefs(r, w_res, b, w_bar, c + C_OFF, lam, mu[:, None, None])
            g = (g_row.unsqueeze(-2) @ J).squeeze(-2)
            H = (J * h_row[..., None]).transpose(-1, -2) @ J
            return blocks(g, H)

    else:

        def true_cost(X, W, P):
            return stage.cost(X, W, P)

        def stage_ineq(X, W, P):
            return stage.ineq(X, W, P)

        def al_stage_cost(X, W, P, lam, mu):
            c = stage.ineq(X, W, P) + C_OFF
            return stage.cost(X, W, P) + _al_penalty(c, lam, mu[:, None])

        def _al_one(v, p, lam_k, mu_k, off_k):
            """AL cost of one stage, for torch.func (no batch dimensions)."""
            c = stage.ineq(v[:nx], v[nx:], p) + off_k
            return stage.cost(v[:nx], v[nx:], p) + _al_penalty(c, lam_k, mu_k)

        al_grad = torch.func.vmap(torch.func.grad(_al_one))
        al_hess = torch.func.vmap(torch.func.hessian(_al_one))
        eye = torch.eye(nv, **fdev)

        def stage_expansion_blocks(X, W, P, lam, mu):
            """Exact AL gradient and Hessian, symmetrised and shifted to
            positive definiteness by the Gershgorin bound (al_ilqr.py:374-384)."""
            lead = X.shape[:-1]
            M = X[..., 0].numel()
            args = (
                torch.cat([X, W], -1).reshape(M, nv),
                P.reshape(M, P.shape[-1]),
                lam.reshape(M, n_con),
                mu[:, None].expand(lead).reshape(M),
                C_OFF.expand(lead + (n_con,)).reshape(M, n_con),
            )
            g = al_grad(*args).reshape(lead + (nv,))
            H = al_hess(*args).reshape(lead + (nv, nv)).to(torch.float32)
            H = 0.5 * (H + H.transpose(-1, -2))
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            radius = torch.sum(torch.abs(H), -1) - torch.abs(diag)
            shift = torch.clamp(1e-6 - torch.amin(diag - radius, -1), min=0.0)
            return blocks(g, H + shift[..., None, None] * eye)

    def rollout(xinit, W):
        """Open-loop rollout: X[:, 0] = xinit, X[:, k+1] = F(X[:, k], U[:, k])."""
        xs = [xinit]
        for k in range(N - 1):
            xs.append(stage.dynamics(xs[-1], W[:, k, ns:]))
        return torch.stack(xs, 1)

    def forward(xinit, X_ref, W_ref, k_ff, K, P, lam, mu, alpha):
        """Closed-loop rollout with step ``alpha`` (B,); returns (X, W, the
        PER-STAGE merit (B, N)). The line search accepts on the sum of
        per-stage DIFFERENCES, whose f32 noise floor is ~N x lower than
        comparing two accumulated totals (al_ilqr.py:650-658)."""
        x = xinit
        xs, ws = [], []
        for k in range(N):
            dx = (x - X_ref[:, k]).unsqueeze(-1)
            w = W_ref[:, k] + alpha[:, None] * k_ff[:, k] + (K[:, k] @ dx).squeeze(-1)
            w = torch.clamp(w, w_lb, w_ub)
            xs.append(x)
            ws.append(w)
            x = stage.dynamics(x, w[:, ns:])
        X, W = torch.stack(xs, 1), torch.stack(ws, 1)
        return X, W, al_stage_cost(X, W, P, lam, mu)

    def where(mask, new, old):
        """Per-lane select: ``mask`` (B,) broadcast over trailing dims."""
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)

    # ---------------- the loops as units over a carry -----------------------
    # Each JAX while_loop body is a unit of ``solver/units.py``: a function of
    # the carry ``c`` returning the entries it updates, with no host read.
    # Each loop of ``drive`` tests the ``any_*`` flag a unit leaves behind,
    # as the eager loop read ``active.any()``. Lanes outside a loop
    # are frozen with torch.where exactly as JAX's vmapped loop freezes them,
    # so each lane's result does not depend on the lanes sharing its batch.

    def u_prologue(c):
        """Initial iterate and AL state (al_ilqr.py:839-855)."""
        xinit = c["xinit"]
        Bsz = xinit.shape[0]
        W = torch.clamp(c["z0"][..., nx:], w_lb, w_ub)
        it = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        finished = torch.zeros((Bsz,), dtype=torch.bool, device=dev)
        active = (it < cfg.max_al_iterations) & ~finished
        return dict(
            X=rollout(xinit, W), W=W, lam=c["lam0"],
            mu=torch.full((Bsz,), cfg.penalty_initial, **fdev),
            grad_norm=torch.full((Bsz,), float("inf"), **fdev),
            n_inner=torch.zeros((Bsz,), dtype=torch.int32, device=dev),
            viol=torch.full((Bsz,), float("inf"), **fdev),
            finished=finished, it_al=it, active_al=active, any_al=active.any(),
        )

    def u_al_head(c):
        """(a) Enter the inner iLQR (al_ilqr.py:662-683). Lanes outside the
        AL loop enter it frozen: they cost no trips and keep ``grad_norm``
        as their stationarity measure."""
        Bsz = c["X"].shape[0]
        done = ~c["active_al"]
        it = torch.zeros((Bsz,), dtype=torch.int32, device=dev)
        active = (it < cfg.max_ilqr_iterations) & ~done
        return dict(
            Xi=c["X"], Wi=c["W"],
            cost_cur=al_stage_cost(c["X"], c["W"], c["P"], c["lam"], c["mu"]),
            reg=torch.full((Bsz,), cfg.reg_initial, **fdev),
            done=done, gn_in=c["grad_norm"],
            n_used=torch.zeros((Bsz,), dtype=torch.int32, device=dev),
            it_in=it, active_in=active, any_in=active.any(),
        )

    def u_head(c):
        """(b) Gauss-Newton model, backward sweep, step norms and the line
        search's start (al_ilqr.py:684-719)."""
        X, W, P = c["Xi"], c["Wi"], c["P"]
        lx, lw, lxx, lxw, lww = stage_expansion_blocks(X, W, P, c["lam"], c["mu"])
        k_ff, K, failed = backward(X, W, lx, lw, lxx, lxw, lww, c["reg"])
        gn_step = torch.amax(torch.abs(k_ff), dim=(1, 2))
        # tiny Newton step: no search needed (the lane is declared done in
        # the tail); near-stationary: probe only alpha = 1
        tiny_step = gn_step < cfg.tol_gradient
        near_stat = gn_step < cfg.tol_stationarity
        max_ls = torch.where(near_stat, 1, cfg.line_search_steps)
        # Backtracking line search with early exit (al_ilqr.py:720-755):
        # largest alpha first, each lane stops at its first improvement.
        # Lanes that are done, failed, tiny-stepped (or inactive here)
        # start "accepted" and never search.
        skip_ls = c["done"] | failed | tiny_step | ~c["active_in"]
        ls_it = torch.zeros_like(c["it_in"])
        searching = (ls_it < max_ls) & ~skip_ls
        return dict(
            k_ff=k_ff, K=K, failed=failed, gn_step=gn_step, tiny_step=tiny_step,
            max_ls=max_ls, skip_ls=skip_ls, accepted=skip_ls, X_ls=X, W_ls=W,
            cost_ls=c["cost_cur"], ls_it=ls_it, searching=searching, any_ls=searching.any(),
        )

    def u_probe(c):
        """(c) One line-search probe: every searching lane tries its alpha
        (al_ilqr.py:720-755)."""
        searching, accepted, ls_it = c["searching"], c["accepted"], c["ls_it"]
        alpha = torch.pow(cfg.line_search_decay, ls_it.to(torch.float32))
        X_c, W_c, cost_c = forward(
            c["xinit"], c["Xi"], c["Wi"], c["k_ff"], c["K"], c["P"], c["lam"], c["mu"], alpha
        )
        delta = torch.sum(cost_c - c["cost_cur"], -1)
        better = searching & torch.isfinite(cost_c).all(-1) & (delta < -1e-9)
        accepted = accepted | better
        ls_it = ls_it + searching.to(torch.int32)
        searching = (ls_it < c["max_ls"]) & ~accepted
        return dict(
            X_ls=where(better, X_c, c["X_ls"]), W_ls=where(better, W_c, c["W_ls"]),
            cost_ls=where(better, cost_c, c["cost_ls"]), accepted=accepted, ls_it=ls_it,
            searching=searching, any_ls=searching.any(),
        )

    def u_tail(c):
        """(d) Accept, regularisation, done flags (al_ilqr.py:756-817)."""
        X, W, cost_cur, reg = c["Xi"], c["Wi"], c["cost_cur"], c["reg"]
        done, active, failed = c["done"], c["active_in"], c["failed"]
        gn_step, tiny_step = c["gn_step"], c["tiny_step"]
        improved = c["accepted"] & ~c["skip_ls"]
        accept = improved & ~failed

        take = accept & ~done
        X_new = where(take, c["X_ls"], X)
        W_new = where(take, c["W_ls"], W)
        cost_new = where(take, c["cost_ls"], cost_cur)
        # escalate reg only on a genuine failure (bad factorization or a
        # searched-and-rejected step); a tiny step at HIGH reg decays reg
        # toward reg_converged_max instead of livelocking
        escalate = failed | (~improved & ~tiny_step)
        decay_probe = tiny_step & ~failed & (reg > cfg.reg_converged_max)
        reg_step = torch.where(
            accept,
            torch.clamp(reg * 0.5, min=cfg.reg_min),
            torch.where(
                escalate,
                torch.clamp(reg * 10.0, max=cfg.reg_max),
                torch.where(decay_probe, torch.clamp(reg * 0.1, min=cfg.reg_min), reg),
            ),
        )
        reg_new = torch.where(done, reg, reg_step)
        gn = torch.where(done, c["gn_in"], gn_step)
        # two-tier stationarity exit (al_ilqr.py:791-813): (a) the Newton
        # step is below tol_gradient; (b) no improvement was found and
        # the step is below tol_stationarity (beneath the f32 merit
        # noise floor). Guarded by an honest factorization and reg.
        done_new = done | (
            ~failed
            & (reg <= cfg.reg_converged_max)
            & ((gn_step < cfg.tol_gradient) | (~improved & (gn_step < cfg.tol_stationarity)))
        )
        n_used_new = c["n_used"] + (~done).to(torch.int32)

        done = torch.where(active, done_new, done)
        it = c["it_in"] + active.to(torch.int32)
        active_next = (it < cfg.max_ilqr_iterations) & ~done
        return dict(
            Xi=where(active, X_new, X), Wi=where(active, W_new, W),
            cost_cur=where(active, cost_new, cost_cur), reg=torch.where(active, reg_new, reg),
            done=done, gn_in=torch.where(active, gn, c["gn_in"]),
            n_used=torch.where(active, n_used_new, c["n_used"]), it_in=it,
            active_in=active_next, any_in=active_next.any(),
        )

    def u_al_update(c):
        """(e) Multiplier and penalty update, feasibility, early exit once
        feasible + stationary (al_ilqr.py:856-905)."""
        X2, W2, P, active = c["Xi"], c["Wi"], c["P"], c["active_al"]
        lam, mu, gn = c["lam"], c["mu"], c["gn_in"]
        Bsz = X2.shape[0]
        # pinned stage-0 rows are offset out of both the multiplier update
        # and the feasibility measure
        C = stage_ineq(X2, W2, P) + C_OFF
        viol2 = (
            torch.amax(torch.clamp(-C, min=0.0), dim=(1, 2))
            if n_con > 0
            else torch.zeros((Bsz,), **fdev)
        )
        lam2 = torch.clamp(lam - mu[:, None, None] * C, min=0.0)
        mu2 = torch.where(
            viol2 > cfg.tol_constraint,
            torch.clamp(mu * cfg.penalty_scale, max=cfg.penalty_max),
            mu,
        )
        finished2 = (viol2 <= cfg.tol_constraint) & (gn <= cfg.tol_stationarity)
        finished = c["finished"] | (active & finished2)
        it = c["it_al"] + active.to(torch.int32)
        active_next = (it < cfg.max_al_iterations) & ~finished
        return dict(
            X=where(active, X2, c["X"]), W=where(active, W2, c["W"]), lam=where(active, lam2, lam),
            mu=torch.where(active, mu2, mu), grad_norm=torch.where(active, gn, c["grad_norm"]),
            n_inner=c["n_inner"] + torch.where(active, c["n_used"], 0),
            viol=torch.where(active, viol2, c["viol"]), finished=finished, it_al=it,
            active_al=active_next, any_al=active_next.any(),
        )

    def u_epilogue(c):
        """(f) True cost, exit flag and the raw stage-0 violation
        (al_ilqr.py:909-935)."""
        X, W, P, viol, grad_norm = c["X"], c["W"], c["P"], c["viol"], c["grad_norm"]
        Bsz = X.shape[0]
        cost = torch.sum(true_cost(X, W, P), -1)
        z = torch.cat([X, W], -1)
        # raw (unmasked) stage-0 violation: pinned rows are excluded from the
        # solver's feasibility measure, but safety monitoring must still see
        # an in-collision start (mpcPlanner.py:263)
        if n_con > 0 and bool(pinned.any()):  # numpy, decided at build time
            c0_raw = stage_ineq(X[:, :1], W[:, :1], P[:, :1])
            violation0_raw = torch.amax(torch.clamp(-c0_raw, min=0.0), dim=(1, 2))
        else:
            violation0_raw = torch.zeros((Bsz,), **fdev)
        # a finite trajectory with non-finite violation/cost/stationarity
        # (e.g. NaN parameters) is still a numerical failure
        finite = (
            torch.isfinite(z).all(-1).all(-1)
            & torch.isfinite(viol)
            & torch.isfinite(cost)
            & torch.isfinite(grad_norm)
        )
        exitflag = torch.where(finite & c["finished"], 1, torch.where(finite, 0, -1)).to(torch.int32)
        return dict(z=z, exitflag=exitflag, cost=cost, violation0_raw=violation0_raw)

    units = {
        "prologue": u_prologue, "al_head": u_al_head, "head": u_head, "probe": u_probe,
        "tail": u_tail, "al_update": u_al_update, "epilogue": u_epilogue,
    }
    programs = {}

    def program(xinit, P) -> UnitProgram:
        """The units and carry of this solver at the inputs' batch shape."""
        key = (tuple(xinit.shape), tuple(P.shape))
        if key not in programs:
            programs[key] = UnitProgram(units, dev)
        return programs[key]

    # ---------------- the loops ----------------------------------------------

    def drive(prog: UnitProgram) -> None:
        """The solve's loops over its units (``prog.loop``: a host read per
        trip on the CPU, a WHILE node tested on the device in the graph)."""
        prog.run("prologue")
        for _ in prog.loop("any_al"):  # outer AL loop (al_ilqr.py:890)
            prog.run("al_head")
            for _ in prog.loop("any_in"):  # inner iLQR (al_ilqr.py:818)
                prog.run("head")
                for _ in prog.loop("any_ls"):  # line search (al_ilqr.py:750)
                    prog.run("probe")
                prog.run("tail")
            prog.run("al_update")
        prog.run("epilogue")

    def solve(xinit, params, z0, lam0=None) -> SolveResult:
        xinit = torch.as_tensor(xinit, **fdev)
        P = torch.as_tensor(params, **fdev)
        z0 = torch.as_tensor(z0, **fdev)
        lam0 = (
            torch.zeros((xinit.shape[0], N, n_con), **fdev)
            if lam0 is None
            else torch.as_tensor(lam0, **fdev)
        )
        prog = program(xinit, P)
        prog.load(xinit=xinit, P=P, z0=z0, lam0=lam0)
        prog.call(lambda: drive(prog))  # on the card: one graph replay
        c = prog.carry
        # fresh tensors: the next solve at this shape overwrites the carry
        return SolveResult(
            z=c["z"].clone(),
            exitflag=c["exitflag"].clone(),
            cost=c["cost"].clone(),
            violation=c["viol"].clone(),
            grad_norm=c["grad_norm"].clone(),
            lam=c["lam"].clone(),
            iterations=c["n_inner"].clone(),
            violation0_raw=c["violation0_raw"].clone(),
        )

    # the kernel library (csrc stem) the backward sweep launches on the card,
    # None for the scan: what a solver artifact exports (utils/aot.py)
    if packed is not None:
        solve.riccati_kernel = "riccati_packed"
    else:
        solve.riccati_kernel = None if cfg.riccati_backend == "scan" else "riccati_batched"
    # exposed for white-box tests, as the JAX package's ``_internals``;
    # ``program(xinit, params)`` gives the units and carry at a batch shape
    solve._program = program
    solve._internals = {
        "all_dyn_jacobians": all_dyn_jacobians,
        "stage_expansion_blocks": stage_expansion_blocks,
        "al_stage_cost": al_stage_cost,
        "true_cost": true_cost,
        "stage_ineq": stage_ineq,
        "C_OFF": C_OFF,
    }
    return solve
