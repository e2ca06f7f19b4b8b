"""Result container for the batched solver (port of ``robot_mpcs_tpu.solver.types``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolveResult(NamedTuple):
    """Outcome of a batch of NLP solves; every field has a leading batch axis B.

    ``exitflag`` follows the reference's ForcesPro convention
    (``mpcPlanner.py:263`` treats < 0 as failure):
      1  converged (stationarity + feasibility tolerances met),
      0  iteration budget exhausted with a usable (finite) trajectory,
     -1  numerical failure (non-finite values).
    """

    #: full stage trajectory, shape (B, N, nz) with z = [x, s, u]
    z: torch.Tensor
    exitflag: torch.Tensor  # (B,) int32
    #: objective value (true cost, without AL penalty terms), (B,)
    cost: torch.Tensor
    #: max inequality/bound violation, (B,)
    violation: torch.Tensor
    #: stationarity measure (max feedforward step of the last iLQR pass), (B,)
    grad_norm: torch.Tensor
    #: AL multipliers at the solution, shape (B, N, n_con) — warm-start input
    #: for the next MPC step
    lam: torch.Tensor
    #: inner iLQR iterations actually used, (B,) int32
    iterations: torch.Tensor
    #: raw (unmasked) stage-0 constraint violation, (B,). Pinned stage-0 rows
    #: (constraints that depend only on the fixed initial state) are masked
    #: out of ``violation``/``exitflag``, but a caller monitoring safety can
    #: still detect an in-collision START here.
    violation0_raw: torch.Tensor
