"""The batched AL-iLQR solver, batch-first (port of ``robot_mpcs_tpu.solver``)."""

from robot_mpcs_tpu_torch.solver.types import SolveResult
from robot_mpcs_tpu_torch.solver.al_ilqr import build_solver
