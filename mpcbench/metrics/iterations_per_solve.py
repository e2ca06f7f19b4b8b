"""iterations_per_solve: the solver's inner iterations per solve over the window (.fleet: FleetMetrics.mean_iterations weighted by lanes; .planner: each solve's SolveResult.iterations)."""

from mpcbench import readers

LAYER = "solver (solver/al_ilqr.py)"
UNIT = "iterations"
SOURCE = "program_counter"


def read(rec):
    return readers.iterations_per_solve(rec)
