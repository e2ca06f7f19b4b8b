from robot_mpcs_tpu_torch.planner.mpc_planner import (
    EmptyObstacle,
    MPCPlanner,
    SolverDoesNotExistError,
)
