from robot_mpcs_tpu_torch.utils.geometry import point_to_plane
from robot_mpcs_tpu_torch.utils.checkpoint import load_fleet_state, save_fleet_state
from robot_mpcs_tpu_torch.utils.profiling import StepTimer, timed, trace
