"""Model layer: URDF kinematics, robot dynamics, and MPC problem assembly."""

from robot_mpcs_tpu_torch.models.urdf import UrdfModel, Joint, parse_urdf, load_urdf
from robot_mpcs_tpu_torch.models.fk import RobotKinematics
from robot_mpcs_tpu_torch.models.dimensions import ProblemDimensions
