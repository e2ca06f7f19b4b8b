"""Single-device fleet execution (port of ``robot_mpcs_tpu.parallel.fleet``)."""

from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario
