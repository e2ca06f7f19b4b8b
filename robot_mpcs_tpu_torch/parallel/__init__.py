"""Single-device fleet execution (port of ``robot_mpcs_tpu.parallel.fleet`` and
``fleet_group``)."""

from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario
from robot_mpcs_tpu_torch.parallel.fleet_group import (
    FleetGroup,
    GroupMetrics,
    mixed_fleet_scenarios,
)
