"""Fleet execution on one device or sharded over processes (port of
``robot_mpcs_tpu.parallel``: ``distributed``, ``mesh``, ``fleet`` and
``fleet_group``)."""

from robot_mpcs_tpu_torch.parallel.mesh import (
    Mesh,
    gather_batch,
    make_mesh,
    pad_batch_to_mesh,
    shard_batch,
)
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario
from robot_mpcs_tpu_torch.parallel.fleet_group import (
    FleetGroup,
    GroupMetrics,
    mixed_fleet_scenarios,
)
