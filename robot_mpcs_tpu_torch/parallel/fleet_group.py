"""Mixed-robot fleet (port of ``robot_mpcs_tpu.parallel.fleet_group``).

Robot classes have different static shapes (nx, nu, N, constraint sets), so
each class keeps its own homogeneous ``FleetRunner`` (grouped batching), and
the group steps them back to back on the same device. On the card each
class's step is one CUDA graph replay (``FleetRunner.step``), so a group
step is one replay per class, queued with no host read in between.
Metrics come back per class plus a batch-size-weighted
aggregate. With a ``mesh`` every class runner shards its batch over the same
ranks (each class batch divides by the mesh size), and each class's metrics
are already global when ``_aggregate`` weighs them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel.mesh import Mesh
from robot_mpcs_tpu_torch.parallel.fleet import (
    FleetMetrics,
    FleetRunner,
    FleetScenario,
    FleetState,
    random_fleet_scenario,
)


class GroupMetrics(NamedTuple):
    """Aggregate + per-class metrics of one mixed-fleet step."""

    #: batch-size-weighted aggregate over all classes
    overall: FleetMetrics
    #: one FleetMetrics per problem class, keyed by class name
    per_class: Dict[str, FleetMetrics]


def _aggregate(per_class: Dict[str, FleetMetrics], sizes: Dict[str, int]) -> FleetMetrics:
    """Weighted mean for rates/means, max for max-style fields (fleet_group.py:50-77)."""
    total = float(sum(sizes.values()))
    w = {k: sizes[k] / total for k in per_class}

    def wmean(field: str) -> torch.Tensor:
        return sum(w[k] * getattr(m, field) for k, m in per_class.items())

    def gmax(field: str) -> torch.Tensor:
        vals = [getattr(m, field) for m in per_class.values()]
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
        return out

    return FleetMetrics(
        converged_fraction=wmean("converged_fraction"),
        mean_cost=wmean("mean_cost"),
        max_violation=gmax("max_violation"),
        max_violation_converged=gmax("max_violation_converged"),
        max_violation_unconverged=gmax("max_violation_unconverged"),
        mean_goal_distance=wmean("mean_goal_distance"),
        reset_fraction=wmean("reset_fraction"),
        mean_iterations=wmean("mean_iterations"),
        max_iterations=gmax("max_iterations"),
        rescue_overflow_fraction=wmean("rescue_overflow_fraction"),
        max_violation0_raw=gmax("max_violation0_raw"),
    )


class FleetGroup:
    """Steps several homogeneous FleetRunners as one mixed fleet.

    ``problems``: ``{class_name: (MpcProblem, batch_size)}``, global batch
    sizes. Every class runs on ``device`` (the CUDA card unless ``"cpu"`` is
    given), or sharded over ``mesh`` on its device; ``runner_kwargs`` go to
    each class's ``FleetRunner``.
    """

    def __init__(
        self,
        problems: Dict[str, Tuple[MpcProblem, int]],
        device=None,
        mesh: Optional[Mesh] = None,
        **runner_kwargs,
    ):
        if not problems:
            raise ValueError("FleetGroup needs at least one problem class")
        self.runners: Dict[str, FleetRunner] = {}
        self.sizes: Dict[str, int] = {}
        for name, (problem, batch) in problems.items():
            self.runners[name] = FleetRunner(
                problem, batch, device=device, mesh=mesh, **runner_kwargs
            )
            self.sizes[name] = batch
        self.total_batch = sum(self.sizes.values())

    # ------------------------------------------------------------------ API

    def to_device(self, scenarios: Dict[str, FleetScenario]) -> Dict[str, FleetScenario]:
        return {k: self.runners[k].to_device(s) for k, s in scenarios.items()}

    def shard_scenarios(self, scenarios: Dict[str, FleetScenario]) -> Dict[str, FleetScenario]:
        """Each class's shard of its global scenario, on the device."""
        return {k: self.runners[k].shard_scenario(s) for k, s in scenarios.items()}

    def init_states(self, scenarios: Dict[str, FleetScenario]) -> Dict[str, FleetState]:
        return {k: self.runners[k].init_state(scenarios[k]) for k in self.runners}

    def step(
        self,
        states: Dict[str, FleetState],
        scenarios: Dict[str, FleetScenario],
    ) -> Tuple[Dict[str, FleetState], GroupMetrics]:
        """Advance every class by one control step."""
        new_states: Dict[str, FleetState] = {}
        per_class: Dict[str, FleetMetrics] = {}
        for name, runner in self.runners.items():
            new_states[name], per_class[name] = runner.step(states[name], scenarios[name])
        return new_states, GroupMetrics(
            overall=_aggregate(per_class, self.sizes), per_class=per_class
        )

    def run(
        self, scenarios: Dict[str, FleetScenario], n_steps: int
    ) -> Tuple[Dict[str, FleetState], GroupMetrics]:
        scenarios = self.shard_scenarios(scenarios)
        states = self.init_states(scenarios)
        metrics: Optional[GroupMetrics] = None
        for _ in range(n_steps):
            states, metrics = self.step(states, scenarios)
        return states, metrics


def mixed_fleet_scenarios(
    problems: Dict[str, Tuple[MpcProblem, int]],
    seed: int = 0,
    sampler_kwargs: Optional[Dict[str, dict]] = None,
) -> Dict[str, FleetScenario]:
    """Randomized scenarios for every class of a mixed fleet, drawn as the JAX
    package draws them: class ``i`` from seed ``seed + 1000 * i``
    (fleet_group.py:149-164). ``sampler_kwargs`` maps a class name to extra
    ``random_fleet_scenario`` arguments (goal boxes etc. differ per robot
    family). Returns CPU tensors."""
    sampler_kwargs = sampler_kwargs or {}
    out = {}
    for i, (name, (problem, batch)) in enumerate(problems.items()):
        out[name] = random_fleet_scenario(
            problem, batch, seed=seed + 1000 * i, **sampler_kwargs.get(name, {})
        )
    return out
