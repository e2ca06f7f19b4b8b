"""Runtime parameter layout: the ``paramMap`` ABI (port of
``robot_mpcs_tpu.models.params``; identical name -> index layout and npar).

The reference threads a flat per-stage parameter vector ``p`` (size ``npar``)
through every cost/constraint callback, with a name -> indices registry built
by ``addEntry2ParamMap`` (reference ``robotmpcs/models/mpcBase.py:68-71``) and
serialized as ``paramMap.yaml`` next to the generated solver
(``mpcModel.py:132-133``). The runtime planner then pokes values into a flat
``[N * npar]`` buffer stage by stage (``mpcPlanner.py:83-210``).

We keep this ABI: parameters live in one dense ``[N, npar]`` f32 array (a
single contiguous device buffer — the batched fleet carries
``[B, N, npar]``), with the same registration-order index layout, so
``paramMap.yaml`` files interoperate. Entries are contiguous ranges, so
component reads are static slices (views, no gathers).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class ParamMap:
    """Name -> contiguous range registry over the flat stage parameter vector."""

    entries: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    npar: int = 0

    def register(self, name: str, n: int) -> None:
        """Reference ``addEntry2ParamMap`` semantics: first registration wins
        (``mpcBase.py:68-71`` dedups repeated names, e.g. ``r_body``)."""
        if name not in self.entries:
            self.entries[name] = (self.npar, n)
            self.npar += n

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def size(self, name: str) -> int:
        return self.entries[name][1]

    def get(self, p: torch.Tensor, name: str) -> torch.Tensor:
        """Static slice of a parameter entry from ``p`` of shape ``[..., npar]``."""
        start, n = self.entries[name]
        return p[..., start : start + n]

    def set_np(self, params: np.ndarray, name: str, value, stage=None) -> None:
        """Write into a host-side ``[N, npar]`` buffer (all stages, or one)."""
        start, n = self.entries[name]
        v = np.broadcast_to(np.asarray(value, dtype=params.dtype), (n,))
        if stage is None:
            params[:, start : start + n] = v
        else:
            params[stage, start : start + n] = v

    def to_reference_dict(self) -> Dict[str, List[int]]:
        """The exact structure serialized as paramMap.yaml by the reference
        (name -> flat index list, ``mpcModel.py:132-133``)."""
        return {
            name: list(range(start, start + n))
            for name, (start, n) in self.entries.items()
        }

    @classmethod
    def from_reference_dict(cls, d: Dict[str, List[int]]) -> "ParamMap":
        """Rebuild from a paramMap.yaml mapping (name -> flat index list);
        every entry must be a contiguous range."""
        pm = cls()
        total = 0
        for name, idx in d.items():
            idx = list(idx)
            if idx != list(range(idx[0], idx[0] + len(idx))):
                raise ValueError(f"param entry {name!r} is not contiguous: {idx}")
            pm.entries[name] = (idx[0], len(idx))
            total = max(total, idx[0] + len(idx))
        pm.npar = total
        return pm


#: Sentinel "no obstacle" padding values (reference ``EmptyObstacle``,
#: ``mpcPlanner.py:18-26``): position -100, radius -100 makes the distance
#: constraint inactive while keeping fixed array shapes.
EMPTY_OBSTACLE_POSITION = -100.0
EMPTY_OBSTACLE_RADIUS = -100.0
