"""Small geometry helpers shared by constraint components."""

from __future__ import annotations

import torch


def point_to_plane(point: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Unsigned distance from point(s) to plane(s) ``ax + by + cz + d = 0``.

    ``point``: ``(..., 3)``, ``plane``: ``(..., 4)`` — broadcasting applies.
    Matches reference ``robotmpcs/utils/utils.py:48-52``.
    """
    normal = plane[..., :3]
    num = torch.abs(torch.sum(normal * point, dim=-1) + plane[..., 3])
    den = torch.sqrt(torch.sum(normal * normal, dim=-1) + 1e-12)
    return num / den
