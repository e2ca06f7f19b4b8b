"""Free-space decomposition: lidar point clouds -> K halfplane constraints
(port of ``robot_mpcs_tpu.perception.free_space_decomposition``).

Re-design of reference ``robotmpcs/utils/free_space_decomposition.py``: the
greedy carve loop (take the nearest point, cut a halfplane through it with
the normal toward the robot, discard points the plane already separates,
repeat) runs exactly K iterations over batch-first tensors with a validity
mask. Each iteration's slot write is a one-hot select and the "any point
left" test stays a tensor, so the K iterations queue on the device with no
host sync, for any number of (stage, scenario) clouds at once — the
reference runs it N times per control step in Python/numpy
(``examples/boxer_example.py:193-201``).

Reference bug fixed, not replicated: ``aslist`` pads empty slots with a plane
through the robot position itself (argument order swapped vs ``asdict``,
``free_space_decomposition.py:118-129``), which would violate the clearance
constraint identically; both APIs here pad with the far dummy plane of
``asdict`` (:103-116).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from robot_mpcs_tpu_torch.utils.devices import resolve_device

_FAR = 1.0e6


def free_space_halfplanes(
    points: torch.Tensor,
    position: torch.Tensor,
    number_constraints: int = 10,
    max_radius: float = 1.0,
) -> torch.Tensor:
    """Greedy free-space carve, fixed output size, on ``points``' device.

    ``points``: (..., P, 3) point clouds (pad with far points for fixed
    arity); ``position``: (..., 3) robot positions, the same leading
    dimensions. Returns (..., K, 4) planes ``[a, b, c, d]`` with
    ``a x + b y + c z + d = 0`` and the robot on the positive side, exactly
    the reference's ``HalfPlane.constraint()`` layout. Unused slots hold the
    far dummy plane (robot-side positive, ~28 m away).
    """
    pts = torch.as_tensor(points, dtype=torch.float32)
    position = torch.as_tensor(position, dtype=torch.float32, device=pts.device)
    K = number_constraints
    d2 = torch.sum((pts - position[..., None, :]) ** 2, dim=-1)  # (..., P)
    valid = d2 < max_radius**2

    # dummy plane through position + (20, 20, 0) with normal toward the robot
    dummy_point = position + torch.tensor([20.0, 20.0, 0.0], device=pts.device)
    dummy_n = position - dummy_point
    dummy = torch.cat([dummy_n, -torch.sum(dummy_n * dummy_point, -1, keepdim=True)], -1)

    planes = dummy[..., None, :].expand(dummy.shape[:-1] + (K, 4)).clone()
    slots = torch.arange(K, device=pts.device)
    count = torch.zeros(d2.shape[:-1], dtype=torch.int64, device=pts.device)
    for _ in range(K):
        dist = torch.where(valid, d2, _FAR)
        idx = torch.argmin(dist, dim=-1, keepdim=True)  # first index on ties
        any_left = torch.gather(dist, -1, idx)[..., 0] < _FAR
        point = torch.gather(pts, -2, idx[..., None].expand(idx.shape + (3,)))[..., 0, :]
        normal = position - point
        const = -torch.sum(normal * point, -1, keepdim=True)
        plane = torch.where(any_left[..., None], torch.cat([normal, const], -1), dummy)
        # count < K holds in every iteration: one-hot write of slot `count`
        write = slots == count[..., None]
        planes = torch.where(write[..., None], plane[..., None, :], planes)
        # drop points the new plane already separates ("behind" it,
        # reference free_space_decomposition.py:16-20,88-98)
        behind = torch.sum(pts * plane[..., None, :3], -1) + plane[..., 3:] <= 0.0
        valid = valid & ~behind & any_left[..., None]
        count = count + any_left.to(torch.int64)
    return planes


class HalfPlane:
    """Host-side halfplane helper (API parity with the reference class)."""

    def __init__(self, point: np.ndarray, position: np.ndarray):
        self._normal_vector = np.asarray(position, float) - np.asarray(point, float)
        self._point = np.asarray(point, float)
        self._constant = -float(np.dot(self._normal_vector, self._point))

    def normal(self) -> np.ndarray:
        return self._normal_vector

    def point(self) -> np.ndarray:
        return self._point

    def constant(self) -> float:
        return self._constant

    def point_behind_plane(self, point) -> bool:
        return float(np.dot(self.normal(), point) + self.constant()) <= 0.0

    def point_infront_plane(self, point) -> bool:
        return not self.point_behind_plane(point)

    def constraint(self) -> np.ndarray:
        return np.concatenate((self.normal(), np.array([self.constant()])))

    def get_points(self) -> np.ndarray:
        """Two points spanning the plane's 2D line (for plotting)."""
        n = self.normal()
        if abs(n[1]) < 1e-12:
            x = np.array([self._point[0], self._point[0]])
            return np.array([x, np.array([-5.0, 5.0])])
        x = np.arange(0, 2) * 10.0 - 5.0
        y = (-self.constant() - n[0] * x) / n[1]
        return np.array([x, y])


class FreeSpaceDecomposition:
    """Host-facing wrapper with the reference's stateful API
    (``set_position`` / ``compute_constraints`` / ``asdict`` / ``aslist``);
    the carve runs on ``device`` (the CUDA card by default)."""

    def __init__(self, number_constraints: int = 10, max_radius: float = 1.0, device="cuda"):
        self._number_constraints = number_constraints
        self._max_radius = max_radius
        self._device = resolve_device(device)
        self._position = np.zeros(3)
        self._planes = None

    def set_position(self, position: np.ndarray) -> None:
        self._position = np.asarray(position, float)

    def compute_constraints(self, points: np.ndarray) -> None:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        self._planes = (
            free_space_halfplanes(
                torch.tensor(pts, device=self._device),
                torch.tensor(self._position, dtype=torch.float32, device=self._device),
                number_constraints=self._number_constraints,
                max_radius=self._max_radius,
            )
            .cpu()
            .numpy()
        )

    def constraints(self) -> List[HalfPlane]:
        """Non-dummy planes as HalfPlane objects."""
        out = []
        for plane in self._active_planes():
            n = plane[:3]
            point = self._nearest_point_on_plane(plane)
            out.append(HalfPlane(point, point + n))
        return out

    def _active_planes(self) -> np.ndarray:
        if self._planes is None:
            return np.zeros((0, 4))
        dummy_n = -np.array([20.0, 20.0, 0.0])
        mask = ~np.all(np.isclose(self._planes[:, :3], dummy_n, atol=1e-5), axis=1)
        return self._planes[mask]

    def _nearest_point_on_plane(self, plane: np.ndarray) -> np.ndarray:
        n = plane[:3]
        return -plane[3] * n / max(float(np.dot(n, n)), 1e-12)

    def asdict(self) -> dict:
        return {
            f"constraint_{i}": self._planes[i] for i in range(self._number_constraints)
        }

    def aslist(self) -> np.ndarray:
        return np.array(self._planes)

    def get_points(self) -> List[np.ndarray]:
        planes = []
        for plane in self._active_planes():
            n = plane[:3]
            if abs(n[1]) < 1e-12:
                point = self._nearest_point_on_plane(plane)
                planes.append(np.array([[point[0], point[0]], [-5.0, 5.0]]))
            else:
                x = np.arange(0, 2) * 10.0 - 5.0
                y = (-plane[3] - n[0] * x) / n[1]
                planes.append(np.array([x, y]))
        return planes
