"""Global planner: occupancy post-processing + A* + waypoint following (port
of ``robot_mpcs_tpu.global_planner.global_planner``).

Re-design of reference ``robotmpcs/global_planner/globalPlanner.py``:

* the 3D -> 2D occupancy flatten and the robot-size obstacle enlargement run
  as array ops (the enlargement is a box-kernel convolution + binarize — the
  reference does it with O(H W k^2) Python loops, ``globalPlanner.py:51-60``;
  here it is one ``torch.nn.functional.conv2d`` on the planner's device);
* the in-memory array is the source of truth — no png round trip through a
  colormapped matplotlib image (``globalPlanner.py:34-37``), though png I/O
  is available via ``OccupancyGridMap.from_png``;
* the A* search itself is the native core (``astar.py``).

Frame conventions (``convert_meters`` etc.) match the reference exactly so
example code ports unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from robot_mpcs_tpu_torch.global_planner.astar import a_star
from robot_mpcs_tpu_torch.global_planner.grid_map import OccupancyGridMap
from robot_mpcs_tpu_torch.utils.devices import resolve_device


def enlarge_obstacles(
    occ_map: np.ndarray, kernel_size: int, threshold: float, device="cuda"
) -> np.ndarray:
    """Box-blur then binarize (reference ``globalPlanner.py:39-70``): cells
    whose blurred occupancy exceeds ``threshold`` become hard obstacles.
    Border cells (where the kernel does not fit) keep their original value,
    matching the reference's loop bounds. The blur (a VALID convolution)
    runs on ``device``; the map stays a host array."""
    dev = resolve_device(device)
    k = kernel_size
    kernel = torch.ones((2 * k + 1, 2 * k + 1), dtype=torch.float32, device=dev)
    kernel = kernel / torch.sum(kernel)
    x = torch.tensor(np.asarray(occ_map, np.float32), device=dev)[None, None]
    blurred = torch.nn.functional.conv2d(x, kernel[None, None])[0, 0]
    out = np.asarray(occ_map, np.float32).copy()
    inner = blurred.cpu().numpy()
    out[k : occ_map.shape[0] - k, k : occ_map.shape[1] - k] = inner
    return (out > threshold).astype(np.float32)


class GlobalPlanner:
    def __init__(
        self,
        dim_pixels,
        limits_low,
        limits_high,
        BOOL_PLOTTING: bool = False,
        threshold: float = 0.29,
        convolution_blur=(5, 5),
        enlarge_obstacles: bool = True,
        threshold_local_goal: float = 1.3,
        device="cuda",
    ):
        self.dim_pixels = np.asarray(dim_pixels)
        self.limits_high = np.asarray(limits_high, dtype=float)
        self.limits_low = np.asarray(limits_low, dtype=float)
        self.dim_meters = -self.limits_low + self.limits_high
        self.cell_size_xyz = self.dim_meters / self.dim_pixels
        self.threshold = threshold
        self.enlarge = enlarge_obstacles
        self.convolution_blur = convolution_blur
        self.idx_local = 0
        self.threshold_local_goal = threshold_local_goal
        self.plotting = BOOL_PLOTTING
        self.occupancy_map_2d: Optional[np.ndarray] = None
        self.device = resolve_device(device)

        if not np.isclose(self.cell_size_xyz[0], self.cell_size_xyz[1]):
            raise ValueError(
                "voxels must have equal x/y size "
                f"(got {self.cell_size_xyz[:2]})"
            )
        self.cell_size = float(self.cell_size_xyz[0])

    # ------------------------------------------------------------- occupancy

    def get_occupancy_map(self, sensor, occupancy_map_3d: np.ndarray):
        """Flatten a 3D occupancy grid to 2D (reference
        ``globalPlanner.py:34-37``); kept in memory instead of a png round
        trip. Returns ``sensor`` untouched for API parity."""
        self.occupancy_map_2d = np.clip(
            np.sum(np.asarray(occupancy_map_3d), axis=2), 0, self.threshold
        ).astype(np.float32)
        return sensor

    def get_enlarged_obstacles(self, size_robot: float = 0.4) -> np.ndarray:
        if self.occupancy_map_2d is None:
            raise RuntimeError("call get_occupancy_map first")
        size_robot_pixels = int(np.ceil(size_robot / self.cell_size))
        self.occupancy_map_enlarged = enlarge_obstacles(
            self.occupancy_map_2d / max(self.occupancy_map_2d.max(), 1e-6),
            size_robot_pixels,
            self.threshold,
            device=self.device,
        )
        return self.occupancy_map_enlarged

    # ------------------------------------------------------- frame transforms

    def convert_meters(self, pos_meters: Sequence[float]) -> List[float]:
        """World meters -> image-frame meters (reference
        ``globalPlanner.py:102-110``: shift positive, flip x/y)."""
        p = np.asarray(pos_meters, dtype=float)
        shifted = p - self.limits_low
        return [shifted[1], self.dim_meters[1] - shifted[0], p[2]]

    def convert_meters_reversed(self, pos_meters: Sequence[float]) -> np.ndarray:
        p = list(pos_meters)
        if len(p) == 2:
            p = p + [0.0]
        update = [self.dim_meters[1] - p[1], p[0], p[2]]
        return np.asarray(update) + self.limits_low

    def convert_path(self, path) -> List[np.ndarray]:
        return [self.convert_meters_reversed(pos) for pos in path]

    # ---------------------------------------------------------------- planning

    def get_global_path_astar(self, start_pos, goal_pos):
        """One-shot global plan (reference ``globalPlanner.py:138-167``).
        Returns (path in world meters, path in grid indices)."""
        if self.occupancy_map_2d is None:
            raise RuntimeError("call get_occupancy_map first")
        data = (
            self.get_enlarged_obstacles()
            if self.enlarge
            else self.occupancy_map_2d / max(self.occupancy_map_2d.max(), 1e-6)
        )
        gmap = OccupancyGridMap.from_array(data, self.cell_size)
        start = self.convert_meters(start_pos)
        goal = self.convert_meters(goal_pos)
        path, path_px = a_star(start, goal, gmap, movement="8N")
        if not path:
            print("Goal is not reachable")
        path_converted = self.convert_path([(p[0], p[1], 0.0) for p in path])
        return path_converted, path_px

    # ---------------------------------------------------------- local follower

    def get_distance_points(self, position1, position2) -> float:
        return float(
            np.hypot(position2[0] - position1[0], position2[1] - position1[1])
        )

    def get_local_goal(self, position, path):
        """Waypoint follower (reference ``globalPlanner.py:174-189``):
        advance the local index when within ``threshold_local_goal`` of the
        current waypoint; never go backwards; stop at the final node."""
        distance = self.get_distance_points(position, path[self.idx_local])
        if self.idx_local < len(path) - 1 and len(path) > 0:
            if distance <= self.threshold_local_goal:
                self.idx_local += 1
        return path[self.idx_local]
