"""Occupancy grid map (reference ``robotmpcs/global_planner/gridmap.py``);
the port's own copy of ``robot_mpcs_tpu.global_planner.grid_map``.

Same index/meters conventions as the reference (``data[y][x]``, cell indices
= round(meters / cell_size), occupancy threshold 0.8) minus the A*-internal
visited bookkeeping, which lives inside the native search now.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class OccupancyGridMap:
    def __init__(
        self,
        data_array: np.ndarray,
        cell_size: float,
        occupancy_threshold: float = 0.8,
    ):
        self.data = np.asarray(data_array, dtype=np.float32)
        self.dim_cells = self.data.shape
        self.dim_meters = (
            self.dim_cells[0] * cell_size,
            self.dim_cells[1] * cell_size,
        )
        self.cell_size = float(cell_size)
        self.occupancy_threshold = float(occupancy_threshold)

    # --- index/meter transforms (reference gridmap.py:163-185) -----------

    def get_index_from_coordinates(self, x: float, y: float) -> Tuple[int, int]:
        return int(round(x / self.cell_size)), int(round(y / self.cell_size))

    def get_coordinates_from_index(self, x_index: int, y_index: int) -> Tuple[float, float]:
        return x_index * self.cell_size, y_index * self.cell_size

    # --- queries -----------------------------------------------------------

    def is_inside_idx(self, point_idx) -> bool:
        x, y = point_idx
        return 0 <= x < self.dim_cells[1] and 0 <= y < self.dim_cells[0]

    def get_data_idx(self, point_idx) -> float:
        x, y = point_idx
        return float(self.data[y][x])

    def is_occupied_idx(self, point_idx) -> bool:
        return self.get_data_idx(point_idx) >= self.occupancy_threshold

    def is_occupied(self, point) -> bool:
        return self.is_occupied_idx(self.get_index_from_coordinates(*point[:2]))

    def set_data_idx(self, point_idx, value: float) -> None:
        x, y = point_idx
        self.data[y][x] = value

    # --- I/O ---------------------------------------------------------------

    @classmethod
    def from_array(cls, array: np.ndarray, cell_size: float) -> "OccupancyGridMap":
        return cls(np.asarray(array, dtype=np.float32), cell_size)

    @classmethod
    def from_png(cls, filename: str, cell_size: float) -> "OccupancyGridMap":
        """Load a grayscale png as [0, 1] occupancy, origin at lower-left
        (reference ``utils_astar.py:23-54`` / ``gridmap.py:194-206``)."""
        from PIL import Image

        img = Image.open(filename)
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 3:
            arr = arr[..., 0]
        arr = arr / 255.0
        arr = arr[::-1]  # origin='lower'
        return cls(arr, cell_size)

    def plot(self, alpha: float = 1.0):  # pragma: no cover - visualization
        import matplotlib.pyplot as plt

        plt.imshow(self.data, vmin=0, vmax=1, origin="lower",
                   interpolation="none", alpha=alpha)
        plt.draw()
