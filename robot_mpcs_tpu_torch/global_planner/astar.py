"""A* over occupancy grids: ctypes binding to the native core + fallback
(the port's own copy of ``robot_mpcs_tpu.global_planner.astar``; it loads
the repository's ``native/libastar.so`` when that is built).

Functional equivalent of reference ``robotmpcs/global_planner/a_star.py``
(textbook grid A*, 4/8-connectivity, occupancy-probability soft cost), but
the search runs in C++ (``native/astar.cpp``) — the one inherently
sequential, host-side hot path in the framework. A pure-Python fallback with
identical semantics is kept for environments without the compiled library.
"""

from __future__ import annotations

import ctypes
import math
import os
from heapq import heappop, heappush
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libastar.so"),
    os.path.join(os.path.dirname(__file__), "libastar.so"),
]


def _load_native():
    for path in _LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(os.path.abspath(path))
            except OSError:
                continue
            lib.astar_plan.restype = ctypes.c_int32
            lib.astar_plan.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_float,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            return lib
    return None


_NATIVE = _load_native()


def astar_grid(
    grid: np.ndarray,
    start: Tuple[int, int],
    goal: Tuple[int, int],
    occupancy_threshold: float = 0.8,
    connectivity: int = 8,
    occupancy_cost_factor: float = 3.0,
    use_native: Optional[bool] = None,
) -> List[Tuple[int, int]]:
    """Plan on a (H, W) occupancy-probability grid; returns [(x, y), ...]
    cell indices from start to goal (empty list if unreachable).

    Raises ValueError when start/goal are blocked (the reference raises a
    bare Exception, ``a_star.py:57-61``).
    """
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    h, w = grid.shape
    sx, sy = int(start[0]), int(start[1])
    gx, gy = int(goal[0]), int(goal[1])
    native = _NATIVE if use_native is None else (_NATIVE if use_native else None)
    if native is not None:
        max_len = h * w
        out = np.empty(2 * max_len, dtype=np.int32)
        n = native.astar_plan(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w, float(occupancy_threshold),
            sx, sy, gx, gy, connectivity, float(occupancy_cost_factor),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len,
        )
        if n == -2:
            raise ValueError("Start node is not traversable")
        if n == -3:
            raise ValueError("Goal node is not traversable")
        if n < 0:
            raise ValueError(f"astar_plan failed with code {n}")
        return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]
    return _astar_python(
        grid, (sx, sy), (gx, gy), occupancy_threshold, connectivity,
        occupancy_cost_factor,
    )


def _astar_python(grid, start, goal, occ_thr, connectivity, occ_cost):
    h, w = grid.shape

    def blocked(x, y):
        return grid[y, x] >= occ_thr

    if blocked(*start):
        raise ValueError("Start node is not traversable")
    if blocked(*goal):
        raise ValueError("Goal node is not traversable")

    s2 = math.sqrt(2.0)
    moves = [(1, 0, 1.0), (0, 1, 1.0), (-1, 0, 1.0), (0, -1, 1.0)]
    if connectivity == 8:
        moves += [(1, 1, s2), (-1, 1, s2), (-1, -1, s2), (1, -1, s2)]

    def heur(p):
        return math.hypot(p[0] - goal[0], p[1] - goal[1])

    front = [(heur(start), 0.0, start, start)]
    visited = set()
    came_from = {}
    found = False
    while front:
        _, g, pos, parent = heappop(front)
        if pos in visited:
            continue
        visited.add(pos)
        came_from[pos] = parent
        if pos == goal:
            found = True
            break
        for dx, dy, c in moves:
            nx2, ny2 = pos[0] + dx, pos[1] + dy
            if not (0 <= nx2 < w and 0 <= ny2 < h):
                continue
            npos = (nx2, ny2)
            if npos in visited or blocked(nx2, ny2):
                continue
            soft = float(grid[ny2, nx2]) * occ_cost
            ng = g + c + soft
            heappush(front, (ng + heur(npos) + soft, ng, npos, pos))
    if not found:
        return []
    path = []
    cur = goal
    while cur != start:
        path.append(cur)
        cur = came_from[cur]
    path.append(start)
    path.reverse()
    return path


def a_star(start_m, goal_m, gmap, movement: str = "8N", occupancy_cost_factor: float = 3.0):
    """Reference-compatible entry (``a_star.py:36``): start/goal in meters on
    an OccupancyGridMap; returns (path_meters, path_indices)."""
    start = gmap.get_index_from_coordinates(start_m[0], start_m[1])
    goal = gmap.get_index_from_coordinates(goal_m[0], goal_m[1])
    connectivity = 4 if movement == "4N" else 8
    path_idx = astar_grid(
        gmap.data, start, goal,
        occupancy_threshold=gmap.occupancy_threshold,
        connectivity=connectivity,
        occupancy_cost_factor=occupancy_cost_factor,
    )
    path_m = [gmap.get_coordinates_from_index(x, y) for x, y in path_idx]
    return path_m, path_idx
