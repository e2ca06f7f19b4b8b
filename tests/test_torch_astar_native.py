"""The port's native A* path: ``native/astar.cpp`` built with g++ and bound by
``robot_mpcs_tpu_torch/global_planner/astar.py``.

The library is compiled into a temporary directory (the repository's own
``native/libastar.so`` is not built by the tests), the binding's library
paths are pointed at it and ``_load_native()`` loads it. Its paths are held
to the port's pure-Python fallback and to the JAX package's fallback on the
same grids: equal path costs (1e-4, the bar of
``tests/test_global_planner.py``), the same endpoints, no occupied cell, and
the same errors.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from robot_mpcs_tpu.global_planner.astar import astar_grid as jax_astar_grid
from robot_mpcs_tpu_torch.global_planner import astar
from robot_mpcs_tpu_torch.global_planner.grid_map import OccupancyGridMap

SOURCE = Path(__file__).resolve().parents[1] / "native" / "astar.cpp"


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/astar.cpp")
    lib = tmp_path_factory.mktemp("astar") / "libastar.so"
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(lib), str(SOURCE)],
        check=True, capture_output=True, text=True,
    )
    return lib


@pytest.fixture
def native(native_lib, monkeypatch):
    monkeypatch.setattr(astar, "_LIB_PATHS", [str(native_lib)])
    lib = astar._load_native()
    assert lib is not None
    monkeypatch.setattr(astar, "_NATIVE", lib)
    return lib


def _wall_grid():
    """10x10 grid with a vertical wall at x=5, gap at y=8."""
    grid = np.zeros((10, 10), np.float32)
    grid[:, 5] = 1.0
    grid[8, 5] = 0.0
    return grid


def _cost(grid, path, factor=3.0):
    return sum(np.hypot(x1 - x0, y1 - y0) + grid[y1, x1] * factor
               for (x0, y0), (x1, y1) in zip(path, path[1:]))


def _random_grid(seed, size=32):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.0, 0.5, size=(size, size)).astype(np.float32)
    grid[rng.uniform(size=(size, size)) < 0.25] = 1.0
    grid[1, 1] = grid[size - 2, size - 2] = 0.0
    return grid


def test_load_native_finds_the_built_library(native, native_lib, monkeypatch):
    monkeypatch.setattr(astar, "_LIB_PATHS", [str(native_lib.parent / "absent.so")])
    assert astar._load_native() is None


def test_native_path_crosses_the_gap(native):
    grid = _wall_grid()
    path = astar.astar_grid(grid, (1, 1), (9, 1))
    assert path[0] == (1, 1) and path[-1] == (9, 1) and (5, 8) in path
    assert all(grid[y, x] < 0.8 for x, y in path)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_python_and_jax_fallbacks(native, seed, connectivity):
    grid = _random_grid(seed)
    start, goal = (1, 1), (30, 30)
    kw = dict(connectivity=connectivity)
    p_native = astar.astar_grid(grid, start, goal, use_native=True, **kw)
    p_python = astar.astar_grid(grid, start, goal, use_native=False, **kw)
    p_jax = jax_astar_grid(grid, start, goal, use_native=False, **kw)
    assert p_python == p_jax
    if not p_python:
        assert p_native == []
        return
    assert p_native[0] == start and p_native[-1] == goal
    assert all(grid[y, x] < 0.8 for x, y in p_native)
    steps = {abs(x1 - x0) + abs(y1 - y0) for (x0, y0), (x1, y1) in zip(p_native, p_native[1:])}
    assert steps <= ({1} if connectivity == 4 else {1, 2})
    assert abs(_cost(grid, p_native) - _cost(grid, p_python)) < 1e-4


def test_native_unreachable_and_blocked_endpoints(native):
    grid = np.zeros((10, 10), np.float32)
    grid[:, 5] = 1.0  # full wall
    assert astar.astar_grid(grid, (1, 1), (9, 1)) == []
    with pytest.raises(ValueError, match="Start node"):
        astar.astar_grid(grid, (5, 1), (9, 1))
    with pytest.raises(ValueError, match="Goal node"):
        astar.astar_grid(grid, (1, 1), (5, 3))


def test_a_star_meters_wrapper_native_equals_fallback(native, monkeypatch):
    gmap = OccupancyGridMap(_wall_grid(), cell_size=0.5)
    native_m, native_idx = astar.a_star((0.5, 0.5), (4.5, 0.5), gmap)
    monkeypatch.setattr(astar, "_NATIVE", None)
    python_m, python_idx = astar.a_star((0.5, 0.5), (4.5, 0.5), gmap)
    assert native_idx[0] == python_idx[0] and native_idx[-1] == python_idx[-1]
    assert abs(_cost(gmap.data, native_idx) - _cost(gmap.data, python_idx)) < 1e-4
    assert len(native_m) == len(native_idx)
