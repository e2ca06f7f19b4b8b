"""The PyTorch port stands alone: it imports with JAX and PyYAML blocked.

The machines that run the port on a GPU carry neither JAX nor PyYAML, so
every port module (and ``chip_smoke``, whose work is guarded by
``__main__``) must import without them, and ``panda_setup()`` must build the
panda problem without the YAML file.
"""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
import robot_mpcs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(robot_mpcs_tpu_torch.__path__, "robot_mpcs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from robot_mpcs_tpu_torch.config import Setup, panda_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
problem = MpcProblem(Setup.from_dict(panda_setup()))
assert problem.dims.nx == 14 and problem.dims.nu == 7 and problem.dims.N == 20
assert not any(m == "jax" or m.startswith(("jax.", "robot_mpcs_tpu.")) for m in sys.modules
               if sys.modules[m] is not None)
print(" ".join(names))
"""

#: the modules of the planner slice, each of which must be among them
SLICE_MODULES = [
    "planner.mpc_planner", "planner.visualizer", "sim.kinematic_sim",
    "perception.free_space_decomposition", "global_planner.astar", "global_planner.grid_map",
    "global_planner.global_planner", "utils.checkpoint", "utils.profiling",
]


def test_port_imports_without_jax_and_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=ROOT,
        capture_output=True,
        text=True,
        env={**os.environ, "PYTHONPATH": ROOT},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 25  # every port module
    for m in SLICE_MODULES:
        assert f"robot_mpcs_tpu_torch.{m}" in names, m


def test_port_source_never_imports_jax():
    pkg = os.path.join(ROOT, "robot_mpcs_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax")), (f, s)
                        assert "robot_mpcs_tpu." not in s or not s.startswith(("import", "from")), (f, s)
