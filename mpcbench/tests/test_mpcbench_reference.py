"""The plain float64 reference against the port on the CPU, at a tiny size:
kinematics, plant, constraint rows and stage cost agree on random inputs."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mpcbench import sampler
from mpcbench.reference.model import Robot

ROOT = Path(__file__).resolve().parents[2]


def _setup(name):
    from robot_mpcs_tpu_torch.config import Setup
    from robot_mpcs_tpu_torch.models.problem import MpcProblem

    cfg = json.loads((ROOT / "mpcbench" / "configs" / f"{name}.json").read_text())
    problem = MpcProblem(Setup.from_dict({k: cfg[k] for k in ("type", "mpc", "robot", "example", "solver")}))
    return cfg, Robot(cfg), problem


def _params(problem, cfg, tasks):
    """The tasks in the program's layout, as the fleet driver packs them."""
    from mpcbench.drivers.fleet import FleetDriver

    drv = FleetDriver.__new__(FleetDriver)
    drv.problem, drv.tasks, drv.cfg, drv.robot, drv.device = problem, tasks, cfg, Robot(cfg), torch.device("cpu")
    drv._pack_bank()
    return drv.pbank


@pytest.mark.parametrize("name", ["panda", "boxer"])
def test_reference_against_the_port(name):
    cfg, robot, problem = _setup(name)
    d = problem.dims
    assert (robot.n, robot.nx, robot.nu, robot.N) == (d.n, d.nx, d.nu, d.N)
    rng = np.random.default_rng(3)
    L = 5
    tasks = sampler.draw_tasks(cfg, robot, 7, [(i, 0) for i in range(L)])
    par = _params(problem, cfg, tasks)[:, None, :].expand(L, d.N, -1)
    X = torch.as_tensor(rng.uniform(-1, 1, (L, d.N, d.nx)), dtype=torch.float32)
    U = torch.as_tensor(rng.uniform(-3, 3, (L, d.N, d.nu)), dtype=torch.float32)
    z = torch.cat([X, U], -1)
    tk = sampler.task_tensors(tasks, np.arange(L), "cpu")
    X64, U64 = X.double(), U.double()
    # kinematics
    links = sorted(set(robot.collision_links) | {robot.end_link})
    P = robot.fk(X64[..., : d.n], links)
    for link in links:
        prog = problem.kin.fk_pos(X[..., : d.n], link)
        assert torch.allclose(prog.double(), P[link], atol=2e-6), link
    # plant
    assert torch.allclose(problem.dynamics(X, U).double(), robot.step(X64, U64), atol=2e-6)
    # constraint rows (the modules', in configuration order) and stage cost
    R, _ = robot.rows(X64, U64, tk)
    n_mod = problem.n_ineq
    assert torch.allclose(problem.stage_inequalities(z, par).double(), R[..., :n_mod], atol=5e-6)
    cost = robot.stage_cost(X64, U64, tk)
    assert torch.allclose(problem.stage_objective(z, par).double(), cost, rtol=1e-5, atol=1e-5)


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in sorted((ROOT / "mpcbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("robot_mpcs_tpu_torch", "robot_mpcs_tpu", "jax", "jaxlib"), (path, n)
