"""One rank of the two-process port fleet (see test_torch_distributed.py).

Run by the test harness, not by pytest: ``python torch_distributed_worker.py
OUT_DIR [DEVICE]`` with the ``ROBOT_MPCS_*`` rendezvous variables set. Torch
only. Each rank joins a gloo group on DEVICE (the CPU by default; ``cuda:0``
puts both ranks on one card), steps its shard of the pointRobot
fleet (B=32 over 2 ranks, a rescue tier of 8 slots per shard, no kick), saves
a checkpoint from both ranks, loads the parent's world-1 checkpoint as its
shard, and writes what it saw to ``OUT_DIR/rank<r>.npz``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from robot_mpcs_tpu_torch import interop  # noqa: E402
from robot_mpcs_tpu_torch.config import Setup, point_robot_setup  # noqa: E402
from robot_mpcs_tpu_torch.models.problem import MpcProblem  # noqa: E402
from robot_mpcs_tpu_torch.parallel import distributed  # noqa: E402
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario  # noqa: E402
from robot_mpcs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from robot_mpcs_tpu_torch.utils.checkpoint import load_fleet_state, save_fleet_state  # noqa: E402

B = 32
STEPS = 3
SEED = 21
SAMPLER = dict(goal_box=((-2, -2, 0.05), (2, 2, 0.05)), obstacle_box=((-1, -1, 0.05), (1, 1, 0.05)))
RUNNER_KW = dict(compaction_ratio=2, kick_scale=0.0)


def last_flags(runner):
    """The merged exit flags of the runner's last step (its step program's carry)."""
    return runner._last_program.carry["exitflag"].cpu().numpy()


def main() -> None:
    torch.set_num_threads(1)
    out = sys.argv[1]
    device = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    assert distributed.initialize(backend="gloo", device=device), "rendezvous variables missing"
    mesh = make_mesh()
    assert mesh.world == 2 and distributed.process_count() == 2
    problem = MpcProblem(Setup.from_dict(point_robot_setup()))
    runner = FleetRunner(problem, B, mesh=mesh, **RUNNER_KW)
    flags, saved = [], {}
    scen = runner.shard_scenario(random_fleet_scenario(problem, B, seed=SEED, **SAMPLER))
    state = runner.init_state(scen)
    for i in range(STEPS):
        state, m = runner.step(state, scen)
        flags.append(last_flags(runner))
        for k, v in m._asdict().items():
            saved[f"m{i}_{k}"] = np.asarray(float(v))
        for k, v in interop.state_to_numpy(state).items():
            saved[f"s{i}_{k}"] = v
    saved["flags"] = np.stack(flags)
    save_fleet_state(os.path.join(out, "w2.npz"), state, extra={"world": 2}, mesh=mesh)
    loaded, extra = load_fleet_state(os.path.join(out, "w1.npz"), mesh=mesh, problem=problem,
                                     batch_size=B)
    assert extra == {"world": 1}, extra
    for k, v in interop.state_to_numpy(loaded).items():
        saved[f"w1_{k}"] = v
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **saved)
    distributed.shutdown()
    print(f"rank {mesh.rank} done", flush=True)


if __name__ == "__main__":
    main()
