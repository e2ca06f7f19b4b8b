"""One rank of the two-process port fleet (see test_torch_distributed.py).

Run by the test harness, not by pytest: ``python torch_distributed_worker.py
OUT_DIR [DEVICE] [RUNS]`` with the ``ROBOT_MPCS_*`` rendezvous variables set.
Torch only. Each rank joins a gloo group on DEVICE (the CPU by default;
``cuda:0`` puts both ranks on one card) and makes the runs RUNS names,
comma-separated (``plain`` by default):

* ``plain``: steps its shard of the pointRobot fleet (B=32 over 2 ranks, a
  rescue tier of 8 slots per shard, no kick), saves a checkpoint from both
  ranks, loads the parent's world-1 checkpoint (``OUT_DIR/w1.npz``) as its
  shard, and writes what it saw to ``OUT_DIR/rank<r>.npz``;
* ``kick``: steps its shard of the pointRobot fleet from ``KICK_SEED`` (B=32,
  the same tier) with the kick live (``kick_after=2``, ``kick_scale=1.0``),
  eagerly, so that each step's warm start before the noise can be read, and
  writes per step its state, metrics, kick flags and that unkicked shift to
  ``OUT_DIR/kick_rank<r>.npz``. ``KICK_SEED`` is a scenario in which lanes of
  both ranks are kicked within ``KICK_STEPS`` steps, at the same step.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from robot_mpcs_tpu_torch import interop  # noqa: E402
from robot_mpcs_tpu_torch.config import Setup, point_robot_setup  # noqa: E402
from robot_mpcs_tpu_torch.models.problem import MpcProblem  # noqa: E402
from robot_mpcs_tpu_torch.ops import riccati_packed as rp  # noqa: E402
from robot_mpcs_tpu_torch.parallel import distributed  # noqa: E402
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario  # noqa: E402
from robot_mpcs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from robot_mpcs_tpu_torch.solver import units  # noqa: E402
from robot_mpcs_tpu_torch.utils.checkpoint import load_fleet_state, save_fleet_state  # noqa: E402

B = 32
STEPS = 3
SEED = 21
SAMPLER = dict(goal_box=((-2, -2, 0.05), (2, 2, 0.05)), obstacle_box=((-1, -1, 0.05), (1, 1, 0.05)))
RUNNER_KW = dict(compaction_ratio=2, kick_scale=0.0)
KICK_SEED = 13
KICK_STEPS = 5
KICK_KW = dict(compaction_ratio=2, kick_after=2, kick_scale=1.0)


def last_flags(runner):
    """The merged exit flags of the runner's last step (its step program's carry)."""
    return runner._last_program.carry["exitflag"].cpu().numpy()


def plain_run(out, mesh, problem):
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


def kick_run(out, mesh, problem):
    runner = FleetRunner(problem, B, mesh=mesh, **KICK_KW)
    post_step, shifts = runner._post_step, []

    def recording_post_step(*args):
        result = post_step(*args)
        shifts.append((result[1].cpu().numpy(), result[-1].cpu().numpy()))  # (z_shift, kick)
        return result

    runner._post_step = recording_post_step
    scen = runner.shard_scenario(random_fleet_scenario(problem, B, seed=KICK_SEED, **SAMPLER))
    state = runner.init_state(scen)
    saved = {}
    rp.riccati_backward_packed.launches = 0
    with units._eager():
        for i in range(KICK_STEPS):
            state, m = runner.step(state, scen)
            for k, v in m._asdict().items():
                saved[f"m{i}_{k}"] = np.asarray(float(v))
            for k, v in interop.state_to_numpy(state).items():
                saved[f"s{i}_{k}"] = v
            saved[f"shift{i}"], saved[f"kick{i}"] = shifts[-1]
    saved["launches"] = np.asarray(rp.riccati_backward_packed.launches)
    np.savez(os.path.join(out, f"kick_rank{mesh.rank}.npz"), **saved)


def main() -> None:
    torch.set_num_threads(1)
    out = sys.argv[1]
    device = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    runs = sys.argv[3].split(",") if len(sys.argv) > 3 else ["plain"]
    assert set(runs) <= {"plain", "kick"}, runs
    assert distributed.initialize(backend="gloo", device=device), "rendezvous variables missing"
    mesh = make_mesh()
    assert mesh.world == 2 and distributed.process_count() == 2
    problem = MpcProblem(Setup.from_dict(point_robot_setup()))
    for name in runs:
        {"plain": plain_run, "kick": kick_run}[name](out, mesh, problem)
    distributed.shutdown()
    print(f"rank {mesh.rank} done", flush=True)


if __name__ == "__main__":
    main()
