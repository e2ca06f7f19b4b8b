"""The port's sharded fleet over ``torch.distributed``, against world-1 runs
and the JAX package.

Two OS processes (``tests/torch_distributed_worker.py``, torch only) join a
gloo group on the CPU through the ``ROBOT_MPCS_*`` variables and step the
pointRobot fleet at B=32 (16 lanes per rank, a rescue tier of 8 slots per
shard, no kick) for 3 steps; in the same processes, after that run, they
step another pointRobot fleet at B=32 with the kick live (``kick_after=2``,
``kick_scale=1.0``) for 5 steps. Tolerances, and why:

* the ranks' metrics: identical, since both hold the result of the same
  two all-reduces;
* each rank's shard against a world-1 port runner on its half: exit flags
  and integer fields equal, floats within 1e-6 (the same ops on the same
  data; only the metric reductions cross ranks);
* the concatenated shards against the JAX ``FleetRunner`` on a 2-device
  mesh: the per-step bars of ``tests/test_torch_fleet.py`` (converged
  fraction within 2/B, mean goal distance within 2%, converged violation
  <= 1e-4, plant state within 1e-3);
* checkpoints: exact, since they are copies;
* the kicked run against the JAX ``FleetRunner`` on a 2-device mesh, whose
  step folds the kick's key on its ``axis_index``
  (``robot_mpcs_tpu/parallel/fleet.py:449-459``): the same lanes kicked on
  each rank (from the same input; in the two runs where the reference
  determines the lane); rank r's kicked lanes carry
  ``jax.random.normal(fold_in(fold_in(PRNGKey(0x5EED), t), r), ...)`` within
  1e-5 (``tests/test_torch_fleet_kick.py``'s bar), and rank 1's noise is
  not rank 0's draw; metrics within 2/B and 2%; plant states within 1e-3 by
  ``torch_fleet_parity.hold_states`` (at most 2 lanes a step the reference
  does not determine).
"""

import os
import socket
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from robot_mpcs_tpu.config import Setup as JaxSetup
from robot_mpcs_tpu.models.problem import MpcProblem as JaxProblem
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.fleet import random_fleet_scenario as jax_scenario
from robot_mpcs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from robot_mpcs_tpu.parallel.mesh import pad_batch_to_mesh as jax_pad
from robot_mpcs_tpu.parallel.mesh import shard_batch as jax_shard
from robot_mpcs_tpu.utils.checkpoint import load_fleet_state as jax_load
from robot_mpcs_tpu_torch import interop
from robot_mpcs_tpu_torch.config import Setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.parallel import distributed
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, FleetScenario, random_fleet_scenario
from robot_mpcs_tpu_torch.parallel.fleet_group import FleetGroup
from robot_mpcs_tpu_torch.parallel.mesh import (
    Mesh,
    gather_batch,
    make_mesh,
    pad_batch_to_mesh,
    shard_batch,
)
from robot_mpcs_tpu_torch.utils.checkpoint import load_fleet_state, save_fleet_state

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_distributed_worker as worker  # noqa: E402
from torch_bench_window import jax_fleet, kicked  # noqa: E402
from torch_fleet_parity import determined_lanes, hold_metrics, hold_states, kick_draw  # noqa: E402

B, STEPS, HALF = worker.B, worker.STEPS, worker.B // 2
STATE = ("x", "z_warm", "lam", "step", "stall", "best_gdist", "no_improve")
ENV = ("ROBOT_MPCS_COORDINATOR", "ROBOT_MPCS_NUM_PROCESSES", "ROBOT_MPCS_PROCESS_ID",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def problem():
    return MpcProblem(Setup.from_dict(point_robot_setup()))


@pytest.fixture(scope="module")
def scenario(problem):
    return random_fleet_scenario(problem, B, seed=worker.SEED, **worker.SAMPLER)


@pytest.fixture(scope="module")
def two_ranks(problem, scenario, tmp_path_factory):
    """Run the two ranks; returns the output directory, each rank's record
    and the world-1 state the ranks loaded as shards."""
    out = tmp_path_factory.mktemp("torch_dist")
    w1, _ = FleetRunner(problem, B, device="cpu", **worker.RUNNER_KW).run(scenario, 1)
    save_fleet_state(str(out / "w1.npz"), w1, extra={"world": 1})
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(ROBOT_MPCS_COORDINATOR=f"127.0.0.1:{port}", ROBOT_MPCS_NUM_PROCESSES="2",
               PYTHONPATH=os.path.dirname(HERE))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_distributed_worker.py"), str(out), "cpu",
             "plain,kick"],
            env=dict(env, ROBOT_MPCS_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as data:
            ranks.append({k: data[k] for k in data.files})
    return out, ranks, interop.state_to_numpy(w1)


def _metrics(rank, i):
    prefix = f"m{i}_"
    return {k[len(prefix):]: float(v) for k, v in rank.items() if k.startswith(prefix)}


def _whole(ranks, key):
    return np.concatenate([r[key] for r in ranks]) if ranks[0][key].ndim else ranks[0][key]


def test_ranks_report_identical_metrics(two_ranks):
    _, ranks, _ = two_ranks
    for i in range(STEPS):
        m0, m1 = _metrics(ranks[0], i), _metrics(ranks[1], i)
        assert m0 == m1 and len(m0) == 11, (i, m0, m1)
        assert all(np.isfinite(v) for v in m0.values())


@pytest.mark.parametrize("rank", [0, 1])
def test_each_shard_equals_a_world1_half(problem, scenario, two_ranks, rank):
    _, ranks, _ = two_ranks
    rows = slice(rank * HALF, (rank + 1) * HALF)
    runner = FleetRunner(problem, HALF, device="cpu", **worker.RUNNER_KW)
    flags = []
    scen = FleetScenario(scenario.xinit[rows], scenario.params[rows])
    state = runner.init_state(scen)
    for i in range(STEPS):
        state, _ = runner.step(state, scen)
        flags.append(worker.last_flags(runner))
        got = interop.state_to_numpy(state)
        for k in STATE:
            want = ranks[rank][f"s{i}_{k}"]
            if got[k].dtype == np.int32:
                np.testing.assert_array_equal(want, got[k], err_msg=f"step {i} {k}")
            else:
                np.testing.assert_allclose(want, got[k], rtol=0, atol=1e-6, err_msg=f"step {i} {k}")
    np.testing.assert_array_equal(ranks[rank]["flags"], np.stack(flags))


def test_shards_match_the_jax_fleet_on_two_devices(two_ranks):
    _, ranks, _ = two_ranks
    jp = JaxProblem(JaxSetup.from_dict(point_robot_setup()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scen = jax_scenario(jp, B, seed=worker.SEED, **worker.SAMPLER)
    runner = JaxRunner(jp, B, mesh=jax_make_mesh(devices=jax.devices()[:2]), **worker.RUNNER_KW)
    sc = runner.shard_scenario(scen)
    state = runner.init_state(sc)
    for i in range(STEPS):
        state, m = runner.step(state, sc)
        mj = {k: float(v) for k, v in m._asdict().items()}
        mt = _metrics(ranks[0], i)
        assert abs(mt["converged_fraction"] - mj["converged_fraction"]) <= 2 / B + 1e-6, (i, mt, mj)
        assert abs(mt["mean_goal_distance"] - mj["mean_goal_distance"]) <= 0.02 * mj["mean_goal_distance"]
        assert mt["max_violation_converged"] <= 1e-4
        x_j = np.asarray(state.x)  # copied now: the next step donates it
    assert int(_whole(ranks, f"s{STEPS - 1}_step")) == STEPS
    np.testing.assert_allclose(_whole(ranks, f"s{STEPS - 1}_x"), x_j, atol=1e-3)


def test_world2_checkpoint_resumes_at_world1(problem, two_ranks):
    out, ranks, _ = two_ranks
    state, extra = load_fleet_state(str(out / "w2.npz"), problem=problem, batch_size=B, device="cpu")
    assert extra == {"world": 2}
    got = interop.state_to_numpy(state)
    for k in STATE:
        np.testing.assert_array_equal(got[k], _whole(ranks, f"s{STEPS - 1}_{k}"), err_msg=k)


def test_world1_checkpoint_resumes_at_world2(two_ranks):
    _, ranks, w1 = two_ranks
    for r, rank in enumerate(ranks):
        rows = slice(r * HALF, (r + 1) * HALF)
        for k in STATE:
            want = w1[k] if w1[k].ndim == 0 else w1[k][rows]
            np.testing.assert_array_equal(rank[f"w1_{k}"], want, err_msg=f"rank {r} {k}")


def test_port_checkpoint_loads_in_jax(two_ranks):
    out, ranks, _ = two_ranks
    state, extra = jax_load(str(out / "w2.npz"), batch_size=B)
    assert extra == {"world": 2}
    for k in STATE:
        got = np.asarray(getattr(state, k))
        want = _whole(ranks, f"s{STEPS - 1}_{k}")
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.fixture(scope="module")
def kicked_ranks(two_ranks):
    """The kicked run of the two ranks: per rank its record."""
    out = two_ranks[0]
    ranks = []
    for r in range(2):
        with np.load(out / f"kick_rank{r}.npz") as data:
            ranks.append({k: data[k] for k in data.files})
    return ranks


@pytest.fixture(scope="module")
def jax_kicked(kicked_ranks):
    """The JAX fleet on a 2-device mesh with the kick: its states and metrics
    per step, and its step from each of the port's (whole-batch) states."""
    jp = JaxProblem(JaxSetup.from_dict(point_robot_setup()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scen = jax_scenario(jp, B, seed=worker.KICK_SEED, **worker.SAMPLER)
    state, step = jax_fleet(jp, B, scen, n_devices=2, **worker.KICK_KW)
    states, metrics = [state], []
    for _ in range(worker.KICK_STEPS):
        state, m = step(worker.KICK_KW, state)
        states.append(state)
        metrics.append(m)
    port = [states[0]] + [{k: _whole(kicked_ranks, f"s{i}_{k}") for k in STATE}
                          for i in range(worker.KICK_STEPS)]
    return dict(states=states, metrics=metrics, port=port,
                from_port=[step(worker.KICK_KW, s)[0] for s in port[:-1]])


def test_kicked_ranks_report_identical_metrics(kicked_ranks):
    for i in range(worker.KICK_STEPS):
        m0, m1 = _metrics(kicked_ranks[0], i), _metrics(kicked_ranks[1], i)
        assert m0 == m1 and len(m0) == 11, (i, m0, m1)
        assert all(np.isfinite(v) for v in m0.values())


def test_kicked_shards_kick_the_jax_lanes(kicked_ranks, jax_kicked):
    per_rank = [0, 0]
    for t in range(worker.KICK_STEPS):
        prev, new = jax_kicked["port"][t], jax_kicked["port"][t + 1]
        kt = kicked(prev, new, worker.KICK_KW["kick_after"])
        flags = _whole(kicked_ranks, f"kick{t}")
        np.testing.assert_array_equal(kt, flags)  # the port's own flags are what its states show
        ks = kicked(prev, jax_kicked["from_port"][t], worker.KICK_KW["kick_after"])
        kj = kicked(jax_kicked["states"][t], jax_kicked["states"][t + 1], worker.KICK_KW["kick_after"])
        same = determined_lanes(prev, jax_kicked["states"][t], jax_kicked["states"][t + 1],
                                jax_kicked["from_port"][t])
        print(f"step {t}: kicked on rank 0 {np.flatnonzero(kt[:HALF]).tolist()}, rank 1 "
              f"{np.flatnonzero(kt[HALF:]).tolist()} (local lanes); the JAX run "
              f"{np.flatnonzero(kj).tolist()}, JAX from the port's state {np.flatnonzero(ks).tolist()}")
        np.testing.assert_array_equal(ks, kt)
        np.testing.assert_array_equal(kj[same], kt[same])
        per_rank[0] += int(kt[:HALF].sum())
        per_rank[1] += int(kt[HALF:].sum())
    assert min(per_rank) >= 1, per_rank


def test_kicked_shards_draw_on_their_rank(problem, kicked_ranks, jax_kicked):
    nx = problem.dims.nx
    checked = [0, 0]
    for t in range(worker.KICK_STEPS):
        for r, rank in enumerate(kicked_ranks):
            z_shift, kick = rank[f"shift{t}"], rank[f"kick{t}"]
            if not kick.any():
                continue
            want = kick_draw(t, r, z_shift[..., nx:].shape)
            got = rank[f"s{t}_z_warm"][..., nx:] - z_shift[..., nx:]
            err = float(np.abs(got[kick] - want[kick]).max())
            assert np.array_equal(got[~kick], np.zeros_like(got[~kick]))  # no noise elsewhere
            # the JAX fleet's stages N-2 and N-1 both shift its last solved
            # stage: their difference is the draws' difference, on its rank's lanes
            rows = slice(r * HALF, (r + 1) * HALF)
            z = jax_kicked["from_port"][t]["z_warm"][rows, :, nx:]
            err_jax = float(np.abs((z[:, -1] - z[:, -2])[kick] - (want[:, -1] - want[:, -2])[kick]).max())
            other = kick_draw(t, 1 - r, z_shift[..., nx:].shape)
            off = float(np.abs(got[kick] - other[kick]).max())
            print(f"step {t} rank {r}: {int(kick.sum())} kicked lanes; noise vs the draw folded on {r} "
                  f"{err:.3e} (JAX fleet's stage difference {err_jax:.3e}), vs the draw folded on "
                  f"{1 - r} {off:.3e}")
            assert max(err, err_jax) <= 1e-5, (t, r, err, err_jax)
            assert off > 1e-2, (t, r, off)  # rank r's noise is its own
            checked[r] += int(kick.sum())
    assert min(checked) >= 1, checked


def test_kicked_shards_match_the_jax_fleet_on_two_devices(kicked_ranks, jax_kicked):
    for t in range(worker.KICK_STEPS):
        hold_metrics(t, _metrics(kicked_ranks[0], t), jax_kicked["metrics"][t], B)
        _, line = hold_states(t, jax_kicked["port"][t], jax_kicked["port"][t + 1], jax_kicked["states"][t],
                              jax_kicked["states"][t + 1], jax_kicked["from_port"][t])
        print(line)
    assert int(jax_kicked["port"][-1]["step"]) == worker.KICK_STEPS


def test_initialize_without_variables_is_single_process(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert distributed.process_count() == 1
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)


def test_rendezvous_variable_precedence(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "3")
    assert distributed._rendezvous(None, None, None) == ("10.0.0.2:29500", 8, 3)
    # the JAX package's variables come first
    monkeypatch.setenv("ROBOT_MPCS_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("ROBOT_MPCS_NUM_PROCESSES", "2")
    monkeypatch.setenv("ROBOT_MPCS_PROCESS_ID", "1")
    assert distributed._rendezvous(None, None, None) == ("10.0.0.1:1234", 2, 1)
    # and arguments before both
    assert distributed._rendezvous("h:1", 4, 0) == ("h:1", 4, 0)
    monkeypatch.delenv("ROBOT_MPCS_PROCESS_ID")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="process's id"):
        distributed._rendezvous(None, None, None)


def test_torchrun_variables_join_a_group():
    """Two processes given only torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) join one gloo
    group, pass the start-up barrier and see a mesh of world 2."""
    script = (
        "from robot_mpcs_tpu_torch.parallel import distributed, make_mesh\n"
        "assert distributed.initialize(device='cpu')\n"
        "mesh = make_mesh()\n"
        "print(mesh.world, mesh.rank, distributed.process_count(), flush=True)\n"
        "distributed.shutdown()\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               PYTHONPATH=os.path.dirname(HERE))
    procs = [
        subprocess.Popen([sys.executable, "-c", script],
                         env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["2", str(r), "2"]


def test_rank_device_never_drops_to_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the rank has a card")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed._rank_device(None, 0)
    assert distributed._rank_device("cpu", 0) == torch.device("cpu")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_and_padding_match_jax(world):
    mesh_j = jax_make_mesh(devices=jax.devices()[:world])
    full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    sharded = jax_shard(mesh_j, {"a": full, "b": full[:, 0].astype(np.int32)})
    for r, dev in enumerate(jax.devices()[:world]):
        mesh = Mesh(world, r, torch.device("cpu"))
        got = shard_batch(mesh, {"a": full, "b": full[:, 0].astype(np.int32), "step": np.int32(3)})
        for k in ("a", "b"):
            (want,) = [s.data for s in sharded[k].addressable_shards if s.device == dev]
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
            assert got[k].numpy().dtype == np.asarray(want).dtype
        assert int(got["step"]) == 3
    for b in (1, 5, 8, 31, 64):
        assert pad_batch_to_mesh(b, Mesh(world, 0, torch.device("cpu"))) == jax_pad(b, mesh_j)
    # a batch the mesh does not divide is refused, as by the JAX runner
    if world > 1:
        with pytest.raises(ValueError, match="not divisible"):
            shard_batch(Mesh(world, 0, torch.device("cpu")), np.zeros((world + 1, 2)))


def test_gather_batch_without_a_group_is_local():
    mesh = Mesh(1, 0, torch.device("cpu"))
    tree = {"x": torch.arange(6.0).reshape(3, 2), "step": torch.tensor(2)}
    got = gather_batch(mesh, tree)
    np.testing.assert_array_equal(got["x"], tree["x"].numpy())
    assert int(got["step"]) == 2


def test_mesh_runner_checks_batch_and_takes_tiers_from_the_shard(problem):
    with pytest.raises(ValueError, match="not divisible"):
        FleetRunner(problem, 30, mesh=Mesh(4, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="mesh"):
        FleetRunner(problem, 32, device="meta", mesh=Mesh(2, 0, torch.device("cpu")))
    # one 1/8 tier: 128 lanes give 16 slots at world 1, 8 per rank at world 2
    assert FleetRunner(problem, 128, device="cpu")._tiers[0][0] == 16
    assert FleetRunner(problem, 128, mesh=Mesh(2, 1, torch.device("cpu")))._tiers[0][0] == 8
    with pytest.warns(UserWarning, match="per-rank batch 32 yields 4"):
        runner = FleetRunner(problem, 128, mesh=Mesh(4, 0, torch.device("cpu")))
    assert runner._tiers == []
    group = FleetGroup({"pointRobot": (problem, 64)}, mesh=Mesh(2, 1, torch.device("cpu")),
                       compaction_ratio=2)
    scen = group.shard_scenarios({"pointRobot": random_fleet_scenario(problem, 64, seed=0)})
    assert scen["pointRobot"].xinit.shape == (32, problem.dims.nx)


def test_interop_defaults_to_cuda():
    """The interop helpers land on the card unless told otherwise; without
    CUDA they raise instead of returning CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable here")
    x, p = np.zeros((2, 3), np.float32), np.zeros((2, 4, 5), np.float32)
    calls = [
        lambda: interop.scenario_from_numpy(x, p),
        lambda: interop.state_from_numpy({k: np.zeros((2,)) for k in STATE}),
        lambda: interop.solver_inputs_from_numpy(x, p, p, p),
        lambda: make_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert interop.scenario_from_numpy(x, p, device="cpu").xinit.device.type == "cpu"
