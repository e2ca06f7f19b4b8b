"""The port's benchmark (``robot_mpcs_tpu_torch/bench.py``) on the CPU,
against ``bench.py``'s output contract, configuration and metrics.

The command-line runs are separate processes, started together when the
first test asks for them and read by the tests that check them: the
contract run (JAX, PyYAML and both packages' root scripts blocked), a run
out of time budget, a run asking for CUDA, and two gloo ranks. One run in
this process, with an extra made to raise, gives the headline that the
metrics parity test holds against a JAX ``FleetRunner`` stepped as often.

Tolerances, and why:

* scenarios: 1e-6, the bar of ``tests/test_torch_fleet.py`` (the same
  numpy draws; FK in float32 in both packages);
* metrics after the same number of steps from the same scenario: the bars
  of ``tests/test_torch_fleet.py::test_fleet_matches_jax`` (converged
  fraction within 2/B, two lanes' exit flags flipped by f32 sums taken in
  another order; mean goal distance within 2%; converged lanes feasible to
  the solver's tol_constraint 1e-4). Both runners use ``bench.py``'s
  defaults: at B=32 the 1/8 rescue tier has 4 < 8 slots and is off in both,
  and the kick cannot fire within 25 steps (where it fires, both packages
  draw the same noise: ``tests/test_torch_fleet_kick.py``).
"""

import ast
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import bench
from robot_mpcs_tpu.parallel.fleet import FleetRunner as JaxRunner
from robot_mpcs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from robot_mpcs_tpu_torch import bench as tbench

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
SMALL = dict(BENCH_BATCH=str(B), BENCH_STEPS="2", BENCH_WARMUP_MAX="3")
EXTRAS_OFF = dict(BENCH_LATENCY="0", BENCH_MULTICLASS="0")
RENDEZVOUS = ("ROBOT_MPCS_COORDINATOR", "ROBOT_MPCS_NUM_PROCESSES", "ROBOT_MPCS_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _bench_py_extra_keys():
    """The literal keys of ``bench.py``'s headline ``extra`` dict (its
    ``result``), read from its source: bench.py imports JAX and runs on a TPU."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "extra":
                    return {k.value for k in value.keys if isinstance(k, ast.Constant)}
    raise AssertionError("bench.py has no 'extra' dict")


#: ``bench.py``'s ``extra`` fields (its ``vs_baseline``, which the port
#: leaves out, sits beside ``extra``) and its warm-up notes, plus the port's
#: ``device`` and ``riccati_launches``; the two warm-up flags appear only
#: when set
EXTRA_KEYS = _bench_py_extra_keys() | {"warmup_steps", "warmup_s", "device", "riccati_launches"}
OPTIONAL_KEYS = {"warmup_truncated", "remeasured"}
HEADLINE_KEYS = {"metric", "value", "unit", "extra"}
#: runs the port's bench as ``python -m`` does, with JAX, PyYAML, the JAX
#: package and the two root scripts made unimportable
_BLOCKED_MAIN = r"""
import runpy, sys
for name in ("jax", "yaml", "robot_mpcs_tpu", "bench", "chip_smoke"):
    sys.modules[name] = None
sys.argv = ["bench"] + sys.argv[1:]
runpy.run_module("robot_mpcs_tpu_torch.bench", run_name="__main__", alter_sys=True)
"""

#: one rank of a two-rank run: the port's bench with the same modules
#: blocked, its ``SLOW_CALL``-th fleet step held 2 s after the step's
#: collectives (only this rank's clock sees it), its ``FAIL_CLASS`` set-up
#: made to raise, and each warm-up's notes written to stderr
_RANK_MAIN = r"""
import json, os, sys, time
for name in ("jax", "yaml", "robot_mpcs_tpu", "bench", "chip_smoke"):
    sys.modules[name] = None
from robot_mpcs_tpu_torch import bench
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner

slow_call, fail_class, calls = int(os.environ.get("SLOW_CALL", "0")), os.environ.get("FAIL_CLASS"), [0]
step, warm, load = FleetRunner.step, bench._warm_and_measure, bench._load_problem

def slow_step(self, state, scenario):
    out = step(self, state, scenario)
    calls[0] += 1
    if calls[0] == slow_call:
        time.sleep(2.0)
    return out

def noted_warm(runner, state, scenario, steps, warmup_max, note, **kw):
    out = warm(runner, state, scenario, steps, warmup_max, note, **kw)
    print("NOTE " + json.dumps(note), file=sys.stderr, flush=True)
    return out

def failing_load(name):
    if name == fail_class:
        raise RuntimeError(f"injected {name} set-up failure")
    return load(name)

FleetRunner.step = slow_step
bench._warm_and_measure, bench._load_problem = noted_warm, failing_load
sys.exit(bench.main(sys.argv[1:]))
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            out.append(obj)
    return out


class _Run:
    """A bench process started now and read once: (exit code, stdout, stderr)."""

    def __init__(self, args, env, script=_BLOCKED_MAIN):
        base = {k: v for k, v in os.environ.items() if k not in RENDEZVOUS}
        base.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, *args], cwd=ROOT, env={**base, **env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        self._out = None

    def result(self, timeout=300):
        if self._out is None:
            out, err = self.proc.communicate(timeout=timeout)
            self._out = (self.proc.returncode, out, err)
        return self._out


@pytest.fixture(scope="module")
def runs():
    """Every command-line run of this file, started at once. Of each pair of
    ranks, rank 1 is the odd one: its third warm step is slow in the first
    pair, and its pointRobot set-up raises in the second."""
    def ranks(pair, env, rank1_env):
        rendezvous = dict(ROBOT_MPCS_COORDINATOR=f"127.0.0.1:{_free_port()}",
                          ROBOT_MPCS_NUM_PROCESSES="2")
        return {
            f"{pair}{r}": _Run(["--device", "cpu"],
                               {**env, **rendezvous, "ROBOT_MPCS_PROCESS_ID": str(r),
                                **(rank1_env if r else {})}, script=_RANK_MAIN)
            for r in (0, 1)
        }

    started = {
        "contract": _Run(["--device", "cpu"], {**SMALL, **EXTRAS_OFF}),
        "budget": _Run(["--device", "cpu"], dict(SMALL, BENCH_STEPS="1", BENCH_TIME_BUDGET="1")),
        "cuda": _Run([], SMALL),
        **ranks("rank", {**SMALL, **EXTRAS_OFF, "BENCH_WARMUP_MAX": "6"}, {"SLOW_CALL": "3"}),
        **ranks("failing", {**SMALL, "BENCH_STEPS": "1", "BENCH_LATENCY": "0",
                            "BENCH_TIME_BUDGET": "100000"}, {"FAIL_CLASS": "pointRobot"}),
    }
    yield started
    for run in started.values():
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.communicate()


@pytest.fixture(scope="module")
def raised_extra(runs):
    """The bench run in this process with its latency extra raising: (exit
    code, JSON lines)."""
    def boom(*args, **kwargs):
        raise RuntimeError("injected latency failure")

    env = {**SMALL, "BENCH_LATENCY": "1", "BENCH_MULTICLASS": "0", "BENCH_TIME_BUDGET": "100000"}
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in RENDEZVOUS:
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(tbench, "measure_latency", boom)
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = tbench.main(["--device", "cpu"])
    return rc, _json_lines(out.getvalue())


def _check_headline(line):
    assert set(line) == HEADLINE_KEYS
    assert line["metric"] == "panda_H20_mpc_solves_per_s_per_chip"
    assert line["unit"] == "solves/s/chip"
    extra = line["extra"]
    assert EXTRA_KEYS <= set(extra) <= EXTRA_KEYS | OPTIONAL_KEYS, set(extra) ^ EXTRA_KEYS
    assert extra["device"] == "cpu"
    # the CPU runs the plain versions: no kernel launch is counted
    assert extra["riccati_launches"] == {
        "riccati_backward_packed": {"panda": 0}, "riccati_backward_batched": {"panda": 0},
        "fk_walk": {"panda": 0}, "gn_assemble": {"panda": 0},
    }
    assert all(np.isfinite(v) for v in extra.values() if isinstance(v, float))
    assert extra["max_violation_converged"] <= 1e-4


def test_raised_extra_fails_after_headline_and_enriched_line(raised_extra):
    rc, lines = raised_extra
    assert rc != 0
    assert len(lines) == 2
    head, last = lines
    _check_headline(head)
    assert "latency_error" not in head["extra"]
    assert "injected latency failure" in last["extra"]["latency_error"]
    assert "bench_wall_s" in last["extra"]


def test_class_specs_equal_bench():
    assert tbench.CLASS_SPECS == bench.CLASS_SPECS


def test_headline_fields_are_bench_py_fields():
    """The list that ``chip_smoke.py`` checks the child's line against."""
    assert "vs_baseline" not in EXTRA_KEYS and "converged_fraction" in EXTRA_KEYS
    assert len(tbench.HEADLINE_FIELDS) == len(EXTRA_KEYS)
    assert set(tbench.HEADLINE_FIELDS) == EXTRA_KEYS
    assert not set(tbench.EXTRA_FIELDS) & EXTRA_KEYS


@pytest.mark.parametrize("name", ["panda", "pointRobot", "boxer"])
def test_setup_and_scenario_equal_bench(name):
    jp, jsetup = bench._load_problem(name)
    tp, tsetup = tbench._load_problem(name)
    want = jsetup.to_dict()
    # the port leaves out two solver settings (tests/test_torch_models.py)
    assert want["solver"].pop("dtype") == "float32"
    want["solver"].pop("psd_projection")
    assert tsetup.to_dict() == want
    js = bench._scenario_for(jp, B, name, seed=0)
    ts = tbench._scenario_for(tp, B, name, seed=0)
    np.testing.assert_allclose(ts.xinit.numpy(), np.asarray(js.xinit), atol=1e-6)
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params), atol=1e-6)


def test_panda_override_is_a_noop():
    """``panda_setup()`` already carries bench.py's ``wconstr``."""
    _, setup = tbench._load_problem("panda")
    assert setup.mpc.weights == tbench._SETUPS["panda"]()["mpc"]["weights"]


def test_metrics_match_jax_over_the_same_window(raised_extra):
    rc, lines = raised_extra
    got = lines[0]["extra"]
    n_steps = got["warmup_steps"] + got["steps"] * (2 if got.get("remeasured") else 1)
    problem, _ = bench._load_problem("panda")
    mesh = jax_make_mesh(devices=jax.devices()[:1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = JaxRunner(problem, B, mesh=mesh)  # bench.py's defaults
    scen = runner.shard_scenario(bench._scenario_for(problem, B, "panda"))
    state = runner.init_state(scen)
    # the step counter as the step returns it (replicated), so that the
    # second step does not compile the fleet program again
    state = state._replace(step=jax.device_put(state.step, NamedSharding(mesh, PartitionSpec())))
    for _ in range(n_steps):
        state, m = runner.step(state, scen)
    want = {k: float(v) for k, v in m._asdict().items()}
    for k in ("mean_iterations", "reset_fraction", "rescue_overflow_fraction"):
        print(f"{k}: port {got[k]}, JAX {want[k]}")
    assert abs(got["converged_fraction"] - want["converged_fraction"]) <= 2 / B + 1e-6
    assert abs(got["mean_goal_distance"] - want["mean_goal_distance"]) <= (
        0.02 * want["mean_goal_distance"]
    )
    assert got["max_violation_converged"] <= 1e-4


def test_contract_two_lines_without_jax_or_yaml(runs):
    rc, out, err = runs["contract"].result()
    assert rc == 0, err
    lines = _json_lines(out)
    assert len(lines) == 2, out
    head, last = lines
    _check_headline(head)
    assert head["extra"]["batch"] == B and head["extra"]["steps"] == 2
    assert head["extra"]["n_chips"] == 1
    assert head["extra"]["warmup_steps"] == 3
    assert head["value"] == head["extra"]["total_solves_per_s"]
    wall = last["extra"].pop("bench_wall_s")
    assert last == head and wall >= head["extra"]["elapsed_s"]


def test_out_of_budget_extras_are_skipped_not_failed(runs):
    rc, out, err = runs["budget"].result()
    assert rc == 0, err
    head, last = _json_lines(out)
    _check_headline(head)
    assert last["extra"]["latency_skipped"] == "time budget"
    assert last["extra"]["multiclass_skipped"] == "time budget"
    assert not any(k.endswith("_error") for k in last["extra"])


def test_cuda_without_a_card_fails_with_no_result(runs):
    rc, out, err = runs["cuda"].result()
    assert rc != 0
    assert _json_lines(out) == []
    assert "CUDA is not available" in err


def _notes(err):
    return [json.loads(line[len("NOTE "):]) for line in err.splitlines() if line.startswith("NOTE ")]


def test_two_ranks_report_per_card_and_only_rank0_prints(runs):
    """Rank 1's third warm step is 2 s slower on its own clock alone; the
    ranks still end the warm-up together, and the run ends."""
    rc0, out0, err0 = runs["rank0"].result()
    rc1, out1, err1 = runs["rank1"].result()
    assert rc0 == 0, err0
    assert rc1 == 0, err1
    assert _json_lines(out1) == []
    head, last = _json_lines(out0)
    _check_headline(head)
    extra = head["extra"]
    assert extra["n_chips"] == 2 and extra["batch"] == B
    assert abs(head["value"] - extra["total_solves_per_s"] / 2) <= 0.05 + 1e-9
    # the slow step is among the last two until the fifth
    assert extra["warmup_steps"] >= 5
    assert _notes(err0) == _notes(err1) == [{k: extra[k] for k in _notes(err0)[0]}]
    last["extra"].pop("bench_wall_s")
    assert last == head


def test_two_ranks_end_an_extra_whose_set_up_failed_on_one_rank(runs):
    rc0, out0, err0 = runs["failing0"].result()
    rc1, out1, err1 = runs["failing1"].result()
    assert rc0 != 0 and rc1 != 0, (err0, err1)
    assert "injected pointRobot set-up failure" in err1
    assert _json_lines(out1) == []
    head, last = _json_lines(out0)
    _check_headline(head)
    assert last["extra"]["multiclass_error"] == "pointRobot set-up failed on another rank"
    assert not any(k.startswith(("pointRobot_", "boxer_")) for k in last["extra"])
