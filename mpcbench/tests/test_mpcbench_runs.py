"""Whole runs on the CPU at a size a test run holds: the comparison's
control and every fault a cell can have come out not correct, a sound run
correct with ``failed`` 0, and nothing the run loads is JAX or the JAX
package. The card's own test runs one short cell through the command line."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from mpcbench import run
from mpcbench.control import DRIVER_FAULTS, Fault

ROOT = Path(__file__).resolve().parents[2]
#: the planner's cell, which BENCHMARK.json does not hold yet (PERF.md §7),
#: with the limits of its readings on the card
PLANNER_CELL = {"name": "panda-planner-b1", "config": "panda", "traffic": "planner-b1", "chips": 1,
                "why": "one arm, one computeAction at a time"}
PLANNER_LIMITS = {"plan_gap": 1e-4, "kkt_converged": 8e-3, "exact_mismatch": 0, "solves_per_converged": 40}
SMALL = {
    "fleet": {"batch": 32, "reset_period": 5, "tasks_per_lane": 3, "warmup_steps": 5, "check_span": 4,
              "check_steps": 2, "kkt_lanes": 6},
    "planner": {"tasks": 4, "warmup_solves": 3, "reset_period": 5, "kkt_solves": 6},
}
CELLS = {"fleet": "panda-fleet-4096", "planner": "panda-planner-b1"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds the planner's cell."""
    tmp = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "mpcbench", tmp / "mpcbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(PLANNER_CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "mpcbench/limits/panda-planner-b1.json").write_text(json.dumps(PLANNER_LIMITS))
    return tmp


def _run(root, kind, seed, **kw):
    import torch

    torch.set_num_threads(2)
    return run.run_cell(CELLS[kind], seed, 2.0, False, device="cpu", overrides=SMALL[kind], root=root,
                        t0=time.perf_counter(), **kw)


@pytest.mark.parametrize("kind", ["fleet", "planner"])
def test_sound_run_is_correct(root, kind):
    result, compared = _run(root, kind, 2 ** 31 + 101)
    assert result["correct"], compared
    assert result["failed"] == 0
    assert result["attempted"] > 0


@pytest.mark.parametrize("kind,seed", [(k, s) for k in ("fleet", "planner") for s in (2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7)])
def test_control_is_not_correct(root, kind, seed):
    result, compared = _run(root, kind, seed, control="bf16")
    assert not result["correct"], compared


@pytest.mark.parametrize("kind,fault", [(k, f) for k, fs in DRIVER_FAULTS.items() for f in fs])
def test_fault_is_not_correct(root, kind, fault):
    result, compared = _run(root, kind, 2 ** 31 + 21, fault=Fault(fault))
    assert not result["correct"], compared


def test_run_loads_no_jax():
    """A CPU rehearsal of a cell in a fresh process: the top-level names of
    every module it loaded, compared whole."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from mpcbench import run\n"
        "run.run_cell('panda-fleet-4096', 2**31 + 3, 1.0, False, device='cpu', overrides=%r, t0=time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n" % (str(ROOT), SMALL["fleet"])
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "robot_mpcs_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_command_line_on_the_card(card):
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload", "panda-fleet-4096", "--seed",
                          str(2 ** 31 + 9), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "compared"
    assert result["device"]["platform"] == "gpu" and result["failed"] == 0
