"""``FleetRunner.export_step`` and ``FleetRunner(..., artifact_dir=...)`` on
the CPU, the counterpart of ``tests/test_aot_export.py::test_fleet_step_export_roundtrip``.

The port's compiled part of a fleet step is the kernel library its solves
launch and the library of its graph's WHILE nodes (``utils/aot.py``),
written beside ``fleet_meta.yaml``. As in
``tests/test_torch_aot.py``, there is no card and no ``nvcc`` here: the card's
fingerprint is a fixed stand-in and the library is the structured kernel
compiled with g++ against ``tests/cuda_cpu_shim.h``, beside the split
expansion's two kernels (``csrc/fk_walk.cu``, ``csrc/gn_assemble.cu``). A fresh process must
register it without ``nvcc`` and step the fleet as this process does; a
runner of another batch, tier schedule, stall reset or kick, or an
unreadable export, is declined with a warning. ``chip_smoke.py``'s graph
phase runs the round trip on the card at B=4096.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from robot_mpcs_tpu_torch.config import Setup, point_robot_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
from robot_mpcs_tpu_torch.utils import aot

from test_torch_aot import CARD, built, libraries_meta, no_nvcc, problem_libs, stub_lib  # noqa: F401  (fixtures)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64  # the 1/8 rescue tier has its 8 slots
STEM, SHAPE = "riccati_packed", (6, 3, 0)  # pointRobot's kernel
RUNNER = dict(batch_size=B, device="cpu", kick_after=4, kick_scale=0.5)


@pytest.fixture(scope="module")
def problem():
    return MpcProblem(Setup.from_dict(point_robot_setup()))


@pytest.fixture(scope="module")
def emulated_lib(problem, tmp_path_factory):
    """{stem: g++ build} of the kernels the fleet step loads: the Riccati
    kernel and the split expansion's two."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernels for the CPU")
    from test_torch_riccati_emulated import _compile_all

    pairs = [pair for pair in aot.libraries(problem) if pair[0] != "graph_cond"]
    return problem_libs(_compile_all(tmp_path_factory.mktemp("emulated"), pairs), problem)


def _export(monkeypatch, runner, path, lib, stub=None):
    """``export_step`` for the stand-in card, its build returning ``lib`` for
    the kernel and ``stub`` (else ``lib``) for the WHILE nodes."""
    monkeypatch.setattr(aot, "_device_fingerprint", lambda device: dict(CARD))
    with monkeypatch.context() as m:
        m.setattr(_build, "build_library", built(lib, stub or lib))
        return runner.export_step(str(path))


def test_export_step_writes_the_library_and_fleet_meta(problem, emulated_lib, stub_lib, no_nvcc, monkeypatch,
                                                       tmp_path):
    runner = FleetRunner(problem, **RUNNER)
    out = _export(monkeypatch, runner, tmp_path / "fleet", emulated_lib, stub_lib)
    assert out == str(tmp_path / "fleet" / aot.FLEET_META)
    assert sorted(os.listdir(tmp_path / "fleet")) == [aot.FLEET_META, "libfk_walk.so", "libgn_assemble.so",
                                                      "libgraph_cond.so", f"lib{STEM}.so"]
    with open(out) as f:
        meta = yaml.safe_load(f)
    # the JAX package's _fleet_fingerprint fields ...
    assert meta["batch"] == B and meta["n_devices"] == 1 and meta["stall_reset_after"] == 3
    assert meta["tiers"] == [[8, 5, 10, 4]]  # ratio, al, ilqr, line search: the default tier
    assert meta["kick"] == [4, 0.15, 0.5]
    # ... and the libraries': one Riccati kernel at the problem's shape and
    # the expansion's two serve every tier, in a graph whose loops are WHILE
    # nodes
    assert aot.kernel_shapes(problem) == [(STEM, SHAPE)]
    assert meta["kernels"] == libraries_meta(problem)
    assert meta["torch"] == torch.__version__ and meta["N"] == problem.dims.N
    # an artifact_dir runner of the same configuration registers it, no nvcc
    FleetRunner(problem, **RUNNER, artifact_dir=str(tmp_path / "fleet"))
    for stem, shape in aot.libraries(problem):
        assert _build._libs[(stem, tuple(shape))]._name == str(tmp_path / "fleet" / f"lib{stem}.so")
    assert not os.path.exists(tmp_path / "cache")


def test_fresh_process_steps_the_fleet_from_the_export(problem, emulated_lib, stub_lib, no_nvcc, monkeypatch,
                                                       tmp_path):
    """A fresh interpreter with ``nvcc`` unreachable constructs the runner
    with ``artifact_dir``, registers the library and steps the fleet as the
    exporting process does."""
    runner = FleetRunner(problem, **RUNNER)
    _export(monkeypatch, runner, tmp_path / "fleet", emulated_lib, stub_lib)
    scenario = random_fleet_scenario(problem, B, seed=3)
    state, metrics = runner.run(scenario, 1)
    worker = textwrap.dedent(f"""
        import json, sys
        import numpy as np, torch
        torch.set_num_threads(2)
        from robot_mpcs_tpu_torch.config import Setup, point_robot_setup
        from robot_mpcs_tpu_torch.models.problem import MpcProblem
        from robot_mpcs_tpu_torch.ops import _build
        from robot_mpcs_tpu_torch.parallel.fleet import FleetRunner, random_fleet_scenario
        from robot_mpcs_tpu_torch.utils import aot

        def unreachable():
            raise AssertionError("nvcc was called")

        _build.nvcc = unreachable
        aot._device_fingerprint = lambda device: {CARD!r}
        problem = MpcProblem(Setup.from_dict(point_robot_setup()))
        runner = FleetRunner(problem, **{RUNNER!r}, artifact_dir={str(tmp_path / "fleet")!r})
        libs = {{stem: lib._name for (stem, _), lib in _build._libs.items()}}
        state, metrics = runner.run(random_fleet_scenario(problem, {B}, seed=3), 1)
        assert "robot_mpcs_tpu" not in sys.modules and "jax" not in sys.modules
        print(json.dumps({{"libs": libs, "x": state.x.tolist(), "z": state.z_warm.tolist(),
                          "metrics": {{k: float(v) for k, v in metrics._asdict().items()}}}}))
    """)
    env = {**os.environ, "PYTHONPATH": ROOT}  # PATH, CUDA_HOME and the cache: no_nvcc's
    out = subprocess.run([sys.executable, "-c", worker], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["libs"] == {stem: str(tmp_path / "fleet" / f"lib{stem}.so") for stem, _ in aot.libraries(problem)}
    assert not os.path.exists(tmp_path / "cache")  # nothing built
    np.testing.assert_array_equal(np.asarray(got["x"], np.float32), state.x.numpy())
    np.testing.assert_array_equal(np.asarray(got["z"], np.float32), state.z_warm.numpy())
    assert got["metrics"] == {k: float(v) for k, v in metrics._asdict().items()}


@pytest.mark.parametrize("change", ["batch", "tiers", "kick", "stall_reset_after", "garbage_meta"])
def test_mismatched_or_unreadable_fleet_export_is_declined(change, problem, no_nvcc, monkeypatch, tmp_path):
    lib = tmp_path / "built.so"
    lib.write_bytes(b"\x7fELF stand-in")
    _export(monkeypatch, FleetRunner(problem, **RUNNER), tmp_path / "fleet", lib)
    kw = dict(RUNNER)
    if change == "batch":
        kw["batch_size"] = 2 * B
    elif change == "tiers":
        kw["rescue_tiers"] = [(8, 5, 10, 2)]
    elif change == "kick":
        kw["kick_gdist"] = 0.3
    elif change == "stall_reset_after":
        kw["stall_reset_after"] = 5
    else:
        (tmp_path / "fleet" / aot.FLEET_META).write_text("{kernels: [unclosed")
    match = "ignoring unreadable" if change == "garbage_meta" else f"declining.*{change}"
    with pytest.warns(UserWarning, match=match):
        FleetRunner(problem, **kw, artifact_dir=str(tmp_path / "fleet"))
    assert _build._libs == {}


def test_fleet_artifact_defaults_to_the_card(problem, tmp_path):
    """With no device, a runner with ``artifact_dir`` asks for the card (as
    the planner's artifact does, ``tests/test_torch_aot.py``); without CUDA
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetRunner(problem, B, artifact_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / aot.FLEET_META)
