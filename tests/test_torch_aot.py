"""The port's solver artifact and kernel cache on the CPU
(``utils/aot.py``, ``utils/compile_cache.py``, ``MpcProblem.generate_solver``),
the counterparts of ``tests/test_aot_export.py``.

There is no card and no ``nvcc`` here. Where a test needs an exported
artifact, the card's fingerprint (``aot._device_fingerprint``) is a fixed
stand-in, and the library is the structured or general kernel compiled with
g++ against ``tests/cuda_cpu_shim.h`` (``tests/test_torch_riccati_emulated.py``):
a library with the launcher's C entry point. The loader must register it
without calling ``nvcc``, and its launcher must compute the sweep (held to
the plain version at the emulated tests' tolerances). An artifact also
carries the library of the solve graph's WHILE nodes (``csrc/graph_cond.cu``,
``ops/graph_cond.py``): here a stand-in with its C entry points
(``while_node_stub``), which the CPU never calls, registered beside the
kernel. The card runs the same round trip with the real libraries
(``chip_smoke.py``'s deploy phase, ``tests/test_torch_gpu.py``).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from robot_mpcs_tpu_torch.config import Setup, load_setup
from robot_mpcs_tpu_torch.models.problem import MpcProblem
from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.ops import riccati_batched as rb
from robot_mpcs_tpu_torch.ops import riccati_packed as rp
from robot_mpcs_tpu_torch.planner.mpc_planner import MPCPlanner
from robot_mpcs_tpu_torch.utils import aot, compile_cache

from chip_smoke import random_general_inputs, random_sweep_inputs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "examples", "config")
#: the stand-in card of the exported artifacts
CARD = {"device_name": "NVIDIA H100 80GB HBM3", "capability": "9.0"}
#: robot -> the kernel library its solve launches and the shape it is
#: compiled for; the mobile panda (the panda arm on a diff-drive base) is
#: built in code (``chip_smoke.mobile_panda_setup``)
KERNELS = {"pointRobot": ("riccati_packed", (6, 3, 0)), "boxer": ("riccati_batched", (8, 2)),
           "mobilePanda": ("riccati_batched", (22, 9))}


def _problem(kind):
    if kind == "mobilePanda":
        from chip_smoke import mobile_panda_setup

        return MpcProblem(Setup.from_dict(mobile_panda_setup()))
    return MpcProblem(load_setup(os.path.join(CONFIG_DIR, f"{kind}Mpc.yaml")))


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernels for the CPU")
    from test_torch_riccati_emulated import _compile_all

    return _compile_all(tmp_path_factory.mktemp("emulated"), KERNELS.values())


#: the C entry points of ``csrc/graph_cond.cu``, as a stand-in that fails each call
WHILE_NODE_STUB = """
int graph_cond_versions(int* r, int* d) { *r = 0; *d = 0; return 1; }
int graph_cond_while_begin(void* s, const void* f, void* b, unsigned long long* h, void** g) { return 1; }
int graph_cond_while_end(void* b, unsigned long long h, const void* f, unsigned long long* n) { return 1; }
int graph_cond_abort(void* b) { return 0; }
int graph_cond_count_nodes(void* g, unsigned long long* n) { return 1; }
"""


def while_node_stub(out_dir) -> str:
    """A g++ build of ``WHILE_NODE_STUB``: the WHILE-node library's stand-in."""
    src, lib = os.path.join(out_dir, "graph_cond_stub.c"), os.path.join(out_dir, "libgraph_cond_stub.so")
    with open(src, "w") as f:
        f.write(WHILE_NODE_STUB)
    subprocess.run(["g++", "-x", "c", "-shared", "-fPIC", "-o", lib, src], check=True)
    return lib


def built(lib, stub):
    """A stand-in for ``_build.build_library``: ``lib`` for the kernel,
    ``stub`` for the WHILE-node library."""
    return lambda stem, shape: (stub if stem == "graph_cond" else lib, "")


def libraries_meta(stem, shape) -> dict:
    """An artifact's ``kernels`` entry: the kernel and the WHILE-node library."""
    return {stem: {"file": f"lib{stem}.so", "shape": list(shape), "source_key": _build.source_key(stem, shape)},
            "graph_cond": {"file": "libgraph_cond.so", "shape": [],
                           "source_key": _build.source_key("graph_cond", ())}}


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the WHILE-node library's stand-in")
    return while_node_stub(str(tmp_path_factory.mktemp("stub")))


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """A process in which ``nvcc`` cannot be reached and no kernel library is
    loaded yet; the kernel cache is an empty directory."""
    def unreachable():
        raise AssertionError("nvcc was called")

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", unreachable)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path / "cache"))


def _export(monkeypatch, problem, path, lib, stub=None):
    """``export_planner_solve`` for the stand-in card, its build returning
    ``lib`` for the kernel and ``stub`` (else ``lib``) for the WHILE nodes."""
    monkeypatch.setattr(aot, "_device_fingerprint", lambda device: dict(CARD))
    with monkeypatch.context() as m:
        m.setattr(_build, "build_library", built(lib, stub or lib))
        return aot.export_planner_solve(problem, str(path), device="cpu")


def test_generate_solver_on_the_cpu_writes_the_yamls_only(tmp_path):
    problem = _problem("pointRobot")
    with pytest.warns(UserWarning, match="no kernels exported for cpu"):
        path = problem.generate_solver(str(tmp_path), device="cpu")
    assert os.path.basename(path) == problem.solver_name
    assert sorted(os.listdir(path)) == ["paramMap.yaml", "properties.yaml", "setup.yaml"]
    assert MpcProblem.from_solver_dir(path).npar == problem.npar


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_exported_library_loads_without_nvcc(kind, emulated_libs, stub_lib, no_nvcc, monkeypatch, tmp_path):
    problem, (stem, shape) = _problem(kind), KERNELS[kind]
    assert aot.kernel_shapes(problem) == [(stem, shape)]
    assert aot.libraries(problem) == [(stem, shape), ("graph_cond", ())]
    meta_path = _export(monkeypatch, problem, tmp_path / "artifact", emulated_libs[(stem, shape)], stub_lib)
    with open(meta_path) as f:
        meta = yaml.safe_load(f)
    assert meta["kernels"] == libraries_meta(stem, shape)
    assert meta["torch"] == torch.__version__ and meta["solver_name"] == problem.solver_name

    libs = aot.load_planner_solve(problem, str(tmp_path / "artifact"), device="cpu")
    want = os.path.abspath(tmp_path / "artifact" / f"lib{stem}.so")
    assert libs == {stem: want, "graph_cond": os.path.abspath(tmp_path / "artifact" / "libgraph_cond.so")}
    assert _build.load_library("graph_cond", ())._name == libs["graph_cond"]
    module = rp if stem == "riccati_packed" else rb
    lib = module.build_kernel(*shape)  # load_library: the registered copy, no nvcc
    assert lib._name == want and _build.load_library(stem, shape) is lib
    assert not os.path.exists(tmp_path / "cache")  # nothing built
    # the registered library's launcher computes the sweep (host threads)
    from test_torch_riccati_emulated import _general, _packed

    if stem == "riccati_packed":
        nx, nw, ns = shape
        args = [torch.as_tensor(v) for v in random_sweep_inputs(5, 20, nx, nw, seed=2)]
        kw = dict(N=20, nx=nx, nw=nw, ns=ns, a=0.05, b1=0.00125, b2=0.05)
        got, want_sweep, atol = _packed(lib, args, **kw), rp.riccati_backward_packed_reference(*args, **kw), 2e-5
    else:
        nx, nw = shape
        args = [torch.as_tensor(v) for v in random_general_inputs(5, 10, nx, nw, seed=2)]
        kw = dict(N=10, nx=nx, nw=nw)
        got, want_sweep, atol = _general(lib, args, **kw), rb.riccati_backward_batched_reference(*args, **kw), 2e-4
    for g, w in zip(got[:2], want_sweep[:2]):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=atol)
    assert torch.equal(got[2], want_sweep[2])


def _alter(meta_path, lib_path, what):
    with open(meta_path) as f:
        meta = yaml.safe_load(f)
    stem = next(iter(meta["kernels"]))
    if what == "torch":
        meta["torch"] = "0.0.0"
    elif what == "capability":
        meta["capability"] = "8.0"
    elif what == "source_key":  # the sources in the tree were edited since
        meta["kernels"][stem]["source_key"] = "0" * 64
    elif what == "N":
        meta["N"] += 1
    if what == "garbage_meta":
        with open(meta_path, "w") as f:
            f.write("{kernels: [unclosed")
    else:
        with open(meta_path, "w") as f:
            yaml.safe_dump(meta, f)
    if what == "corrupt_library":
        with open(lib_path, "wb") as f:
            f.write(b"not a shared library")


@pytest.mark.parametrize("what", ["torch", "capability", "source_key", "N", "garbage_meta",
                                  "corrupt_library"])
def test_mismatched_or_unreadable_export_is_declined_loudly(what, no_nvcc, monkeypatch, tmp_path):
    problem = _problem("pointRobot")
    lib = tmp_path / "built.so"
    lib.write_bytes(b"\x7fELF stand-in")
    meta_path = _export(monkeypatch, problem, tmp_path / "artifact", lib)
    _alter(meta_path, tmp_path / "artifact" / "libriccati_packed.so", what)
    match = "ignoring unreadable" if what in ("garbage_meta", "corrupt_library") else "declining"
    with pytest.warns(UserWarning, match=match):
        assert aot.load_planner_solve(problem, str(tmp_path / "artifact"), device="cpu") is None
    assert _build._libs == {}
    # the kernel is then built from the sources: here that raises (no nvcc)
    with pytest.raises(AssertionError, match="nvcc was called"):
        rp.build_kernel(6, 3, 0)


def test_artifact_without_export_warns(tmp_path):
    problem = _problem("pointRobot")
    with pytest.warns(UserWarning):
        path = problem.generate_solver(str(tmp_path), device="cpu")
    with pytest.warns(UserWarning, match="holds no exported kernels"):
        assert aot.load_planner_solve(problem, path, device="cpu") is None


def test_cache_variable_is_honoured(monkeypatch, tmp_path):
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR == _build.build_dir()
    assert compile_cache.DEFAULT_DIR == _build.CSRC.parent.parent / "build" / "robot_mpcs_tpu_torch"
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path / "kernels"))
    assert _build.build_dir() == tmp_path / "kernels"
    assert compile_cache.enable_compile_cache() == tmp_path / "kernels"
    assert (tmp_path / "kernels").is_dir() and not os.listdir(tmp_path / "kernels")


def test_unwritable_cache_raises_naming_the_variable(monkeypatch, tmp_path):
    (tmp_path / "file").write_text("")
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path / "file" / "kernels"))
    with pytest.raises(RuntimeError, match=compile_cache.CACHE_ENV):
        compile_cache.enable_compile_cache()
    # a build into it raises the same, before nvcc compiles anything
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho fake nvcc 0.0\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match=compile_cache.CACHE_ENV):
        _build.build_library("riccati_packed", (6, 3, 0))


def test_fresh_process_solves_like_the_in_process_planner(tmp_path):
    """A fresh interpreter loads the artifact with ``from_solver_dir`` (the
    reference's ``Solver.from_directory`` flow) and solves as the planner
    that wrote it (``tests/test_aot_export.py:86``)."""
    problem = _problem("pointRobot")
    with pytest.warns(UserWarning):
        problem.generate_solver(str(tmp_path), device="cpu")
    mpc = problem.setup.mpc
    mpc_cfg = dict(n=mpc.n, time_step=mpc.time_step, time_horizon=mpc.time_horizon, slack=mpc.slack)
    worker = textwrap.dedent(f"""
        import json, sys
        import numpy as np, torch
        torch.set_num_threads(2)
        from robot_mpcs_tpu_torch.planner.mpc_planner import MPCPlanner
        planner = MPCPlanner.from_solver_dir("pointRobot", {str(tmp_path)!r}, device="cpu", **{mpc_cfg!r})
        planner.setGoalReaching([1.0, 0.5, 0.0])
        planner.concretize()
        action, _, flag = planner.computeAction(np.zeros(3), np.zeros(3))
        assert "robot_mpcs_tpu" not in sys.modules and "jax" not in sys.modules
        print(json.dumps({{"action": np.asarray(action).tolist(), "flag": flag}}))
    """)
    out = subprocess.run([sys.executable, "-c", worker], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    planner = MPCPlanner(problem, device="cpu")
    planner.setGoalReaching([1.0, 0.5, 0.0])
    planner.concretize()
    action, _, flag = planner.computeAction(np.zeros(3), np.zeros(3))
    assert got["flag"] == flag >= 0
    np.testing.assert_allclose(got["action"], action, atol=1e-6)


def test_artifact_entry_points_default_to_cuda(tmp_path):
    """With no device, writing and loading an artifact ask for the card;
    without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable here")
    from robot_mpcs_tpu_torch.examples import make_solver, panda_example

    problem = _problem("pointRobot")
    with pytest.warns(UserWarning):
        problem.generate_solver(str(tmp_path), device="cpu")
    mpc = problem.setup.mpc
    calls = [
        lambda: problem.generate_solver(str(tmp_path / "default")),
        lambda: MPCPlanner.from_solver_dir("pointRobot", str(tmp_path), n=mpc.n, time_step=mpc.time_step,
                                           time_horizon=mpc.time_horizon, slack=mpc.slack),
        lambda: make_solver.generate(os.path.join(CONFIG_DIR, "pointRobotMpc.yaml"), str(tmp_path)),
        lambda: panda_example.make_example(),
        lambda: aot.load_planner_solve(problem, str(tmp_path)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(tmp_path / "default")
