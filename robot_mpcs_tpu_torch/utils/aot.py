"""The compiled part of a solver artifact: the kernel library (port of
``robot_mpcs_tpu.utils.aot``).

The reference's ``generate_solver`` emits a compiled solver next to its YAML
files (reference ``robotmpcs/models/mpcModel.py:128-141``), and its planner
loads it back without compiling (``mpcPlanner.py:73``). The JAX package
exports the traced-and-lowered XLA program of the planner's solve
(``jax.export``). The port's solve is PyTorch code and needs no compile; what
a fresh process compiles before its first solve on the card is the Riccati
kernel that its problem launches, with ``nvcc`` (``ops/_build.py``). So the
port's exported program is that kernel's library:

* ``export_planner_solve(problem, path)`` builds the library that the
  problem's solve launches (``riccati_packed`` for holonomic problems,
  ``riccati_batched`` otherwise, as ``solver/al_ilqr.build_solver`` chooses;
  none for ``riccati_backend="scan"``), compiled for the problem's own shape
  (``kernel_shapes``), and the library of the conditional WHILE nodes that
  the solve's CUDA graph needs for its loops (``graph_cond``,
  ``ops/graph_cond.py``; ``libraries``), copies them into the artifact
  directory and writes ``export_meta.yaml`` beside them;
* ``load_planner_solve(problem, path)`` checks that fingerprint against the
  running process and the sources in the tree, without calling ``nvcc``,
  and registers the copied library for the process
  (``_build.register_library``), so that the first solve builds nothing. A
  robot with the CUDA runtime and no CUDA toolkit can then run the planner.

The fingerprint (``_fingerprint``): for each library, the file, the shape
it was compiled for and ``_build.source_key`` (the hash of its source, the
headers it includes, the nvcc flags and the shape's defines; the flags pin
``sm_90a``); ``torch.__version__`` and
``torch.version.cuda``; the card's name and compute capability; and the
problem's shape fields, as the JAX package's ``_abi_fingerprint``. The JAX
fingerprint's batch size has no counterpart: the kernels take any B. When the
fingerprint does not match, or a file cannot be read, the loader warns and
returns None; the kernel is then built from the sources, as without an
artifact (an error where there is no ``nvcc``), and never replaced by its
plain version.

The fleet step (``export_fleet_step`` / ``load_fleet_step``, behind
``FleetRunner.export_step`` and ``FleetRunner(..., artifact_dir=...)``):
the JAX package serialises the whole jitted fleet step. The port's compiled
part of a fleet step is the same pair of libraries: phase 1 and every
rescue tier launch one kernel at one shape, the problem's
(``kernel_shapes``), in a graph whose loops are WHILE nodes
(``libraries``). ``export_fleet_step`` copies them into the artifact directory beside
``fleet_meta.yaml``, which holds the library fingerprint above and
``_fleet_fingerprint``'s fields of the JAX package: the batch size, the
mesh width (``n_devices``), the tier schedule, ``stall_reset_after`` and
the kick's three knobs. ``load_fleet_step`` checks it against the runner
and registers the libraries without ``nvcc``; a mismatch or an unreadable
file warns and is declined, as for the planner. The step's CUDA graph
(``solver/units.py``), the port's counterpart of the jitted program, cannot
be serialised: a process captures its own at its first step, as the JAX
package's loaded export skips only the Python trace.

What has no counterpart here: ``_register_serializations``: no serialized
program returns NamedTuples; a library's entry point takes raw pointers.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.utils.devices import resolve_device

EXPORT_META = "export_meta.yaml"
FLEET_META = "fleet_meta.yaml"


def kernel_shapes(problem) -> List[Tuple[str, tuple]]:
    """The kernel libraries the problem's solve launches on the card: its
    ``csrc`` stem and the shape it is compiled for, ``(nx, nw, ns)`` for the
    structured sweep and ``(nx, nw)`` for the general one (nw = nu + ns)."""
    stem = problem.build_solver(device="cpu").riccati_kernel
    if stem is None:
        return []
    d = problem.dims
    shape = (d.nx, d.nu + d.ns, d.ns) if stem == "riccati_packed" else (d.nx, d.nu + d.ns)
    return [(stem, shape)]


def libraries(problem) -> List[Tuple[str, tuple]]:
    """What the problem's solve loads on the card: its kernel
    (``kernel_shapes``) and the WHILE-node library its CUDA graph's loops
    need (``csrc/graph_cond.cu``, no shape)."""
    return kernel_shapes(problem) + [("graph_cond", ())]


def _device_fingerprint(device: torch.device) -> dict:
    props = torch.cuda.get_device_properties(device)
    return {"device_name": props.name, "capability": f"{props.major}.{props.minor}"}


def _fingerprint(problem, kernels: List[Tuple[str, tuple]], device: torch.device) -> dict:
    d = problem.dims
    return {
        "kernels": {
            stem: {"file": f"lib{stem}.so", "shape": list(shape),
                   "source_key": _build.source_key(stem, shape)}
            for stem, shape in kernels
        },
        "torch": str(torch.__version__),
        "cuda": torch.version.cuda,
        **_device_fingerprint(device),
        "nx": int(d.nx),
        "nz": int(d.nz),
        "N": int(d.N),
        "npar": int(problem.npar),
        "n_con": int(problem.n_con),
        "solver_name": problem.solver_name,
    }


def _export(path: str, meta: dict, kernels, meta_file: str) -> str:
    """Build ``kernels``, copy them into ``path`` and write ``meta`` as
    ``meta_file`` beside them; returns the metadata file's path."""
    import yaml

    os.makedirs(path, exist_ok=True)
    for stem, shape in kernels:
        lib, _ = _build.build_library(stem, shape)
        shutil.copyfile(lib, os.path.join(path, meta["kernels"][stem]["file"]))
    out = os.path.join(path, meta_file)
    with open(out, "w") as f:
        yaml.safe_dump(meta, f, default_flow_style=False)
    return out


def _load(path: str, fingerprint, meta_file: str) -> Optional[Dict[str, str]]:
    """Register the libraries of ``path`` when its ``meta_file`` equals
    ``fingerprint()``; else warn and return None."""
    meta_path = os.path.join(path, meta_file)
    if not os.path.isfile(meta_path):
        warnings.warn(f"{path} holds no exported kernels ({meta_file}); "
                      f"they are built from the sources", stacklevel=3)
        return None
    import yaml

    try:
        with open(meta_path) as f:
            meta = yaml.safe_load(f)
        want = fingerprint()
        if meta != want:
            keys = sorted(k for k in set(meta) | set(want) if meta.get(k) != want.get(k))
            warnings.warn(
                f"declining the exported kernels in {path}: {keys} differ from this "
                f"process and the sources; they are built from the sources",
                stacklevel=3,
            )
            return None
        libs = {}
        for stem, entry in meta["kernels"].items():
            libs[stem] = os.path.abspath(os.path.join(path, entry["file"]))
            _build.register_library(stem, tuple(entry["shape"]), libs[stem])
        return libs
    except (OSError, AttributeError, KeyError, TypeError, yaml.YAMLError) as e:
        warnings.warn(f"ignoring unreadable kernel export at {path} ({e}); "
                      f"the kernels are built from the sources", stacklevel=3)
        return None


def export_planner_solve(problem, path: str, device="cuda") -> str:
    """Build the kernel libraries ``problem``'s solve launches, copy them
    into the artifact directory ``path`` and write their fingerprint for
    ``device`` (a CUDA device). Returns the fingerprint file's path. Raises
    where a library cannot be built (no ``nvcc``)."""
    dev = resolve_device(device)
    kernels = libraries(problem)
    return _export(path, _fingerprint(problem, kernels, dev), kernels, EXPORT_META)


def load_planner_solve(problem, path: str, device="cuda") -> Optional[Dict[str, str]]:
    """Register the kernel libraries exported in the artifact directory
    ``path`` for this process, when their fingerprint matches ``problem``,
    this process, ``device`` and the sources in the tree. Returns {stem:
    absolute library path}, or None (with a warning) when the artifact holds
    no export, does not match, or cannot be read."""
    dev = resolve_device(device)
    return _load(path, lambda: _fingerprint(problem, libraries(problem), dev), EXPORT_META)


# ------------------------------------------------------------- fleet step


def _fleet_fingerprint(runner) -> dict:
    """The library fingerprint of the runner's problem on its device, and
    the JAX package's fleet fields: batch, mesh width, tier schedule
    ``(ratio, al, ilqr, line search)``, stall reset and kick knobs."""
    return {
        **_fingerprint(runner.problem, libraries(runner.problem), runner.device),
        "batch": int(runner.batch),
        "n_devices": int(runner.mesh.world),
        "tiers": [list(t) for t in runner._tier_spec],
        "stall_reset_after": int(runner._stall_reset_after),
        "kick": [int(runner._kick_after), float(runner._kick_gdist), float(runner._kick_scale)],
    }


def export_fleet_step(runner, path: str) -> str:
    """Export the compiled part of ``runner``'s fleet step into ``path``:
    the kernel library its phase 1 and rescue tiers launch, beside
    ``fleet_meta.yaml`` (``_fleet_fingerprint``). Returns the metadata
    file's path. Raises where the library cannot be built (no ``nvcc``)."""
    kernels = libraries(runner.problem)
    return _export(path, _fleet_fingerprint(runner), kernels, FLEET_META)


def load_fleet_step(runner, path: str) -> Optional[Dict[str, str]]:
    """Register the kernel library of a fleet step exported in ``path``
    when ``fleet_meta.yaml`` matches ``runner`` (batch, mesh width, tiers,
    stall and kick knobs), this process and the sources; returns {stem:
    absolute library path}, or None with a warning, and the kernel is then
    built from the sources at the first step."""
    return _load(path, lambda: _fleet_fingerprint(runner), FLEET_META)
