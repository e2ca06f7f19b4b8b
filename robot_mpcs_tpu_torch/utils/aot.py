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
  none for ``riccati_backend="scan"``), copies it into the artifact directory
  and writes ``export_meta.yaml`` beside it;
* ``load_planner_solve(problem, path)`` checks that fingerprint against the
  running process and the sources in the tree, without calling ``nvcc``,
  and registers the copied library for the process
  (``_build.register_library``), so that the first solve builds nothing. A
  robot with the CUDA runtime and no CUDA toolkit can then run the planner.

The fingerprint (``_fingerprint``): for each library, the file and
``_build.source_key`` (the hash of its source, the headers it includes and
the nvcc flags; the flags pin ``sm_90a``); ``torch.__version__`` and
``torch.version.cuda``; the card's name and compute capability; and the
problem's shape fields, as the JAX package's ``_abi_fingerprint``. The JAX
fingerprint's batch size has no counterpart: the kernels take any B. When the
fingerprint does not match, or a file cannot be read, the loader warns and
returns None; the kernel is then built from the sources, as without an
artifact (an error where there is no ``nvcc``), and never replaced by its
plain version.

What has no counterpart here:

* ``_register_serializations``: no serialized program returns NamedTuples;
  a library's entry point takes raw pointers.
* ``export_fleet_step`` / ``load_fleet_step``: one library holds every
  ``RICCATI_CASE`` instantiation, at any batch size, and a fleet step of a
  problem launches the same kernel as its planner's solve. A fleet loads
  the planner's export: ``load_planner_solve(runner.problem, path)`` before
  its first step.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Dict, List, Optional

import torch

from robot_mpcs_tpu_torch.ops import _build
from robot_mpcs_tpu_torch.utils.devices import resolve_device

EXPORT_META = "export_meta.yaml"


def kernel_stems(problem) -> List[str]:
    """The kernel libraries (``csrc`` stems) the problem's solve launches on
    the card."""
    stem = problem.build_solver(device="cpu").riccati_kernel
    return [stem] if stem else []


def _device_fingerprint(device: torch.device) -> dict:
    props = torch.cuda.get_device_properties(device)
    return {"device_name": props.name, "capability": f"{props.major}.{props.minor}"}


def _fingerprint(problem, stems: List[str], device: torch.device) -> dict:
    d = problem.dims
    return {
        "kernels": {
            stem: {"file": f"lib{stem}.so", "source_key": _build.source_key(stem)}
            for stem in stems
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


def export_planner_solve(problem, path: str, device="cuda") -> str:
    """Build the kernel libraries ``problem``'s solve launches, copy them
    into the artifact directory ``path`` and write their fingerprint for
    ``device`` (a CUDA device). Returns the fingerprint file's path. Raises
    where a library cannot be built (no ``nvcc``)."""
    dev = resolve_device(device)
    import yaml

    stems = kernel_stems(problem)
    os.makedirs(path, exist_ok=True)
    meta = _fingerprint(problem, stems, dev)
    for stem in stems:
        lib, _ = _build.build_library(stem)
        shutil.copyfile(lib, os.path.join(path, meta["kernels"][stem]["file"]))
    out = os.path.join(path, EXPORT_META)
    with open(out, "w") as f:
        yaml.safe_dump(meta, f, default_flow_style=False)
    return out


def load_planner_solve(problem, path: str, device="cuda") -> Optional[Dict[str, str]]:
    """Register the kernel libraries exported in the artifact directory
    ``path`` for this process, when their fingerprint matches ``problem``,
    this process, ``device`` and the sources in the tree. Returns {stem:
    absolute library path}, or None (with a warning) when the artifact holds
    no export, does not match, or cannot be read."""
    dev = resolve_device(device)
    meta_path = os.path.join(path, EXPORT_META)
    if not os.path.isfile(meta_path):
        warnings.warn(f"{path} holds no exported kernels ({EXPORT_META}); "
                      f"they are built from the sources", stacklevel=2)
        return None
    import yaml

    try:
        with open(meta_path) as f:
            meta = yaml.safe_load(f)
        want = _fingerprint(problem, kernel_stems(problem), dev)
        if meta != want:
            keys = sorted(k for k in set(meta) | set(want) if meta.get(k) != want.get(k))
            warnings.warn(
                f"declining the exported kernels in {path}: {keys} differ from this "
                f"process and the sources; they are built from the sources",
                stacklevel=2,
            )
            return None
        libs = {stem: os.path.abspath(os.path.join(path, entry["file"]))
                for stem, entry in meta["kernels"].items()}
        for stem, lib in libs.items():
            _build.register_library(stem, lib)
        return libs
    except (OSError, AttributeError, KeyError, TypeError, yaml.YAMLError) as e:
        warnings.warn(f"ignoring unreadable kernel export at {path} ({e}); "
                      f"the kernels are built from the sources", stacklevel=2)
        return None
