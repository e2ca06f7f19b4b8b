"""Where the port keeps its compiled kernels (port of
``robot_mpcs_tpu.utils.compile_cache``).

The JAX package's compiled cache is XLA's persistent compilation cache: a
large program, tens of seconds to compile, loaded from disk by every process
after the first. The port's compiled code is the two Riccati kernels, each a
shared library that ``ops/_build.py`` compiles with ``nvcc`` at first use into
this directory and loads with ``ctypes``; the rest of the solver is PyTorch
and needs no compile. This module chooses that directory, as
``enable_compile_cache`` chooses the XLA one:

* ``ROBOT_MPCS_TPU_CACHE``, when set, names it (the JAX package's variable,
  in the same role);
* else it is ``build/robot_mpcs_tpu_torch/`` beside the package.

A library's file name is ``lib<stem>_<key>.so``. The key hashes what decides
the compiled code: the source and every file it includes with
``#include "..."``, the nvcc flags, and ``nvcc --version``
(``_build.source_key`` is the part without the compiler). A library whose key
is on disk is loaded, never rebuilt; an edit to any of those inputs gives a
new name, so a stale library is never loaded.

The JAX package namespaces its cache by a host-CPU fingerprint
(``_machine_tag``), because an XLA CPU entry compiled for one host's features
can crash on another. Nothing here needs that: the flag
``-gencode arch=compute_90a,code=sm_90a`` is in the key and pins the GPU
architecture, the CUDA driver runs a cubin built by an older toolkit, and a
card of another architecture refuses the kernel at launch (the wrapper raises
with the CUDA error) instead of running wrong code.

An unwritable directory raises, naming the variable to set. A kernel that
cannot be built is never replaced by its plain version: the wrappers raise.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

#: the variable that names the cache directory (the JAX package's)
CACHE_ENV = "ROBOT_MPCS_TPU_CACHE"
DEFAULT_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "robot_mpcs_tpu_torch"


def cache_dir() -> Path:
    """The kernel cache directory: ``$ROBOT_MPCS_TPU_CACHE`` or ``DEFAULT_DIR``."""
    return Path(os.environ.get(CACHE_ENV) or DEFAULT_DIR)


def enable_compile_cache(path: Optional[os.PathLike] = None) -> Path:
    """Make the kernel cache directory (``path``, else ``cache_dir()``) and
    check that a library can be written into it; returns it. Raises a
    ``RuntimeError`` naming ``ROBOT_MPCS_TPU_CACHE`` when it cannot."""
    d = Path(path) if path is not None else cache_dir()
    try:
        d.mkdir(parents=True, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=d, prefix=".probe")
        os.close(fd)
        os.unlink(probe)
    except OSError as e:
        raise RuntimeError(
            f"the kernel cache directory {d} is not writable ({e}); set "
            f"{CACHE_ENV} to a writable directory, or load the kernels from a "
            f"solver artifact (MpcProblem.generate_solver(..., export=True))"
        ) from e
    return d
