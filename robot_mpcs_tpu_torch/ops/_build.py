"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C entry point. ``load_library``
compiles it with ``nvcc`` for ``sm_90a`` on first use into the kernel cache
(``utils/compile_cache.py``: ``$ROBOT_MPCS_TPU_CACHE``, else
``build/robot_mpcs_tpu_torch/`` beside the package), under a name that hashes
the source and the headers it includes (``csrc/riccati_common.cuh``), the
nvcc flags and ``nvcc --version``, and loads it with ``ctypes``. A library
exported with a solver artifact (``utils/aot.py``) is registered instead
(``register_library``), and then no ``nvcc`` is needed. A missing ``nvcc`` or
a failed build raises: no wrapper falls back to its plain version for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from robot_mpcs_tpu_torch.utils import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
#: what a launcher returns for a shape the source does not instantiate
NO_INSTANTIATION = -1

_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """Where libraries are built and looked up (``compile_cache.cache_dir``)."""
    return compile_cache.cache_dir()


def nvcc() -> str:
    cands = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def source_files(source: Path) -> List[Path]:
    """``source`` and every file it includes with ``#include "..."``, found
    beside the including file, each once, in the order first reached."""
    files: List[Path] = []
    pending = [source]
    while pending:
        path = pending.pop(0)
        if path in files:
            continue
        files.append(path)
        pending += [path.parent / name for name in _INCLUDE.findall(path.read_text())]
    return files


def source_key(stem: str) -> str:
    """sha256 of what decides ``csrc/<stem>.cu``'s library apart from the
    compiler: the source, the files it includes and the nvcc flags. A process
    without ``nvcc`` can compute it (``utils/aot.py`` checks an exported
    library with it)."""
    key = b"".join(p.read_bytes() for p in source_files(CSRC / f"{stem}.cu"))
    return hashlib.sha256(key + " ".join(NVCC_FLAGS).encode()).hexdigest()


def build_library(stem: str) -> Tuple[Path, str]:
    """Compile ``csrc/<stem>.cu`` unless a library of the same key
    (``source_key`` and the nvcc version) exists. Returns its path and the
    compiler's output (``-Xptxas -v``: registers, spills, shared memory per
    instantiation), empty when the library was already built."""
    source = CSRC / f"{stem}.cu"
    compiler = nvcc()
    version = subprocess.run(
        [compiler, "--version"], capture_output=True, text=True, check=True
    ).stdout
    tag = hashlib.sha256((source_key(stem) + version).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out = out_dir / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, ""
    compile_cache.enable_compile_cache(out_dir)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{stem}: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out, proc.stdout + proc.stderr


def load_library(stem: str) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu``: one registered for this process
    (``register_library``), else built if needed and loaded; kept for the
    process."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build_library(stem)[0]))
    return _libs[stem]


def register_library(stem: str, path: os.PathLike) -> ctypes.CDLL:
    """Load the library at ``path`` (by its absolute path, so the loader
    searches no ``LD_LIBRARY_PATH``) as ``csrc/<stem>.cu``'s for this
    process, unless one is loaded already; ``load_library`` then builds
    nothing. The caller vouches that it was built from the same sources and
    flags (``utils/aot.py`` checks ``source_key``)."""
    if stem not in _libs:
        lib = ctypes.CDLL(str(Path(path).resolve()))
        getattr(lib, f"{stem}_launch")  # AttributeError for another library
        _libs[stem] = lib
    return _libs[stem]


def check_tensor(op: str, name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{op}: {name} is {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} is not contiguous")


def raise_for_status(op: str, err: int, shape_name: str, shape, source: str) -> None:
    """Turn a launcher's return code into an exception."""
    if err == NO_INSTANTIATION:
        raise ValueError(
            f"{op}: no CUDA instantiation for {shape_name} = {shape}; "
            f"add a RICCATI_CASE line to csrc/{source}"
        )
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed (cudaError {err})")
