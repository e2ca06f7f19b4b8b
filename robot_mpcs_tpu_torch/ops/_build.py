"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C entry point and is compiled for one
problem shape at a time: ``load_library(stem, shape)`` compiles it with
``nvcc`` for ``sm_90a`` at the first use of that shape, with the shape, the
team size and the number of stage buffers as ``-D`` defines (``defines``),
into the kernel cache (``utils/compile_cache.py``: ``$ROBOT_MPCS_TPU_CACHE``,
else ``build/robot_mpcs_tpu_torch/`` beside the package), under a name that
hashes the source and the headers it includes (``csrc/riccati_common.cuh``),
the nvcc flags, the defines and ``nvcc --version``, and loads it with
``ctypes``. A shape built once is loaded from the cache. A library exported
with a solver artifact (``utils/aot.py``) is registered instead
(``register_library``), and then no ``nvcc`` is needed. A missing ``nvcc``, a
failed build, or a shape of which one lane's shared memory does not fit a
block (``check_fits``) raises: no wrapper falls back to its plain version or
to the scan for a CUDA tensor. ``csrc/graph_cond.cu`` (the solver's
conditional WHILE nodes, ``ops/graph_cond.py``) is built the same way with no
shape: ``load_library("graph_cond", ())``. The split expansion's two kernels
are built the same way: ``csrc/gn_assemble.cu`` for a problem's row segment
sizes, ``csrc/fk_walk.cu`` for a robot's chain and link set, whose one shape
field is the string of its defines (``ops/fk_walk.walk_table``).

Launch counts: each wrapper (``counted``) counts its launches by batch size.
An eager launch counts on the host. A launch made while a CUDA graph is
captured also captures a one-element increment of a counter on the device,
one per (kernel, batch size), so that every replay counts the launches its
loops really made, trip by trip. ``launch_counts()`` adds the two, at the
cost of one synchronize when a graph has counted.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import functools
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
#: what a launcher returns for a shape other than its library's
NO_INSTANTIATION = -1
#: ... and for a shape of which not one lane (a Riccati sweep), the block
#: (the Gauss-Newton assembly) or 4 rows (the FK walk) fit a block's shared
#: memory
NO_ROOM = -2
#: the shape fields each source is compiled for, in the order of its
#: launcher's arguments (``-D<PREFIX>_<FIELD>``; ``fk_walk``'s one field is
#: its chain, ``ops/fk_walk.walk_table``'s defines)
SHAPE_FIELDS = {"riccati_packed": ("nx", "nw", "ns"), "riccati_batched": ("nx", "nw"),
                "fk_walk": ("chain",),
                "gn_assemble": ("qr", "qb", "qc", "ar", "ab", "ac", "nq", "nx", "nw", "ns"),
                "graph_cond": ()}
#: the prefix of each source's shape defines (``-D<PREFIX>_<FIELD>``)
DEFINE_PREFIX = {"riccati_packed": "RICCATI", "riccati_batched": "RICCATI", "gn_assemble": "GN"}
#: a symbol each source's library exports (``register_library`` checks it)
ENTRY_POINTS = {"riccati_packed": "riccati_packed_launch",
                "riccati_batched": "riccati_batched_launch",
                "fk_walk": "fk_walk_launch",
                "gn_assemble": "gn_assemble_launch",
                "graph_cond": "graph_cond_while_begin"}
#: counters on each device for the launches captured into CUDA graphs
COUNTER_SLOTS = 256
#: the shared memory a block may have on an sm_90 card (H100, H200), the
#: opt-in maximum: the libraries are built for sm_90a only
SM90_SHARED_OPTIN = 232448
#: ... its shared memory an SM, and what a block reserves of it
SM90_SHARED_PER_SM, SM90_RESERVED_PER_BLOCK = 233472, 1024

_libs: Dict[Tuple[str, tuple], ctypes.CDLL] = {}
#: launches counted on the host, {(kernel name, batch): n}
_host_counts: collections.Counter = collections.Counter()
#: per CUDA device, the captured launches' counters: (int64 tensor of
#: COUNTER_SLOTS, {(kernel name, batch): slot})
_device_counts: Dict[torch.device, Tuple[torch.Tensor, Dict[Tuple[str, int], int]]] = {}
#: False while ``not_counted()`` is entered
_counting = True


def indexed(device: torch.device) -> torch.device:
    """``device`` with its index (``cuda`` is the current CUDA device)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_counters(device: torch.device):
    """The counters of ``device``'s captured launches, allocated at first use.
    A program calls this before it captures: a capture must not allocate
    them (``solver/units.py``)."""
    device = indexed(device)
    if device not in _device_counts:
        _device_counts[device] = (torch.zeros((COUNTER_SLOTS,), dtype=torch.int64, device=device), {})
    return _device_counts[device]


def count_launch(op, batch: int, device: torch.device) -> None:
    """Count one launch of the kernel wrapper ``op`` at batch size ``batch``
    on ``device``: on the host for an eager launch; inside a CUDA graph's
    capture as an increment of the (kernel, batch) counter on the device,
    captured beside the launch, so that each replay of the graph counts it
    as often as it runs."""
    if not _counting:
        return
    key = (op.__name__, int(batch))
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        device = indexed(device)
        if device not in _device_counts:
            raise RuntimeError(f"{op.__name__}: launched in a capture before device_counters({device})")
        counts, slots = _device_counts[device]
        if key not in slots:
            if len(slots) == COUNTER_SLOTS:
                raise RuntimeError(f"more than {COUNTER_SLOTS} (kernel, batch) launch counters")
            slots[key] = len(slots)
        counts[slots[key] : slots[key] + 1].add_(1)
        return
    _host_counts[key] += 1


def launch_counts() -> Dict[Tuple[str, int], int]:
    """Every wrapper's launches so far, ``{(kernel name, batch): n}``, eager
    and replayed alike (reads the device counters: one synchronize)."""
    counts = collections.Counter(_host_counts)
    for buf, slots in _device_counts.values():
        if slots:
            values = buf.tolist()
            for key, slot in slots.items():
                counts[key] += values[slot]
    return {k: n for k, n in counts.items() if n}


def reset_launches(name: str) -> None:
    """Set the launch counts of the kernel wrapper ``name`` to 0."""
    for key in [k for k in _host_counts if k[0] == name]:
        del _host_counts[key]
    for buf, slots in _device_counts.values():
        for key, slot in slots.items():
            if key[0] == name:
                buf[slot] = 0


@contextlib.contextmanager
def not_counted():
    """Launches made in the block are not counted (the solver's scratch
    runs before a capture, ``solver/units.py``)."""
    global _counting
    before, _counting = _counting, False
    try:
        yield
    finally:
        _counting = before


class counted:
    """A kernel wrapper with its count of launches: ``fn.launches`` reads
    ``launch_counts()`` for this kernel, ``fn.launches = 0`` resets it."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return sum(n for (name, _), n in launch_counts().items() if name == self.__name__)

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError("a kernel's launch count can only be reset to 0")
        reset_launches(self.__name__)


def team_size(nx: int) -> int:
    """Threads per lane of a Riccati sweep, T: 16 at nx <= 8, else a warp."""
    return 16 if nx <= 8 else 32


#: (lane, stage) items of a group of the Gauss-Newton assembly: one per lane
#: of a warp (``csrc/gn_assemble.cu`` ``G``); threads of its blocks: 8 warps
GN_ITEMS, GN_THREADS = 32, 256


def _odd(x: int) -> int:
    """An odd row stride (``riccati_common.cuh`` ``odd``)."""
    return x | 1


def lane_floats(stem: str, shape, depth: int) -> int:
    """Floats of shared memory one lane of a Riccati sweep,
    ``csrc/<stem>.cu``, takes with ``depth`` stage buffers: the
    ``PackedLayout`` / ``GeneralLayout`` of the source (its exported
    ``<stem>_lane_bytes`` is held equal by the tests)."""
    nx, nw = shape[0], shape[1]
    m = 1 + nx
    if stem == "riccati_packed":
        stage = nx + nw + nx * nx + nx * nw + nw * nw
        return depth * stage + nx * _odd(nx) + nx + nx * _odd(nw) + nw * nw + nw * m
    nv = nx + nw
    stage = nx + nw + 2 * nx * nx + 2 * nx * nw + nw * nw
    return depth * stage + nx * _odd(nx) + nx + (nx + nv) * _odd(nv) + nv + 2 * nw * m


def gn_terms_max(shape) -> int:
    """The (row, coefficient) terms the assembly's table holds: 5 per affine
    row (a row of ``S_aff`` with k <= 2 non-zeros feeds k gradient and
    k (k + 1) / 2 upper entries)."""
    return 5 * sum(tuple(shape)[3:6])


def gn_block_floats(shape, depth: int) -> int:
    """Floats of shared memory a block of the Gauss-Newton assembly takes
    with ``depth`` stage buffers (``csrc/gn_assemble.cu`` ``Lay``): the
    buffers of ``GN_ITEMS`` item records (the rows' values and second
    scalars, the q Jacobian, the slack; odd stride), the output tile, the
    schedule (4 words an entry) and the terms table (2 words a term). The
    source's exported ``gn_assemble_block_bytes`` is held equal by the
    tests."""
    qr, qb, qc, ar, ab, ac, nq, nx, nw, ns = shape
    rq, r, nv = qr + qb + qc, qr + qb + qc + ar + ab + ac, nx + nw
    record = _odd(2 * r + rq * nq + ns)
    out = nx + nw + nx * nx + nx * nw + nw * nw
    return GN_ITEMS * (depth * record + out) + 4 * (nv + nv * (nv + 1) // 2) + 2 * gn_terms_max(shape)


def fk_rows_per_block(M: int, row_bytes: int, optin: int = SM90_SHARED_OPTIN, sms: int = 132) -> int:
    """Rows (threads) per block of the FK walk over ``M`` rows, as
    ``csrc/fk_walk.cu`` ``rows_per_block`` chooses them: 128, fewer where
    ``optin`` bytes hold fewer rows of ``row_bytes`` (a multiple of 32, else
    of 4), halved down to 32 while the grid would give the card's ``sms``
    SMs fewer than two blocks each; 0 where not 4 rows fit."""
    fit = optin // row_bytes
    rows = 128 if fit >= 128 else (fit // 32 * 32 if fit >= 32 else fit // 4 * 4)
    while rows > 32 and rows % 64 == 0 and -(-M // rows) < 2 * sms:
        rows //= 2
    return rows


def gn_grid(M: int, block_bytes: int, sms: int = 132) -> int:
    """Persistent blocks of the Gauss-Newton assembly over ``M`` items, as
    its launcher chooses them: as many as the card's ``sms`` SMs hold at
    once (by threads and shared memory; the kernel's launch bounds keep two
    blocks' registers), fewer where the groups of ``GN_ITEMS`` items take
    fewer rounds of them."""
    resident = max(1, min(2048 // GN_THREADS, SM90_SHARED_PER_SM // (block_bytes + SM90_RESERVED_PER_BLOCK)))
    groups = -(-M // GN_ITEMS)
    return -(-groups // -(-groups // (sms * resident)))


def fk_row_floats(shape, jac: bool) -> int:
    """Floats of shared memory one row of the FK walk takes in a block's
    tiles (``csrc/fk_walk.cu`` ``kRowFloats``): P (3L), J (3Ln, ``jac``) and
    q (stride odd(n)). The source's exported ``fk_walk_row_bytes`` is held
    equal by the tests."""
    defines = dict(tok.split("=", 1) for tok in tuple(shape)[0].split(" "))
    n, L = int(defines["FK_N"]), int(defines["FK_L"])
    return 3 * L + (3 * L * n if jac else 0) + _odd(n)


def stage_depth(stem: str, shape) -> int:
    """Stage buffers per lane. The structured sweep: 2 (a deeper ring
    measured no faster). The general one: 3 where a block of 128 / T lanes
    then stays within 48 KB (faster than 2 at boxer's shapes), else 2. The
    Gauss-Newton assembly's groups: 2 where a block with two fits the card's
    shared memory, else 1."""
    if stem == "riccati_packed":
        return 2
    if stem == "gn_assemble":
        return 2 if 4 * gn_block_floats(shape, 2) <= SM90_SHARED_OPTIN else 1
    lanes = 128 // team_size(shape[0])
    return 3 if lanes * lane_floats(stem, shape, 3) * 4 <= 48 * 1024 else 2


def check_shape(stem: str, shape) -> tuple:
    """``shape`` as a tuple of ints for ``csrc/<stem>.cu``'s fields (for
    ``fk_walk``, its one chain string); raises for one the kernel does not
    take."""
    fields = SHAPE_FIELDS[stem]
    if stem == "fk_walk":
        if len(shape) != 1 or not isinstance(shape[0], str) or "FK_N=" not in shape[0]:
            raise ValueError(f"{stem}: {shape!r} is not a chain (ops/fk_walk.walk_table)")
        return (shape[0],)
    shape = tuple(int(v) for v in shape)
    if not fields and not shape:
        return shape
    if len(shape) != len(fields) or min(shape) < 0:
        raise ValueError(f"{stem}: shape {fields} = {shape} is not a kernel shape")
    if stem == "gn_assemble":
        values = dict(zip(fields, shape))
        if min(values["nx"], values["nw"]) < 1 or values["nq"] > values["nx"] or values["ns"] not in (0, 1):
            raise ValueError(f"{stem}: shape {fields} = {shape} is not a split expansion")
        return shape
    if min(shape[:2]) < 1:
        raise ValueError(f"{stem}: shape {fields} = {shape} is not a kernel shape")
    if stem == "riccati_packed":
        nx, nw, ns = shape
        if ns not in (0, 1) or nx % 2 or nw != nx // 2 + ns:
            raise ValueError(
                f"{stem}: (nx, nw, ns) = {shape} is not a holonomic shape "
                f"(nx = 2n, nw = n + ns, ns in (0, 1))"
            )
    return shape


def defines(stem: str, shape) -> List[str]:
    """The ``-D`` flags that compile ``csrc/<stem>.cu`` for ``shape``."""
    shape = check_shape(stem, shape)
    if not shape:
        return []
    if stem == "fk_walk":
        return [f"-D{token}" for token in shape[0].split(" ")]
    values = dict(zip(SHAPE_FIELDS[stem], shape))
    if stem == "gn_assemble":
        values["d"] = stage_depth(stem, shape)
    else:
        values["t"] = team_size(shape[0])
        values["depth"] = stage_depth(stem, shape)
    return [f"-D{DEFINE_PREFIX[stem]}_{k.upper()}={v}" for k, v in values.items()]


def check_fits(stem: str, shape) -> None:
    """Raise unless one lane's shared memory at ``shape`` (a Riccati sweep),
    the block's (the Gauss-Newton assembly) or 4 rows' (the FK walk, with
    its Jacobian) fits a block of an sm_90 card."""
    if stem == "graph_cond":  # no shared memory
        return
    if stem == "gn_assemble":
        need, unit = 4 * gn_block_floats(shape, stage_depth(stem, shape)), "a block"
    elif stem == "fk_walk":
        need, unit = 16 * fk_row_floats(shape, True), "4 rows"
    else:
        need, unit = 4 * lane_floats(stem, shape, stage_depth(stem, shape)), "one lane"
    limit = SM90_SHARED_OPTIN
    if need > limit:
        raise ValueError(
            f"csrc/{stem}.cu: {unit} at {_shape_text(stem, shape)} needs {need} bytes "
            f"of shared memory, more than the {limit} a block may have{_remedy(stem)}"
        )


def _remedy(stem: str) -> str:
    """What a caller can do about a shape whose lane does not fit."""
    return '; solve it with riccati_backend="scan"' if stem.startswith("riccati") else ""


def _shape_text(stem: str, shape) -> str:
    return "its chain" if stem == "fk_walk" else f"{SHAPE_FIELDS[stem]} = {tuple(shape)}"


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


@functools.lru_cache(maxsize=None)
def nvcc_version(compiler: str) -> str:
    """``compiler --version``, asked once per process (part of each
    library's name)."""
    return subprocess.run([compiler, "--version"], capture_output=True, text=True, check=True).stdout


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


def source_key(stem: str, shape) -> str:
    """sha256 of what decides ``csrc/<stem>.cu``'s library at ``shape`` apart
    from the compiler: the source, the files it includes, the nvcc flags
    and the shape's defines. A process without ``nvcc`` can compute it
    (``utils/aot.py`` checks an exported library with it)."""
    key = b"".join(p.read_bytes() for p in source_files(CSRC / f"{stem}.cu"))
    flags = NVCC_FLAGS + defines(stem, shape)
    return hashlib.sha256(key + " ".join(flags).encode()).hexdigest()


def library_name(stem: str, shape, nvcc_version: str) -> str:
    """The file name of ``csrc/<stem>.cu``'s library at ``shape``, built by
    the ``nvcc`` whose ``--version`` says ``nvcc_version``."""
    tag = hashlib.sha256((source_key(stem, shape) + nvcc_version).encode()).hexdigest()[:16]
    return f"lib{stem}_{tag}.so"


def build_library(stem: str, shape) -> Tuple[Path, str]:
    """Compile ``csrc/<stem>.cu`` for ``shape`` unless a library of the same
    name (``library_name``) exists. Returns its path and the compiler's
    output (``-Xptxas -v``: registers, spills, shared memory), empty when
    the library was already built. Raises, before ``nvcc`` is called, for a
    shape the kernel does not take or whose lane does not fit (``check_fits``)."""
    source = CSRC / f"{stem}.cu"
    flags = defines(stem, shape)
    check_fits(stem, shape)
    compiler = nvcc()
    out_dir = build_dir()
    out = out_dir / library_name(stem, shape, nvcc_version(compiler))
    if out.exists():
        return out, ""
    compile_cache.enable_compile_cache(out_dir)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [compiler, *NVCC_FLAGS, *flags, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{stem}: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out, proc.stdout + proc.stderr


def build_libraries(kernels) -> Dict[Tuple[str, tuple], Tuple[Path, str]]:
    """``build_library`` of each (stem, shape) of ``kernels`` at once, one
    ``nvcc`` each in parallel; returns {(stem, shape): (path, log)}."""
    keys = list(dict.fromkeys((stem, check_shape(stem, shape)) for stem, shape in kernels))
    if not keys:
        return {}
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        return dict(zip(keys, pool.map(lambda key: build_library(*key), keys)))


def load_library(stem: str, shape) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu`` at ``shape``: one registered for
    this process (``register_library``), else built if needed and loaded;
    kept for the process."""
    lib = _libs.get((stem, tuple(shape)))  # the wrappers' path: loaded already
    if lib is None:
        key = (stem, check_shape(stem, shape))
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build_library(*key)[0]))
        lib = _libs[key]
    return lib


def register_library(stem: str, shape, path: os.PathLike) -> ctypes.CDLL:
    """Load the library at ``path`` (by its absolute path, so the loader
    searches no ``LD_LIBRARY_PATH``) as ``csrc/<stem>.cu``'s at ``shape`` for
    this process, unless one is loaded already; ``load_library`` then builds
    nothing. The caller vouches that it was built from the same sources,
    flags and shape (``utils/aot.py`` checks ``source_key``)."""
    key = (stem, check_shape(stem, shape))
    if key not in _libs:
        lib = ctypes.CDLL(str(Path(path).resolve()))
        getattr(lib, ENTRY_POINTS[stem])  # AttributeError for another library
        _libs[key] = lib
    return _libs[key]


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


def raise_for_status(op: str, err: int, stem: str, shape) -> None:
    """Turn a launcher's return code into an exception."""
    if err == NO_INSTANTIATION:
        raise ValueError(
            f"{op}: the csrc/{stem}.cu library loaded for {_shape_text(stem, shape)} was built "
            f"for another shape"
        )
    if err == NO_ROOM:
        unit = {"gn_assemble": "the block", "fk_walk": "4 rows"}.get(stem, "one lane")
        raise ValueError(
            f"{op}: the shared memory of {unit} at {_shape_text(stem, shape)} does not fit "
            f"this card's{_remedy(stem)}"
        )
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed (cudaError {err})")
