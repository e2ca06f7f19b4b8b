"""CUDA conditional WHILE nodes: the solver's loops on the device.

The JAX solver's three loops are ``lax.while_loop``s under ``jax.jit``: their
conditions are tested on the device and a solve is one program
(``robot_mpcs_tpu/solver/al_ilqr.py:750, 818, 890``). The port's counterpart
is a CUDA graph captured whole (``solver/units.py``) in which each loop is a
conditional WHILE node (CUDA 12.4 and newer, nested):

    with while_node(flag):   # flag: a 0-d bool CUDA tensor the body rewrites
        ...                  # the loop's body, captured once

``while_node`` is used inside a running capture. A one-thread kernel sets
the node's handle from ``flag`` before the node; the block is captured into
the node's body graph on a stream of its own (one per nesting depth); a
one-thread kernel at the end of the body sets the handle from ``flag`` again
(``csrc/graph_cond.cu``, a plain C library built at first use like the
kernels, ``ops/_build.py``). The node then runs its body while ``flag`` holds,
zero times if it is false at entry, with no host read.

What the body allocates goes to a memory pool of the capture (one per
depth, ``Capture.pools``, kept as long as the graph that uses it), routed by
PyTorch's caching allocator for the body's stream
(``_cuda_beginAllocateCurrentStreamToPool``), as PyTorch's own
``CUDAGraph.begin_capture_to_if_node`` routes an IF node's body: without it
the body's first allocation fails while its stream captures. No tensor that
a body allocates may be read after its node: the loops pass data through
the solver's carry, allocated before the capture. Nor may a body's pool
hold what outlives the graph: before a capture, each body runs eagerly on
its stream (``eager_body``), so that a library's per-stream state (cuBLAS'
workspace) is allocated outside the pools.

A card or a driver without these nodes has no fallback: ``require`` raises
and names what is missing.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from robot_mpcs_tpu_torch.ops import _build

STEM = "graph_cond"
#: CUDA runtime and driver versions from which WHILE nodes nest (12.4)
MIN_VERSION = 12040
#: the solver's loops nest three deep (AL, inner iLQR, line search)
NESTING = 3

#: the capture under way (``capturing``), else None
_capture: Optional["Capture"] = None
#: the nesting depth of the WHILE node being captured (0: none)
_depth = 0
#: the body stream of each (device, depth)
_streams: Dict[Tuple[torch.device, int], torch.cuda.Stream] = {}


class Capture:
    """What one program's capture keeps beside its graph: the memory pools
    of its WHILE bodies (one per depth; they must live as long as the
    graph), and the bodies captured and the nodes in them (the top-level
    nodes of a body; a nested WHILE node counts one there)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pools: List[torch.cuda.MemPool] = []
        self.bodies = 0
        self.body_nodes = 0


def library() -> ctypes.CDLL:
    """``csrc/graph_cond.cu``'s library, built at first use."""
    lib = _build.load_library(STEM, ())
    if not getattr(lib, "_typed", False):
        ptr, u64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)
        lib.graph_cond_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_cond_while_begin.argtypes = [ptr, ptr, ptr, u64p, ctypes.POINTER(ptr)]
        lib.graph_cond_while_end.argtypes = [ptr, ctypes.c_ulonglong, ptr, u64p]
        lib.graph_cond_abort.argtypes = [ptr]
        lib.graph_cond_count_nodes.argtypes = [ptr, u64p]
        for fn in (lib.graph_cond_versions, lib.graph_cond_while_begin, lib.graph_cond_while_end,
                   lib.graph_cond_abort, lib.graph_cond_count_nodes):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def versions() -> Tuple[int, int]:
    """(CUDA runtime the library was built with, driver), as 12040 for 12.4."""
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _check(library().graph_cond_versions(ctypes.byref(runtime), ctypes.byref(driver)), "versions")
    return runtime.value, driver.value


def missing(device: torch.device) -> str:
    """Why ``device`` cannot run the solver's WHILE nodes, or "" if it can."""
    if device.type != "cuda":
        return f"{device} is not a CUDA device"
    if not hasattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool"):
        return f"torch {torch.__version__} cannot route a body's allocations to a pool"
    runtime, driver = versions()
    if min(runtime, driver) < MIN_VERSION:
        return f"CUDA runtime {runtime} and driver {driver}; nested WHILE nodes need {MIN_VERSION}"
    return ""


def require(device: torch.device) -> None:
    """Raise unless ``device`` runs conditional WHILE nodes (no fallback)."""
    why = missing(device)
    if why:
        raise RuntimeError(f"the solver's loops need CUDA conditional graph nodes (WHILE): {why}")


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph_cond {what} failed (cudaError {err})")


def _stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The body stream of ``device`` at nesting ``depth``, made at first use."""
    key = (device, depth)
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(device)
    return _streams[key]


def body_streams(device: torch.device) -> List[torch.cuda.Stream]:
    """The body streams of ``device`` at depths 1 to ``NESTING`` and any
    deeper one made so far."""
    device = _build.indexed(device)
    deepest = max([NESTING] + [d for dev, d in _streams if dev == device])
    return [_stream(device, depth) for depth in range(1, deepest + 1)]


@contextlib.contextmanager
def eager_body(device: torch.device):
    """Run the block, one trip of a loop's body, eagerly on the body stream
    of its depth: the warm-up of a WHILE body. What a library sets up per
    stream at first use (cuBLAS' workspace) is then allocated here, outside
    any capture, and never inside a body's pool, which dies with its graph
    while the library keeps using it."""
    global _depth
    device = _build.indexed(device)
    depth = _depth + 1
    body, parent = _stream(device, depth), torch.cuda.current_stream(device)
    body.wait_stream(parent)
    _depth = depth
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        _depth = depth - 1
        parent.wait_stream(body)


@contextlib.contextmanager
def capturing(device: torch.device):
    """Declare a program's capture on ``device`` for the WHILE nodes in the
    block; yields its ``Capture``."""
    global _capture
    before, _capture = _capture, Capture(_build.indexed(device))
    try:
        yield _capture
    finally:
        _capture = before


@contextlib.contextmanager
def while_node(flag: torch.Tensor):
    """Capture the block as the body of a WHILE node on ``flag`` (a 0-d bool
    tensor on the card), inside a capture declared by ``capturing``."""
    global _depth
    cap = _capture
    if cap is None:
        raise RuntimeError("while_node: no program capture is under way")
    if flag.dtype != torch.bool or flag.numel() != 1 or flag.device != cap.device:
        raise ValueError(f"while_node: flag must be one bool on {cap.device}, got {flag.dtype}"
                         f"{tuple(flag.shape)} on {flag.device}")
    lib, dev = library(), cap.device
    depth = _depth + 1
    while len(cap.pools) < depth:
        cap.pools.append(torch.cuda.MemPool())
    mem = cap.pools[depth - 1]
    body = _stream(dev, depth)
    handle, graph, nodes = ctypes.c_ulonglong(), ctypes.c_void_p(), ctypes.c_ulonglong()
    parent = torch.cuda.current_stream(dev).cuda_stream
    _check(lib.graph_cond_while_begin(parent, flag.data_ptr(), body.cuda_stream,
                                      ctypes.byref(handle), ctypes.byref(graph)), "while_begin")
    _depth = depth
    try:
        with torch.cuda.stream(body):
            # routing to a pool takes a reference to it; give it back after
            # (``torch.cuda.use_mem_pool`` does the same), the MemPool keeps its own
            uses = mem.use_count()
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, mem.id)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, mem.id)
                if mem.use_count() > uses:
                    torch._C._cuda_releasePool(dev.index, mem.id)
            _check(lib.graph_cond_while_end(body.cuda_stream, handle, flag.data_ptr(),
                                            ctypes.byref(nodes)), "while_end")
    except BaseException:
        lib.graph_cond_abort(body.cuda_stream)
        raise
    finally:
        _depth = depth - 1
    cap.bodies += 1
    cap.body_nodes += nodes.value


def count_nodes(graph: int) -> int:
    """Top-level nodes of the ``cudaGraph_t`` ``graph`` (a WHILE node counts one)."""
    n = ctypes.c_ulonglong()
    _check(library().graph_cond_count_nodes(ctypes.c_void_p(graph), ctypes.byref(n)), "count_nodes")
    return n.value
