"""The solver's loop bodies as units over a carry, captured whole as one CUDA graph.

The JAX solver is ``jax.jit(jax.vmap(solve))``: each ``lax.while_loop``
(line search, inner iLQR, outer AL) runs on the device, and XLA compiles
the whole solve as one program. The port's counterpart is a
``UnitProgram``: each loop body is a *unit*, a function of a **carry** (a
dict of tensors preallocated per batch shape, as ``lax.while_loop``'s
carry) that returns the carry entries it updates. The program writes them
back with ``copy_``. A unit never reads a tensor's value on the host. A
driver runs the units and guards each loop with ``prog.loop(flag)``:

    prog.run("prologue")
    for _ in prog.loop("any_al"):
        ...

``prog.call(driver)`` runs a driver. On the CPU, and under the private
``_eager()``, the driver runs as written and ``loop`` reads its flag on the
host before each trip (the plain version, which the card's checks hold the
graph against). On a CUDA device the first call is the warm-up, run eagerly
on a side stream, each loop's body on a stream of its depth (the call's
real work: it builds or loads the kernel libraries at first use and sets
up cuBLAS for each stream outside any capture); each unit that did not run
in it then runs on a scratch copy of the carry, its launches not counted. Then the driver is captured once as one
``torch.cuda.CUDAGraph``, in which every ``loop`` is a conditional WHILE
node that tests its flag on the device (``ops/graph_cond.py``); each later
call is one replay, with no host read. A card without such nodes raises:
there is no fallback.

Programs nest: a driver may call other programs (the fleet step calls its
solves, ``parallel/fleet.py``). While a program warms up or is captured,
every program it calls runs inline, inside its warm-up or its capture, so
the outer program is the one graph. The graph's temporaries come from one
memory pool and each WHILE body's from a pool of its depth; no tensor that
a graph allocates outlives its replay, since data crosses a node only
through the carry, and what a caller keeps is cloned out of it. A unit
that fails to capture raises ``RuntimeError`` naming the unit. A CUDA graph
cannot be serialised: a process captures its own at the first call of each
program.

The kernel wrappers count their launches through ``_build.count_launch``:
inside a capture each launch also captures an increment of a counter on the
device, so that every replay counts the launches its loops ran
(``_build.launch_counts``), batch by batch, as an eager run does.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
from typing import Callable, Dict, Optional

import torch

from robot_mpcs_tpu_torch.ops import _build, graph_cond

#: False while ``_eager()`` is entered: programs then run their drivers
#: eagerly on the card too. A check against the graphs, not an option of the solver.
_GRAPHS = True
#: what an enclosing program is doing while nested programs run: None,
#: "warmup" (its first call, eager) or "capture"
_mode: Optional[str] = None
#: the programs that ran in the enclosing warm-up
_warmed: list = []
#: the side stream of each CUDA device
_streams: Dict[torch.device, torch.cuda.Stream] = {}
#: graph replays in this process, all programs together
replays = 0


class CaptureError(RuntimeError):
    """A unit could not be captured into its program's CUDA graph."""


@contextlib.contextmanager
def _eager():
    """Run every program's driver eagerly on the card while the block runs:
    the private switch the card's checks hold the graphs against, not an
    option of the solver."""
    global _GRAPHS
    before, _GRAPHS = _GRAPHS, False
    try:
        yield
    finally:
        _GRAPHS = before


def _host_flag(flag: torch.Tensor) -> bool:
    """A loop's test on the host: the plain version's one read per trip."""
    return bool(flag)


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(dev)
    return _streams[dev]


class UnitProgram:
    """The units of one solver at one batch shape (or one fleet step), over
    one carry.

    ``units`` maps a name to ``fn(carry) -> {entry: tensor}``; ``run(name)``
    runs one and writes its entries back. The carry's entries are allocated
    at their first write, with the dtype and shape the unit produced; a
    later write of another dtype or shape raises. A unit returns no carry
    entry that it also writes (the writes happen in turn). After a CUDA
    capture, ``stats`` holds the graph's node count, the bodies captured and
    the seconds the warm-up, capture and instantiation took."""

    def __init__(self, units: Dict[str, Callable], device: torch.device):
        self.units = units
        self.device = device
        self.carry: Dict[str, torch.Tensor] = {}
        self.stats: Dict[str, float] = {}
        self._ran: set = set()
        self._graph = None
        self._capture = None  # the graph's body pools (graph_cond.Capture)

    def load(self, **inputs) -> None:
        """Copy the caller's tensors into the carry's static inputs (never
        capture the caller's tensors: a replay reads the carry)."""
        for name, value in inputs.items():
            dst = self.carry.get(name)
            if dst is None or dst.shape != value.shape or dst.dtype != value.dtype:
                self.carry[name] = torch.empty_like(value, device=self.device)
            self.carry[name].copy_(value)

    def _write(self, carry: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor]) -> None:
        for name, value in out.items():
            dst = carry.get(name)
            if dst is None:  # its own storage: a result may be another entry
                carry[name] = value.clone()
                continue
            if dst.shape != value.shape or dst.dtype != value.dtype:
                raise RuntimeError(
                    f"solver unit wrote {name} as {value.dtype}{tuple(value.shape)} "
                    f"over {dst.dtype}{tuple(dst.shape)}"
                )
            dst.copy_(value)

    def run(self, name: str) -> None:
        """Run the unit ``name`` on the carry (into the capture, if one is
        under way)."""
        self._ran.add(name)
        if _mode != "capture":
            self._write(self.carry, self.units[name](self.carry))
            return
        try:
            self._write(self.carry, self.units[name](self.carry))
        except CaptureError:
            raise
        except Exception as err:
            raise CaptureError(f"solver unit {name!r} could not be captured as a CUDA graph: {err}") from err

    def loop(self, name: str):
        """The guard of a loop on the carry's bool ``name``: iterate once per
        trip while it holds. Inside a capture, one WHILE node whose body is
        the loop's body, captured once; else a host read before each trip."""
        flag = self.carry[name]
        if _mode == "capture":
            with graph_cond.while_node(flag):
                yield
            return
        warmup = _mode == "warmup" and self.device.type == "cuda"
        while _host_flag(flag):
            with graph_cond.eager_body(self.device) if warmup else contextlib.nullcontext():
                yield

    def graphed(self) -> bool:
        """Whether ``call`` captures and replays (a CUDA device, outside ``_eager()``)."""
        return self.device.type == "cuda" and _GRAPHS

    def call(self, driver: Callable[[], None]) -> None:
        """Run ``driver()``, which runs this program's units and loops: as it
        is on the CPU, under ``_eager()`` and inside an enclosing program's
        warm-up or capture; else as this program's CUDA graph, warmed up and
        captured at the first call and replayed at every later one."""
        global replays
        if not self.graphed() or _mode is not None:
            if _mode == "warmup":
                _warmed.append(self)
            driver()
        elif self._graph is None:
            self._compile(driver)
        else:
            self._graph.replay()
            replays += 1

    def _scratch_missing(self) -> None:
        """Run each unit the warm-up did not, in order, on a scratch copy of
        the carry, on the side stream and on every body stream (its depth is
        not known; ``graph_cond.body_streams``): what it builds or sets up at first use must not happen
        in the capture, and the carry entries it creates must exist before
        it (allocated outside the graph's pools). Not counted."""
        missing = [name for name in self.units if name not in self._ran]
        if not missing:
            return
        for stream in [torch.cuda.current_stream(self.device), *graph_cond.body_streams(self.device)]:
            scratch = {k: v.clone() for k, v in self.carry.items()}
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream), _build.not_counted():
                for name in missing:
                    self._write(scratch, self.units[name](scratch))
            torch.cuda.current_stream(self.device).wait_stream(stream)
            for k, v in scratch.items():
                if k not in self.carry:
                    self.carry[k] = torch.empty_like(v)
        self._ran.update(missing)

    def _compile(self, driver: Callable[[], None]) -> None:
        """Warm up on the side stream (the call's real work), then capture
        the driver as one graph with its loops as WHILE nodes, and
        instantiate it."""
        global _mode, _warmed
        dev = self.device
        graph_cond.require(dev)
        _build.device_counters(dev)
        side, current = _side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            t0 = time.perf_counter()
            _mode, _warmed = "warmup", [self]
            try:
                driver()
            finally:
                _mode = None
            for prog in dict.fromkeys(_warmed):
                prog._scratch_missing()
            _warmed = []
            side.synchronize()
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # no garbage collection during the capture: collecting a dead
            # program destroys its graph, a call a capture does not permit
            gc_enabled = gc.isenabled()
            gc.disable()
            try:
                with graph_cond.capturing(dev) as cap:
                    # thread-local: a call another thread makes meanwhile
                    # (NCCL's watchdog) cannot invalidate this capture
                    graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                        capture_error_mode="thread_local")
                    _mode = "capture"
                    try:
                        driver()
                    except BaseException:
                        with contextlib.suppress(BaseException):
                            graph.capture_end()
                        # a graph whose WHILE body's capture was cut short
                        # cannot be destroyed: the driver freed the body when
                        # it invalidated its capture, and cudaGraphDestroy of
                        # the graph then faults. It is never replayed; an
                        # extra reference keeps it for the process.
                        ctypes.pythonapi.Py_IncRef(ctypes.py_object(graph))
                        raise
                    finally:
                        _mode = None
                    graph.capture_end()
            finally:
                if gc_enabled:
                    gc.enable()
            t2 = time.perf_counter()
            graph.instantiate()
            side.synchronize()
            t3 = time.perf_counter()
        current.wait_stream(side)
        self._graph, self._capture = graph, cap
        self.stats = {
            "nodes": graph_cond.count_nodes(graph.raw_cuda_graph()) + cap.body_nodes,
            "while_bodies": cap.bodies,
            "warmup_s": t1 - t0, "capture_s": t2 - t1, "instantiate_s": t3 - t2,
        }
