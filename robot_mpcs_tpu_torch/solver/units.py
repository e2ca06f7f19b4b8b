"""The solver's loop bodies as units over a carry, and their CUDA graphs.

The JAX solver is ``jax.jit(jax.vmap(solve))``: each ``lax.while_loop``
(line search, inner iLQR, outer AL) runs on the device, and XLA compiles
each body once. The port's counterpart is a ``UnitProgram``: each loop body
is a *unit*, a function of a **carry** (a dict of tensors preallocated per
batch shape, as ``lax.while_loop``'s carry) that returns the carry entries
it updates. The program writes them back with ``copy_``. A unit never reads
a tensor's value on the host. The host loop between the units stays the
trip-count authority: it reads one flag the previous unit left in the
carry (``any_*``), as the eager loop read ``active.any()``.

On a CUDA device each unit is captured once per program as a
``torch.cuda.CUDAGraph`` after one eager run on a side stream (the
warm-up, which is also that call's real work: it builds or loads a kernel
library at first use and sets up cuBLAS for the stream), and replayed after
that. The graphs of one program allocate their temporaries from one memory
pool, which is safe because no tensor of a graph outlives its replay: units
pass data only through the carry, which is allocated outside any graph. A
unit that fails to capture raises ``RuntimeError`` naming the unit; there is
no fallback. On the CPU the units run eagerly (the plain version the tests
use). A CUDA graph cannot be serialised: a process captures its own at the
first solve of each batch shape.

The kernel wrappers count their launches through ``_build.count_launch``.
During a capture a launch is recorded and not counted (nothing ran); each
replay counts the launches its unit recorded, so the wrappers' counters and
their listeners see the same launches, batch by batch, as an eager run.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict

import torch

from robot_mpcs_tpu_torch.ops import _build

#: False while ``_eager()`` is entered: the units then run eagerly on the card
#: too. A check against the graphs, not an option of the solver.
_GRAPHS = True
#: the side stream of each CUDA device
_streams: Dict[torch.device, torch.cuda.Stream] = {}
#: graph replays in this process, all programs together
replays = 0


@contextlib.contextmanager
def _eager():
    """Run the solver's units eagerly on the card while the block runs: the
    private switch the card's checks hold the graphs against, not an option
    of the solver."""
    global _GRAPHS
    before, _GRAPHS = _GRAPHS, False
    try:
        yield
    finally:
        _GRAPHS = before


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(dev)
    return _streams[dev]


class UnitProgram:
    """The units of one solver at one batch shape, over one carry.

    ``units`` maps a name to ``fn(carry) -> {entry: tensor}``. ``run(name)``
    runs a unit: eagerly on the CPU (or under ``_eager()``), else by
    replaying its graph, captured at its first run. The carry's entries are
    allocated at their first write, with the dtype and shape the unit
    produced; a later write of another dtype or shape raises. A unit
    returns no carry entry that it also writes (the writes happen in
    turn)."""

    def __init__(self, units: Dict[str, Callable], device: torch.device):
        self.units = units
        self.device = device
        self.carry: Dict[str, torch.Tensor] = {}
        self._graphs: Dict[str, tuple] = {}
        self._pool = None  # the memory pool of this program's graphs

    def load(self, **inputs) -> None:
        """Copy the caller's tensors into the carry's static inputs (never
        capture the caller's tensors: a replay reads the carry)."""
        for name, value in inputs.items():
            dst = self.carry.get(name)
            if dst is None or dst.shape != value.shape or dst.dtype != value.dtype:
                self.carry[name] = torch.empty_like(value, device=self.device)
            self.carry[name].copy_(value)

    def _write(self, out: Dict[str, torch.Tensor]) -> None:
        carry = self.carry
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

    def _step(self, name: str) -> None:
        self._write(self.units[name](self.carry))

    def run(self, name: str) -> None:
        if self.device.type != "cuda" or not _GRAPHS:
            self._step(name)
            return
        global replays
        entry = self._graphs.get(name)
        if entry is None:
            entry = self._graphs[name] = self._capture(name)
            return
        graph, launches = entry
        graph.replay()
        replays += 1
        for op, batch in launches:
            _build.count_launch(op, batch)

    def _capture(self, name: str):
        """Warm up on the side stream (the call's real work), then capture."""
        dev = self.device
        side, current = _side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            self._step(name)
            side.synchronize()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # no garbage collection during the capture: collecting a dead
            # program destroys its graphs, a call a capture does not permit
            gc_enabled = gc.isenabled()
            gc.disable()
            try:
                with _build.recording_launches() as launches:
                    # thread-local: a call another thread makes meanwhile
                    # (NCCL's watchdog) cannot invalidate this capture
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        self._step(name)
                    except BaseException as err:
                        with contextlib.suppress(BaseException):
                            graph.capture_end()
                        raise RuntimeError(
                            f"solver unit {name!r} could not be captured as a CUDA graph: {err}"
                        ) from err
                    graph.capture_end()
            finally:
                if gc_enabled:
                    gc.enable()
        current.wait_stream(side)
        return graph, tuple(launches)
