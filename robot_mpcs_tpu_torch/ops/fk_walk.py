"""Forward kinematics of a link set: CUDA kernel wrapper and plain version.

Port of the JAX package's hand-written batch rule
``RobotKinematics._walk_scalar`` (``robot_mpcs_tpu/models/fk.py:289``), the
structure-of-arrays FK walk that its FK primitives take under ``vmap``
(``_with_jac_cv``, ``_fk_ad``): positions ``P (..., L, 3)`` of a set of links
and, on request, their geometric Jacobians ``J (..., L, 3, n)``, from one
walk of the chains' shared prefixes.

* On a CUDA tensor, ``fk_walk`` launches the hand-written kernel of
  ``csrc/fk_walk.cu`` (one thread per row of ``q``, its q and its output
  staged through shared memory; see the note at the top
  of that file), compiled at its first use for the robot's chain and the
  link set (``walk_table``: the chain's constants as ``-D`` defines, so
  that the compiler folds the walk as the JAX rule folds it) and loaded by
  ``ops/_build.py``. A missing ``nvcc`` or a failed build raises; there is
  no fallback.
* On a CPU tensor it runs ``fk_walk_reference``: the port's batched walk
  (``RobotKinematics.fk_pos_links_with_jac`` / ``fk_pos_links``, which
  ``fk_frame`` and ``fk_pos`` share), the kernel's oracle.

The solver's split rows (``MpcProblem.split_callbacks``' ``q_rows``) and the
fleet's end-effector positions take ``fk_walk`` through
``models/components.FkEval``; the rows that ``torch.func`` differentiates
(the ``values`` and generic paths) take the plain walk, chosen there.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from robot_mpcs_tpu_torch.models.fk import _FIXED, _PRISMATIC, _REVOLUTE
from robot_mpcs_tpu_torch.ops import _build

STEM = "fk_walk"


# ------------------------------------------------------------ the chain table


def _sym_mul(a, b):
    """A product in the JAX rule's symbolic walk: a float is a build-time
    constant, None a batched value; a constant 0 absorbs."""
    if (a is not None and a == 0.0) or (b is not None and b == 0.0):
        return 0.0
    return None if a is None or b is None else a * b


def _sym_add(*terms):
    return None if any(t is None for t in terms) else float(sum(terms))


def _sym_mm(A, B):
    return [[_sym_add(*(_sym_mul(A[i][k], B[k][j]) for k in range(3))) for j in range(3)] for i in range(3)]


def _sym_mv(A, v):
    return [_sym_add(*(_sym_mul(A[i][k], v[k]) for k in range(3))) for i in range(3)]


def _zeros(entries):
    return [int(e is not None and e == 0.0) for e in entries]


def _table(values) -> str:
    """A define's table: each value as ``FKV(value)``, which the source
    expands to ``value,``. A define holds no comma: ``nvcc`` would split the
    option there."""
    return "".join(f"FKV({v})" for v in values)


def _hex(values) -> str:
    """``_table`` of C++ hexadecimal float literals of ``values`` rounded to
    f32 (exact in a float), trailing zero digits dropped."""
    return _table(re.sub(r"\.?0*p", "p", float(np.float32(v)).hex()) + "f" for v in values)


@dataclass(frozen=True)
class WalkTable:
    """The tree walk of a robot's link set, as ``csrc/fk_walk.cu`` takes it:
    ``spec`` is its library's shape, the ``-D`` defines joined by spaces."""

    n: int
    n_links: int
    spec: str

    def define(self, key: str):
        """The value of define ``key``: an int, or a table's entries as
        strings (its padding entry included)."""
        value = dict(tok.split("=", 1) for tok in self.spec.split(" "))[key]
        if not value.startswith("FKV("):
            return int(value)
        return value[len("FKV("):-1].split(")FKV(")


def walk_table(kin, links: Sequence[str]) -> WalkTable:
    """The walk of ``links`` for ``kin``: its nodes in the order
    ``RobotKinematics._walk_links`` first reaches them (one per distinct
    chain prefix), each node's structural zeros from the JAX rule's
    symbolic walk (``_walk_scalar``: constants folded, a 0 absorbing), each
    link's node and each Jacobian column's joint node. Cached on ``kin``."""
    links = tuple(links)
    cache = kin.__dict__.setdefault("_walk_tables", {})
    if links in cache:
        return cache[links]
    diff = kin.base_type == "diffdrive"
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    if diff:  # Rz(theta) at (x, y, 0)
        R0, p0 = [[None, None, 0.0], [None, None, 0.0], [0.0, 0.0, 1.0]], [None, None, 0.0]
    else:
        R0, p0 = eye, [0.0, 0.0, 0.0]
    # per node: (kind, parent, q index, pre (12), axis (3), zero flags (27)), node 0 the base
    nodes = [(_FIXED, 0, -1, [*np.eye(3).ravel(), 0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
              [0] * 9 + _zeros(sum(R0, [])) + [0] * 3 + _zeros(p0) + [0] * 3)]
    state = [(R0, p0)]
    index, link_node = {(): 0}, []
    for link in links:
        key, parent = (), 0
        for seg in kin._compile(link):
            new = key + (kin._seg_key(seg),)
            if new not in index:
                R, p = state[parent]
                pre = seg.pre.astype(np.float32).astype(np.float64)
                axis = [float(a) for a in seg.axis.astype(np.float32)]
                preR = [[float(pre[i, j]) for j in range(3)] for i in range(3)]
                t = [float(pre[i, 3]) for i in range(3)]
                Rp = _sym_mm(R, preR)
                pp = [_sym_add(p[i], _sym_mv(R, t)[i]) for i in range(3)]
                w = _sym_mv(Rp, axis) if seg.kind != _FIXED else [0.0, 0.0, 0.0]
                if seg.kind == _REVOLUTE:
                    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                                  [-axis[1], axis[0], 0.0]])
                    K2 = K @ K
                    Ra = [[float(np.eye(3)[i, j] + K2[i, j]) if K[i, j] == 0.0 and K2[i, j] == 0.0 else None
                           for j in range(3)] for i in range(3)]
                    Rq, pq = _sym_mm(Rp, Ra), pp
                elif seg.kind == _PRISMATIC:
                    Rq, pq = Rp, [_sym_add(pp[i], _sym_mul(w[i], None)) for i in range(3)]
                else:
                    Rq, pq = Rp, pp
                index[new] = len(nodes)
                nodes.append((seg.kind, parent, seg.q_index, [*pre[:3, :3].ravel(), *pre[:3, 3]], axis,
                              _zeros(sum(Rp, [])) + _zeros(sum(Rq, [])) + _zeros(pp) + _zeros(pq) + _zeros(w)))
                state.append((Rq, pq))
            parent, key = index[new], new
        link_node.append(parent)
    n = kin.n
    col = [[0] * n for _ in links]
    for l, node in enumerate(link_node):
        while node:
            kind, parent, qi = nodes[node][:3]
            if kind != _FIXED:
                col[l][qi] = node
            node = parent
    pad = [(_FIXED, 0, -1, [0.0] * 12, [0.0] * 3, [0] * 27)]  # no table is empty
    table = nodes + pad
    defines = {
        "FK_N": n, "FK_S": len(nodes) - 1, "FK_L": len(links), "FK_DIFFDRIVE": int(diff),
        "FK_NODE": _table(v for k, par, qi, *_ in table for v in (k, par, qi)),
        "FK_PRE": _hex(v for node in table for v in node[3]),
        "FK_AXIS": _hex(v for node in table for v in node[4]),
        "FK_ZERO": _table(z for node in table for z in node[5]),
        "FK_LINK": _table(link_node + [0]),
        "FK_COL": _table(sum(col, []) + [0]),
    }
    cache[links] = WalkTable(n, len(links), " ".join(f"{k}={v}" for k, v in defines.items()))
    return cache[links]


# ----------------------------------------------------------------- plain version


def fk_walk_reference(kin, q: torch.Tensor, links: Sequence[str], want_jac: bool):
    """The port's batched walk: ``(P (..., L, 3), J (..., L, 3, n) | None)``."""
    if want_jac:
        return kin.fk_pos_links_with_jac(q, links)
    return kin.fk_pos_links(q, links), None


# ------------------------------------------------------------------ the kernel


def build_kernel(table: WalkTable) -> ctypes.CDLL:
    """Compile (once per hash of source, flags and chain) and load the
    kernel library of ``table``."""
    lib = _build.load_library(STEM, (table.spec,))
    fn = lib.fk_walk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@_build.counted
def fk_walk(kin, q: torch.Tensor, links: Sequence[str], want_jac: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Positions ``P (..., L, 3)`` of ``links`` at ``q (..., n)`` and, with
    ``want_jac``, their geometric Jacobians ``J (..., L, 3, n)`` (else None).

    A CUDA tensor launches the kernel, counted in ``fk_walk.launches`` by
    ``q.shape[0]`` (the solver's lanes); ``q`` is read in place where its
    rows are evenly strided (a slice of the solver's states). A CPU tensor
    runs the plain version. Any other device raises."""
    dev = q.device
    if dev.type == "cpu":
        return fk_walk_reference(kin, q, links, want_jac)
    if dev.type != "cuda":
        raise ValueError(f"fk_walk: no kernel for device {dev}")
    if q.dtype != torch.float32:
        raise TypeError(f"fk_walk: q is {q.dtype}, the kernel takes float32")
    table = walk_table(kin, links)
    lead, n, L = q.shape[:-1], table.n, table.n_links
    if q.shape[-1] != n:
        raise ValueError(f"fk_walk: q has {q.shape[-1]} columns, the chain {n}")
    M = int(np.prod(lead, dtype=np.int64))
    rows = q.reshape(M, n)  # a view where the rows are evenly strided
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    P = torch.empty(lead + (L, 3), dtype=torch.float32, device=dev)
    J = torch.empty(lead + (L, 3, n), dtype=torch.float32, device=dev) if want_jac else None
    if M == 0:
        return P, J
    lib = build_kernel(table)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fk_walk_launch(rows.data_ptr(), rows.stride(0), M, n, L, P.data_ptr(),
                                 J.data_ptr() if want_jac else None, int(want_jac), stream)
    _build.raise_for_status("fk_walk", err, STEM, (table.spec,))
    _build.count_launch(fk_walk, q.shape[0] if q.dim() > 1 else 1, dev)
    return P, J
