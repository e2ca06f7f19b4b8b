"""Gauss-Newton assembly of the split expansion: CUDA kernel wrapper and
plain version.

Port of the JAX package's hand-written batch rule ``_gn_assemble_vmap``
(``robot_mpcs_tpu/solver/al_ilqr.py:228``, the ``vmap`` rule of
``gn_assemble``) fused with the per-row coefficients it is fed (``_coefs``,
``_expansion_coefs``): from the split form's rows (``vq`` and their
q-Jacobian ``Jq``, the affine rows ``va`` with their constant Jacobian
``S_aff``), the weights, the multipliers and the lane's penalty, the
Riccati blocks ``(lx, lw, lxx, lxw, lww)`` of the augmented-Lagrangian
Gauss-Newton model at every (lane, stage).

* On a CUDA tensor, ``gn_assemble`` launches the hand-written kernel of
  ``csrc/gn_assemble.cu`` (a warp's 32 lanes on 32 (lane, stage) items, the
  block's warps on their entries; see the note at the top of that file),
  compiled for the problem's segment sizes at its first use and loaded by
  ``ops/_build.py``. A missing ``nvcc``, a failed build or a shape whose
  block does not fit the card's shared memory raises; there is no
  fallback.
* On a CPU tensor it runs ``gn_assemble_reference``, the plain batched
  PyTorch assembly (two products against ``S_aff`` and its row outer
  products, the q-family Gram product, the slack column, the upper
  triangle mirrored), the kernel's oracle.

``GnLayout`` holds what both need, made once per solver: the segment sizes,
``S_aff`` for the plain version and, for the kernel, its non-zeros (the JAX
rule's ``_S_nz``) re-indexed by the output entry they feed, in the kernel's
static entry schedule (``entry_schedule``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from robot_mpcs_tpu_torch.models.components import BARRIER_EPS
from robot_mpcs_tpu_torch.ops import _build

STEM = "gn_assemble"


def gn_coefs(r, wr, b, wb, c, lam_seg, mu3):
    """Per-row (gradient, curvature) scalars of the AL model: residual rows
    w r^2, barrier rows w / b, constraint rows PHR (``c`` shifted already)."""
    act = torch.clamp(lam_seg - mu3 * c, min=0.0)
    # barrier rows are RAW clearances; inside the BARRIER_EPS clamp the
    # barrier contributes zero gradient/curvature (the AL constraint
    # supplies the restoring force there)
    live = b > BARRIER_EPS
    bs = torch.clamp(b, min=BARRIER_EPS)
    g = torch.cat([2.0 * wr * r, torch.where(live, -wb / (bs * bs), 0.0), -act], -1)
    h = torch.cat(
        [
            (2.0 * wr).expand_as(r),
            torch.where(live, torch.clamp(2.0 * wb / (bs * bs * bs), min=0.0), 0.0),
            mu3 * (act > 0),
        ],
        -1,
    )
    return g, h


def entry_tables(S_aff: np.ndarray):
    """The non-zeros of ``S_aff (n_arows, nv)`` (the JAX rule's ``_S_nz``),
    re-indexed by the output entry they feed, as CSR tables in row order:
    gradient entry i takes ``S[r, i] g_a[r]``, upper entry (i, j >= i) of H
    (row by row) takes ``S[r, i] S[r, j] h_a[r]``. Returns ``(grad_ptr,
    grad_row, grad_coef, pair_ptr, pair_row, pair_coef)`` (int32, float32)."""
    S = np.asarray(S_aff, np.float32)
    nv = S.shape[1]
    nz = [[(j, S[r, j]) for j in range(nv) if S[r, j] != 0.0] for r in range(S.shape[0])]
    grad = [[] for _ in range(nv)]
    pair = {}
    for r, row in enumerate(nz):
        for i, ci in row:
            grad[i].append((r, ci))
            for j, cj in row:
                if j >= i:
                    pair.setdefault((i, j), []).append((r, np.float32(ci * cj)))
    upper = [(i, j) for i in range(nv) for j in range(i, nv)]
    pairs = [pair.get(ij, []) for ij in upper]

    def csr(lists):
        ptr = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
        row = np.asarray([r for x in lists for r, _ in x], np.int32)
        coef = np.asarray([c for x in lists for _, c in x], np.float32)
        return ptr, row, coef

    return csr(grad) + csr(pairs)


#: the kinds of schedule entries (``csrc/gn_assemble.cu`` ``Kind``): besides
#: its CSR terms, a gradient entry i < n_q takes the q rows, i = nx the slack
#: column's; an upper entry (i, j) with j < n_q the q rows' products, (i <
#: n_q, nx) and (nx, nx) the slack column's terms
ENTRY_KINDS = ("grad_aff", "grad_q", "grad_slack", "hess_aff", "hess_q", "hess_slack_q", "hess_slack")


def entry_schedule(S_aff: np.ndarray, *, nx: int, n_q: int, ns: int, qc: int):
    """The kernel's static entry schedule and its terms, from ``entry_tables``:
    ``sched (n_live, 4)`` int32, one row per live entry (of the nv gradient
    entries and the nv (nv + 1) / 2 upper entries of H, those with a term:
    the rest are 0, which the kernel writes once per block), and ``terms
    (n_terms, 2)`` int32, each (affine row, coefficient's f32 bits), an
    entry's terms contiguous and in their CSR order. A row of ``sched``:
    ``begin | count << 16`` (its terms), ``kind | i << 8 | j << 16``
    (``ENTRY_KINDS``), and the one or two places it is written to, each
    ``block << 16 | offset`` (block 0..4 = lx, lw, lxx, lxw, lww; the offset
    in one item's block; -1 for none: a diagonal entry of lxx or lww, an
    entry of lxw or of the gradient). The rows are ordered by kind, then by
    their terms' count: the kernel's warps take rows w, w + 8, ..., so each
    takes about an eighth of each kind, and the 32 lanes of a warp (32
    items) run the same row."""
    grad_ptr, grad_row, grad_coef, pair_ptr, pair_row, pair_coef = entry_tables(S_aff)
    nv = S_aff.shape[1]
    nw = nv - nx
    slack = bool(ns and qc)
    kinds = {name: k for k, name in enumerate(ENTRY_KINDS)}

    def place(i, j):
        if j < nx:
            return 2 << 16 | (i * nx + j)
        if i < nx:
            return 3 << 16 | (i * nw + j - nx)
        return 4 << 16 | ((i - nx) * nw + j - nx)

    rows = []  # (kind, count, begin, i, j, place, mirror)
    for i in range(nv):
        kind = "grad_q" if i < n_q else ("grad_slack" if slack and i == nx else "grad_aff")
        out = (0 << 16 | i) if i < nx else (1 << 16 | (i - nx))
        rows.append((kinds[kind], int(grad_ptr[i + 1] - grad_ptr[i]), int(grad_ptr[i]), i, i, out, -1))
    n_grad = int(grad_ptr[-1])
    upper = [(i, j) for i in range(nv) for j in range(i, nv)]
    for u, (i, j) in enumerate(upper):
        if j < n_q:
            kind = "hess_q"
        elif slack and j == nx and i < n_q:
            kind = "hess_slack_q"
        elif slack and i == j == nx:
            kind = "hess_slack"
        else:
            kind = "hess_aff"
        mirror = place(j, i) if i != j and (j < nx or i >= nx) else -1
        rows.append((kinds[kind], int(pair_ptr[u + 1] - pair_ptr[u]), n_grad + int(pair_ptr[u]), i, j,
                     place(i, j), mirror))
    # an affine-only entry with no term is 0 in every item: not scheduled
    affine_only = (kinds["grad_aff"], kinds["hess_aff"])
    rows = sorted((r for r in rows if r[1] or r[0] not in affine_only), key=lambda r: (r[0], r[1]))
    sched = np.asarray([(begin | count << 16, kind | i << 8 | j << 16, out, mirror)
                        for kind, count, begin, i, j, out, mirror in rows], np.int32).reshape(-1, 4)
    coefs = np.concatenate([grad_coef, pair_coef]).astype(np.float32)
    terms = np.stack([np.concatenate([grad_row, pair_row]).astype(np.int32), coefs.view(np.int32)], 1)
    return sched, terms.reshape(-1, 2)


class GnLayout:
    """The split expansion's constants for one solver on ``device``: the row
    segments ``q_seg = (qr, qb, qc)``, ``aff_seg = (ar, ab, ac)``, ``nx``,
    ``ns``, ``nw``, ``n_q``, ``S_aff`` (and its row outer products) for the
    plain version, ``entry_schedule``'s tables for the kernel (``tables``:
    the schedule of ``n_live`` rows and its ``n_terms`` terms), and ``c_off
    (N, n_con)``, the stage-0 pin's offsets. Made once, before any
    capture."""

    def __init__(self, q_seg, aff_seg, S_aff, *, nx: int, ns: int, n_q: int, c_off: torch.Tensor):
        self.q_seg, self.aff_seg = tuple(q_seg), tuple(aff_seg)
        S_np = np.asarray(S_aff, np.float32)
        self.nx, self.ns, self.n_q = nx, ns, n_q
        self.nv = S_np.shape[1]
        self.nw = self.nv - nx
        self.c_off = c_off
        dev = c_off.device
        f32 = dict(dtype=torch.float32, device=dev)
        n_arows = sum(self.aff_seg)
        self.S = torch.as_tensor(S_np, **f32)  # (n_arows, nv)
        self.S_outer = torch.as_tensor(
            np.einsum("ki,kj->kij", S_np, S_np).reshape(n_arows, self.nv * self.nv), **f32
        )
        self.upper = torch.ones((self.nv, self.nv), dtype=torch.bool, device=dev).triu()
        sched, terms = entry_schedule(S_np, nx=nx, n_q=n_q, ns=ns, qc=self.q_seg[2])
        self.n_live, self.n_terms = sched.shape[0], terms.shape[0]
        self.tables = tuple(torch.as_tensor(t, device=dev) for t in (sched, terms))

    @property
    def shape(self) -> Tuple[int, ...]:
        """The kernel's shape: ``(qr, qb, qc, ar, ab, ac, n_q, nx, nw, ns)``."""
        return (*self.q_seg, *self.aff_seg, self.n_q, self.nx, self.nw, self.ns)


# ----------------------------------------------------------------- plain version


def _row_coefs(vq, va, wrq, wbq, wra, wba, lam, mu, W, layout: GnLayout):
    """Per-row (gradient, curvature) of both families: ``(gq, hq, ga, ha)``,
    the q constraint rows slack-shifted (``ns`` > 0) and pinned (``c_off``)."""
    qr, qb, qc = layout.q_seg
    ar, ab, ac = layout.aff_seg
    if layout.ns and qc:
        # slack-shift the q-family module constraint rows (the affine
        # family shifts its own rows inside aff_rows)
        vq = torch.cat([vq[..., : qr + qb], vq[..., qr + qb :] + W[..., :1]], -1)
    cq = vq[..., qr + qb :] + layout.c_off[:, :qc]
    ca = va[..., ar + ab :] + layout.c_off[:, qc:]
    mu3 = mu[:, None, None]
    gq, hq = gn_coefs(vq[..., :qr], wrq, vq[..., qr : qr + qb], wbq, cq, lam[..., :qc], mu3)
    ga, ha = gn_coefs(va[..., :ar], wra, va[..., ar : ar + ab], wba, ca, lam[..., qc:], mu3)
    return gq, hq, ga, ha


def _assemble(gq, hq, ga, ha, Jq, S, S_outer, layout: GnLayout):
    """The blocks from the rows' coefficients, ``Jq`` and ``S_aff``."""
    qr, qb, qc = layout.q_seg
    nx, n_q, nv = layout.nx, layout.n_q, layout.nv
    g = ga @ S  # (B, N, nv)
    H = (ha @ S_outer).reshape(ha.shape[:-1] + (nv, nv))
    if qr + qb + qc:
        g[..., :n_q] += (gq.unsqueeze(-2) @ Jq).squeeze(-2)
        H[..., :n_q, :n_q] += (Jq * hq[..., None]).transpose(-1, -2) @ Jq
        if layout.ns and qc:
            s_col = nx
            gq_c, hq_c, Jq_c = gq[..., qr + qb :], hq[..., qr + qb :], Jq[..., qr + qb :, :]
            cross = (hq_c.unsqueeze(-2) @ Jq_c).squeeze(-2)
            g[..., s_col] += torch.sum(gq_c, -1)
            H[..., :n_q, s_col] += cross
            H[..., s_col, :n_q] += cross
            H[..., s_col, s_col] += torch.sum(hq_c, -1)
    # mirror the upper triangle (the JAX assembly computes j >= i only)
    H = torch.where(layout.upper, H, H.transpose(-1, -2))
    return (
        g[..., :nx].contiguous(),
        g[..., nx:].contiguous(),
        H[..., :nx, :nx].contiguous(),
        H[..., :nx, nx:].contiguous(),
        H[..., nx:, nx:].contiguous(),
    )


def gn_assemble_reference(vq, Jq, va, wrq, wbq, wra, wba, lam, mu, W, *, layout: GnLayout):
    """Plain batched PyTorch version: ``(lx, lw, lxx, lxw, lww)``, each
    contiguous ``(B, N, ...)``. Inputs: the q rows ``vq (B, N, RQ)`` (their
    constraint rows not yet slack-shifted) and ``Jq (B, N, RQ, n_q)``, the
    affine rows ``va (B, N, RA)``, the four weight vectors, ``lam (B, N,
    n_con)``, ``mu (B,)`` and ``W (B, N, nw)`` (its slack column shifts the
    q constraint rows when ns > 0)."""
    coefs = _row_coefs(vq, va, wrq, wbq, wra, wba, lam, mu, W, layout)
    return _assemble(*coefs, Jq, layout.S, layout.S_outer, layout)


def gn_term_scale(vq, Jq, va, wrq, wbq, wra, wba, lam, mu, W, *, layout: GnLayout):
    """The same assembly over the magnitude of every term: each entry of each
    block is the sum of the absolute values of the products that make it up.
    The bound a check of one assembly against another (the kernel against the
    plain version, the plain version against the JAX rule) scales each
    entry's error by: a sum of f32 terms in another order differs by a few
    ulps of this, whatever the entry's own size after cancellation, and a
    term that one side drops or flips moves the entry by its share of it."""
    coefs = (c.abs() for c in _row_coefs(vq, va, wrq, wbq, wra, wba, lam, mu, W, layout))
    return _assemble(*coefs, Jq.abs(), layout.S.abs(), layout.S_outer.abs(), layout)


# ------------------------------------------------------------------ the kernel


def build_kernel(shape) -> ctypes.CDLL:
    """Compile (once per hash of source, flags and shape) and load the kernel
    library for ``shape`` (``GnLayout.shape``)."""
    lib = _build.load_library(STEM, shape)
    fn = lib.gn_assemble_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@_build.counted
def gn_assemble(vq, Jq, va, wrq, wbq, wra, wba, lam, mu, W, *, layout: GnLayout):
    """The Riccati blocks ``(lx, lw, lxx, lxw, lww)`` of the AL Gauss-Newton
    model, each contiguous ``(B, N, ...)``; inputs as
    ``gn_assemble_reference``.

    A CUDA tensor launches the kernel, counted in ``gn_assemble.launches``
    by B; a CPU tensor runs the plain version. Any other device raises."""
    dev = vq.device
    if dev.type == "cpu":
        return gn_assemble_reference(vq, Jq, va, wrq, wbq, wra, wba, lam, mu, W, layout=layout)
    if dev.type != "cuda":
        raise ValueError(f"gn_assemble: no kernel for device {dev}")
    qr, qb, qc = layout.q_seg
    ar, ab, ac = layout.aff_seg
    nx, nw, n_q = layout.nx, layout.nw, layout.n_q
    Bsz, N = vq.shape[:2]
    rq, ra = qr + qb + qc, ar + ab + ac
    ins = [t.contiguous() for t in (vq, Jq, va, wrq, wbq, wra, wba, lam, mu, layout.c_off, W)]
    for name, t, shape in zip(
        ("vq", "Jq", "va", "wrq", "wbq", "wra", "wba", "lam", "mu", "c_off", "W"), ins,
        ((Bsz, N, rq), (Bsz, N, rq, n_q), (Bsz, N, ra), (Bsz, N, qr), (Bsz, N, qb), (Bsz, N, ar),
         (Bsz, N, ab), (Bsz, N, qc + ac), (Bsz,), (N, qc + ac), (Bsz, N, nw)),
    ):
        _build.check_tensor("gn_assemble", name, t, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((Bsz, N, nx), **f32), torch.empty((Bsz, N, nw), **f32),
            torch.empty((Bsz, N, nx, nx), **f32), torch.empty((Bsz, N, nx, nw), **f32),
            torch.empty((Bsz, N, nw, nw), **f32))
    if Bsz == 0 or N == 0:
        return outs
    if layout.n_terms > _build.gn_terms_max(layout.shape):
        raise ValueError(f"gn_assemble: S_aff's {layout.n_terms} terms pass the kernel's table of "
                         f"{_build.gn_terms_max(layout.shape)} (5 a row: at most two non-zeros a row)")
    lib = build_kernel(layout.shape)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gn_assemble_launch(
            *(t.data_ptr() for t in ins), layout.tables[0].data_ptr(), layout.n_live,
            layout.tables[1].data_ptr(), layout.n_terms,
            *(t.data_ptr() for t in outs), Bsz, N, *layout.shape, stream,
        )
    _build.raise_for_status("gn_assemble", err, STEM, layout.shape)
    _build.count_launch(gn_assemble, Bsz, dev)
    return outs
