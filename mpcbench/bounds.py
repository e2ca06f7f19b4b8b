"""The peaks of the card and the least time each hand-written kernel's work
could take on it.

Frozen copies of ``chip_smoke.py``'s arithmetic: ``sweep_bound`` (:529-550),
``fk_bound`` (:906-918) and ``gn_bound`` (:930-946). Each counts every input
read once and every output written once, against the flops of the kernel's
arithmetic, and is split here into the flops of one (lane, stage) and the
bound of a launch, so that the solver's work per iteration can be counted
from the problem's shapes alone (``step_flops``).
"""

from __future__ import annotations

from typing import Tuple

#: NVIDIA H100 SXM, data sheet, dense, 700 W: HBM3 bytes/s and float32
#: FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def _bound(nbytes: float, flops: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sweep_stage(nx: int, nw: int, dyn: str) -> Tuple[int, int]:
    """(words, flops) of one Riccati sweep's (lane, stage): ``dyn`` is
    "packed" (A/B baked in), "batched" (per-lane A/B) or "constant"."""
    words = nx + nw + nx * nx + nx * nw + nw * nw + nw + nw * nx  # stage in + gains out
    m = 1 + nx
    solve = 2 * nw ** 3 // 3 + 2 * nw * nw * m
    if dyn == "packed":
        n = nx // 2
        flops = 3 * nx * nx + 5 * nx * n + 3 * n * n + solve + nx * (nx + 1) * nw + 2 * nx * nw
    else:
        words += (nx * nx + nx * nw) if dyn == "batched" else 0
        flops = (4 * nx ** 3 + 4 * nx * nx * nw + 2 * nx * nw * nw + 2 * nx * nx + 2 * nx * nw
                 + solve + 2 * nw * nw * m + 6 * nx * nw + 6 * nw * nx * (nx + 1))
    return words, flops


def sweep_bound(B: int, N: int, nx: int, nw: int, dyn: str) -> Tuple[float, str]:
    words, flops = sweep_stage(nx, nw, dyn)
    nbytes = 4 * B * N * words + 5 * B
    if dyn == "constant":
        nbytes += 4 * N * (nx * nx + nx * nw)
    return _bound(nbytes, B * N * flops)


def fk_row(kinds, n: int, L: int, want_jac: bool) -> Tuple[int, int]:
    """(words, flops) of one FK walk row: ``kinds`` are the walk's node kinds
    (0 fixed, 1 revolute, 2 prismatic): each node's transform 72, a joint's
    axis 15, a revolute joint's Rodrigues product and sin/cos 80; per link
    and column a cross product, 9."""
    flops = sum(72 + (15 if k else 0) + (80 if k == 1 else 0) for k in kinds) + (9 * L * n if want_jac else 0)
    return n + 3 * L + (3 * L * n if want_jac else 0), flops


def fk_bound(M: int, kinds, n: int, L: int, want_jac: bool) -> Tuple[float, str]:
    words, flops = fk_row(kinds, n, L, want_jac)
    return _bound(4 * M * words, M * flops)


def gn_stage(q_seg, aff_seg, nx: int, nw: int, n_q: int, ns: int, nnz) -> Tuple[int, int]:
    """(words, flops) of one assembly (lane, stage): the rows, q Jacobian,
    weights, multipliers and slack column in, the five blocks out; per row
    ~10 flops for its coefficients, per entry the q rows' products, the
    slack column's and the CSR tables' terms (``nnz``: S_aff's non-zeros a
    row)."""
    qr, qb, qc = q_seg
    ar, ab, ac = aff_seg
    rq, ra = qr + qb + qc, ar + ab + ac
    words_in = rq + rq * n_q + ra + qr + qb + ar + ab + qc + ac + ns
    words_out = nx + nw + nx * nx + nx * nw + nw * nw
    pairs = sum(k + k * (k + 1) // 2 for k in nnz)
    flops = 10 * (rq + ra) + 2 * rq * n_q + 3 * rq * n_q * (n_q + 1) // 2 + 2 * pairs + (3 * qc * (n_q + 2) if ns else 0)
    return words_in + words_out, flops


def gn_bound(B: int, N: int, q_seg, aff_seg, nx, nw, n_q, ns, nnz) -> Tuple[float, str]:
    words, flops = gn_stage(q_seg, aff_seg, nx, nw, n_q, ns, nnz)
    n_con = q_seg[2] + aff_seg[2]
    return _bound(4 * (B * N * words + B + N * n_con), B * N * flops)
