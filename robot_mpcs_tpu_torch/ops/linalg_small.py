"""Unrolled Cholesky solve for tiny static-shape matrices, batch-first.

Port of ``robot_mpcs_tpu.ops.linalg_small``: the factorization and both
substitutions are unrolled over the static dimension ``n`` into elementwise
tensor ops over the leading batch dimensions. It is the stage solve of the
solver's ``riccati_backend="scan"`` backward sweep.

Numerics match ``torch.cholesky_solve`` up to rounding order; a non-PSD or
non-finite input gives NaNs in ``X`` and sets ``bad`` (callers mask on it).
"""

from __future__ import annotations

import torch


def chol_solve_unrolled(Q: torch.Tensor, rhs: torch.Tensor):
    """Solve ``Q @ X = rhs`` for SPD ``Q`` via unrolled Cholesky.

    ``Q``: (..., n, n); ``rhs``: (..., n, m). Returns ``(X (..., n, m),
    bad (...,) bool)``, ``bad`` True where a pivot is non-positive or
    non-finite.
    """
    n = Q.shape[-1]
    if rhs.shape[-2] != n:
        raise ValueError(f"rhs rows {rhs.shape[-2]} != n {n}")
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    diag = []
    for j in range(n):
        s = Q[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        diag.append(s)
        inv_d[j] = 1.0 / torch.sqrt(s)
        for i in range(j + 1, n):
            t = Q[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d[j]
    d = torch.stack(diag, -1)
    bad = ~torch.all(torch.isfinite(d) & (d > 0.0), -1)
    # forward substitution L Y = rhs (rows are (..., m) vectors)
    Y = [None] * n
    for i in range(n):
        acc = rhs[..., i, :]
        for k in range(i):
            acc = acc - L[i][k][..., None] * Y[k]
        Y[i] = acc * inv_d[i][..., None]
    # back substitution L^T X = Y
    X = [None] * n
    for i in reversed(range(n)):
        acc = Y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i][..., None] * X[k]
        X[i] = acc * inv_d[i][..., None]
    return torch.stack(X, -2), bad
