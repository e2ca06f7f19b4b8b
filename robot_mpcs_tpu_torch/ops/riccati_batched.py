"""General batched Riccati backward sweep: CUDA kernel wrapper and plain version.

Port of ``robot_mpcs_tpu.ops.riccati_pallas`` (the Pallas TPU kernel
``riccati_backward_batched``): the sweep for arbitrary per-stage dynamics
Jacobians ``A (nx, nx)``, ``B (nx, nw)``, per lane ``(B, N, ...)`` or shared
by the batch ``(N, ...)``. It carries the diff-drive (boxer) solve and any
model without the holonomic block structure of ``ops/riccati_packed.py``.

* On a CUDA tensor, ``riccati_backward_batched`` launches the hand-written
  kernel of ``csrc/riccati_batched.cu`` (a team of threads per scenario
  that walks the stages in turn, each stage's data staged into shared
  memory with coalesced asynchronous copies; see the note at the top of
  that file), built for the problem's shape at its first use and loaded by
  ``ops/_build.py``. A missing ``nvcc``, a failed build or a shape whose
  lane does not fit the card's shared memory raises; there is no fallback
  (``riccati_backend="scan"`` takes any shape).
* On a CPU tensor it runs ``riccati_backward_batched_reference``, the plain
  batched PyTorch version of the same arithmetic (and the kernel's oracle).

The contract matches the TPU kernel: ``reg`` on all ``nw`` diagonal entries,
an unrolled LDL^T stage solve of ``[qw | Qxw^T]`` in which a pivot
``d <= 1e-12`` (or NaN) is replaced by 1, that stage's gains are zero and the
lane is marked failed, the full-form value update symmetrised, a zero
terminal value function, and outputs in the input dtype. (The kernel zeroes
a failed stage's gains by multiplying them by 0, the plain version by a
select: they differ only on a lane whose gains are already non-finite.)
The sweep itself is ``riccati_sweep``, shared with the solver's stage scan.
"""

from __future__ import annotations

import ctypes

import torch

from robot_mpcs_tpu_torch.ops import _build

_PIVOT_TINY = 1e-12


# ----------------------------------------------------------------- plain version


def _ldl_solve(Q: torch.Tensor, R: torch.Tensor):
    """Solve ``Q x = R`` per lane by unrolled LDL^T (riccati_pallas.py:70-120).

    Q (B, nw, nw), R (B, nw, m). Returns (x (B, nw, m), bad (B,) bool),
    ``bad`` on lanes whose factorization hit a pivot ``<= 1e-12`` or NaN
    (that pivot is replaced by 1)."""
    nw = Q.shape[-1]
    L = [[None] * nw for _ in range(nw)]
    D = [None] * nw
    bad = torch.zeros(Q.shape[:1], dtype=Q.dtype, device=Q.device)
    for j in range(nw):
        d = Q[:, j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k] * D[k]
        is_bad = 1.0 - (d > _PIVOT_TINY).to(Q.dtype)
        bad = torch.maximum(bad, is_bad)
        d = d * (1.0 - is_bad) + is_bad
        D[j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, nw):
            s = Q[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s * inv_d
    y = [None] * nw
    for i in range(nw):
        acc = R[:, i]
        for k in range(i):
            acc = acc - L[i][k][:, None] * y[k]
        y[i] = acc
    x = [None] * nw
    for i in reversed(range(nw)):
        acc = y[i] / D[i][:, None]
        for k in range(i + 1, nw):
            acc = acc - L[k][i][:, None] * x[k]
        x[i] = acc
    return torch.stack(x, 1), bad > 0.5


def riccati_sweep(lx, lw, lxx, lxw, lww, A, Bm, reg, stage_solve):
    """The general backward sweep, batch-first, with the stage solve
    ``stage_solve(Qww (B, nw, nw), R (B, nw, m)) -> (x (B, nw, m), bad (B,)
    bool)`` as an argument. ``reg`` on all ``nw`` diagonal entries, the
    full-form value update symmetrised, a zero terminal value function. A
    stage whose solve is ``bad`` emits zero gains and marks its lane failed.

    Inputs: lx (B, N, nx), lw (B, N, nw), lxx (B, N, nx, nx), lxw (B, N, nx,
    nw), lww (B, N, nw, nw), A (B, N, nx, nx) or (N, nx, nx), Bm (B, N, nx,
    nw) or (N, nx, nw), reg (B,). Returns ``(k_ff (B, N, nw), K (B, N, nw,
    nx), failed (B,) bool)``."""
    Bsz, N, nx = lx.shape
    nw = lw.shape[-1]
    f32 = dict(dtype=lx.dtype, device=lx.device)
    V = torch.zeros((Bsz, nx, nx), **f32)
    vx = torch.zeros((Bsz, nx, 1), **f32)
    failed = torch.zeros((Bsz,), dtype=torch.bool, device=lx.device)
    k_out = torch.empty((Bsz, N, nw), **f32)
    K_out = torch.empty((Bsz, N, nw, nx), **f32)
    eye_w = torch.eye(nw, **f32)
    for k in reversed(range(N)):
        A_k = A[:, k] if A.dim() == 4 else A[k]
        B_k = Bm[:, k] if Bm.dim() == 4 else Bm[k]
        At, Bt = A_k.transpose(-1, -2), B_k.transpose(-1, -2)
        U = V @ B_k
        Qxx = lxx[:, k] + At @ (V @ A_k)
        Qxw = lxw[:, k] + At @ U
        Qww = lww[:, k] + Bt @ U + reg[:, None, None] * eye_w
        qx = lx[:, k, :, None] + At @ vx
        qw = lw[:, k, :, None] + Bt @ vx
        sol, bad = stage_solve(Qww, torch.cat([qw, Qxw.transpose(1, 2)], -1))
        sol = torch.where(bad[:, None, None], 0.0, -sol)
        k_ff, K = sol[..., :1], sol[..., 1:]
        Kt = K.transpose(1, 2)
        vx = qx + Qxw @ k_ff + Kt @ qw + Kt @ (Qww @ k_ff)
        QxwK = Qxw @ K
        V = Qxx + QxwK + QxwK.transpose(1, 2) + Kt @ (Qww @ K)
        V = 0.5 * (V + V.transpose(1, 2))
        k_out[:, k] = k_ff[..., 0]
        K_out[:, k] = K
        failed |= bad
    return k_out, K_out, failed


def riccati_backward_batched_reference(lx, lw, lxx, lxw, lww, A, Bm, reg, *, N, nx, nw):
    """Plain batched PyTorch version of the general sweep (f32 inside): the
    TPU kernel's LDL^T stage solve in ``riccati_sweep``. Inputs and outputs
    as ``riccati_sweep``; outputs in the input dtype."""
    in_dtype = lx.dtype
    k_ff, K, failed = riccati_sweep(
        *(t.to(torch.float32) for t in (lx, lw, lxx, lxw, lww, A, Bm, reg)), _ldl_solve
    )
    return k_ff.to(in_dtype), K.to(in_dtype), failed


# ------------------------------------------------------------------ the kernel


def build_kernel(nx: int, nw: int) -> ctypes.CDLL:
    """Compile (once per hash of source, flags, shape and nvcc version) and
    load the kernel library for the shape ``(nx, nw)``. Raises, before any
    build, for a shape whose lane does not fit the card's shared memory."""
    lib = _build.load_library("riccati_batched", (nx, nw))
    fn = lib.riccati_batched_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def riccati_backward_batched(lx, lw, lxx, lxw, lww, A, Bm, reg, *, N, nx, nw):
    """Batched general Riccati sweep. Inputs batch-first as in
    ``riccati_backward_batched_reference``; ``A``/``Bm`` per lane
    ``(B, N, ...)`` or shared by the batch ``(N, ...)``. Returns
    ``(k_ff (B, N, nw), K (B, N, nw, nx), failed (B,) bool)``.

    A CUDA tensor launches the CUDA kernel (and counts the launch in
    ``riccati_backward_batched.launches``); a CPU tensor runs the plain
    version. Any other device raises.
    """
    dev = lx.device
    if dev.type == "cpu":
        return riccati_backward_batched_reference(
            lx, lw, lxx, lxw, lww, A, Bm, reg, N=N, nx=nx, nw=nw
        )
    if dev.type != "cuda":
        raise ValueError(f"riccati_backward_batched: no kernel for device {dev}")
    Bsz = lx.shape[0]
    a_shape = (Bsz, N, nx, nx) if A.dim() == 4 else (N, nx, nx)
    b_shape = (Bsz, N, nx, nw) if Bm.dim() == 4 else (N, nx, nw)
    for name, t, shape in (
        ("lx", lx, (Bsz, N, nx)),
        ("lw", lw, (Bsz, N, nw)),
        ("lxx", lxx, (Bsz, N, nx, nx)),
        ("lxw", lxw, (Bsz, N, nx, nw)),
        ("lww", lww, (Bsz, N, nw, nw)),
        ("A", A, a_shape),
        ("Bm", Bm, b_shape),
        ("reg", reg, (Bsz,)),
    ):
        _build.check_tensor("riccati_backward_batched", name, t, shape, dev)
    k_ff = torch.empty((Bsz, N, nw), dtype=torch.float32, device=dev)
    K = torch.empty((Bsz, N, nw, nx), dtype=torch.float32, device=dev)
    if Bsz == 0 or N == 0:  # nothing to sweep: no launch, no lane failed
        return k_ff, K, torch.zeros((Bsz,), dtype=torch.bool, device=dev)
    lib = build_kernel(nx, nw)
    failed = torch.empty((Bsz,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.riccati_batched_launch(
            lx.data_ptr(), lw.data_ptr(), lxx.data_ptr(), lxw.data_ptr(),
            lww.data_ptr(), A.data_ptr(), Bm.data_ptr(), reg.data_ptr(),
            k_ff.data_ptr(), K.data_ptr(), failed.data_ptr(), Bsz, N, nx, nw,
            N * nx * nx if A.dim() == 4 else 0,
            N * nx * nw if Bm.dim() == 4 else 0,
            stream,
        )
    _build.raise_for_status("riccati_backward_batched", err, "riccati_batched", (nx, nw))
    riccati_backward_batched.launches += 1
    return k_ff, K, failed


#: kernel launches made through the wrapper (CPU calls are not counted)
riccati_backward_batched.launches = 0
