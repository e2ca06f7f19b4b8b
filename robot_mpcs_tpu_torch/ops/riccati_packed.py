"""Structured Riccati backward sweep: CUDA kernel wrapper and plain version.

Port of ``robot_mpcs_tpu.ops.riccati_packed`` (the Pallas TPU kernel
``riccati_backward_packed``). Holonomic robots have the exact discrete-time
form ``A = [[I, a I], [0, I]]``, ``B = [[0 | b1 I], [0 | b2 I]]``; the
solver verifies it at build time (``detect_structure``) and passes the three
scalars, so every A/B product of the sweep collapses to O(nx^2) work.

* On a CUDA tensor, ``riccati_backward_packed`` launches the hand-written
  kernel of ``csrc/riccati_packed.cu`` (a team of threads per scenario that
  walks the stages in turn, each stage's data staged into shared memory
  with coalesced asynchronous copies while the previous stage computes;
  see the note at the top of that file for what bounds it on an H100),
  built for the problem's shape at its first use and loaded by
  ``ops/_build.py``. A missing ``nvcc``, a failed build, a shape that is not
  holonomic (``ns`` not 0 or 1) or one whose lane does not fit the card's
  shared memory raises; there is no fallback.
* On a CPU tensor it runs ``riccati_backward_packed_reference``, the plain
  batched PyTorch version of the same recursion (and the kernel's oracle).

The contract matches the TPU kernel: Schur-form value update, ``reg`` on all
``nw`` diagonal entries (slack included), a pivot ``d <= 1e-12`` (or NaN)
replaced by 1 with that stage's gains multiplied by zero and the lane marked
failed, the value update mirrored from its upper triangle, a zero terminal
value function, and outputs in the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from robot_mpcs_tpu_torch.ops import _build

_PIVOT_TINY = 1e-12


def detect_structure(
    A, B, *, nx: int, ns: int, tol: float = 1e-6
) -> Optional[Tuple[float, float, float]]:
    """Return (a, b1, b2) if (A, B) have the holonomic block structure
    ``A = [[I, a I], [0, I]]``, ``B = [[0 | b1 I], [0 | b2 I]]`` (the first
    ``ns`` columns of B are the zero slack columns); else None."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    if nx % 2 or A.shape != (nx, nx):
        return None
    n = nx // 2
    if B.shape != (nx, ns + n):
        return None
    a = float(A[0, n])
    b1 = float(B[0, ns])
    b2 = float(B[n, ns])
    eye = np.eye(n)
    ok = (
        np.abs(A[:n, :n] - eye).max() < tol
        and np.abs(A[n:, n:] - eye).max() < tol
        and np.abs(A[n:, :n]).max() < tol
        and np.abs(A[:n, n:] - a * eye).max() < tol
        and (ns == 0 or np.abs(B[:, :ns]).max() < tol)
        and np.abs(B[:n, ns:] - b1 * eye).max() < tol
        and np.abs(B[n:, ns:] - b2 * eye).max() < tol
    )
    return (a, b1, b2) if ok else None


# ----------------------------------------------------------------- plain version


def riccati_backward_packed_reference(
    lx, lw, lxx, lxw, lww, reg, *, N, nx, nw, ns, a, b1, b2
):
    """Plain batched PyTorch version of the structured sweep (f32 inside).

    Inputs batch-first: lx (B, N, nx), lw (B, N, nw), lxx (B, N, nx, nx),
    lxw (B, N, nx, nw), lww (B, N, nw, nw), reg (B,). Returns
    ``(k_ff (B, N, nw), K (B, N, nw, nx), failed (B,) bool)``.
    """
    in_dtype = lx.dtype
    lx, lw, lxx, lxw, lww, reg = (
        t.to(torch.float32) for t in (lx, lw, lxx, lxw, lww, reg)
    )
    Bsz = lx.shape[0]
    n = nx // 2
    dev = lx.device
    f32 = dict(dtype=torch.float32, device=dev)
    V = torch.zeros((Bsz, nx, nx), **f32)
    vx = torch.zeros((Bsz, nx), **f32)
    failed = torch.zeros((Bsz,), dtype=torch.bool, device=dev)
    k_out = torch.empty((Bsz, N, nw), **f32)
    K_out = torch.empty((Bsz, N, nw, nx), **f32)
    eye_w = torch.eye(nw, **f32)
    upper = torch.ones((nx, nx), dtype=torch.bool, device=dev).triu()

    def at_rows(T):
        """A^T T for T (B, nx, ...): rows :n -> T[:n]; rows n: -> a T[:n] + T[n:]."""
        return torch.cat([T[:, :n], a * T[:, :n] + T[:, n:]], 1)

    for k in reversed(range(N)):
        # T = V A;  U = V B (control columns)
        T = torch.cat([V[..., :n], a * V[..., :n] + V[..., n:]], -1)
        U = b1 * V[..., :n] + b2 * V[..., n:]  # (B, nx, nu)
        Qxx = lxx[:, k] + at_rows(T)
        Qxw = lxw[:, k].clone()
        Qxw[..., ns:] += at_rows(U)
        Qww = lww[:, k].clone()
        Qww[:, ns:, ns:] += b1 * U[:, :n] + b2 * U[:, n:]
        Qww = Qww + reg[:, None, None] * eye_w
        qx = lx[:, k] + torch.cat([vx[:, :n], a * vx[:, :n] + vx[:, n:]], -1)
        qw = lw[:, k].clone()
        qw[:, ns:] += b1 * vx[:, :n] + b2 * vx[:, n:]

        # LDL^T of Qww, NaN-aware pivots
        L = torch.zeros((Bsz, nw, nw), **f32)
        D = torch.zeros((Bsz, nw), **f32)
        Dinv = torch.zeros((Bsz, nw), **f32)
        bad = torch.zeros((Bsz,), **f32)
        for j in range(nw):
            d = Qww[:, j, j] - torch.sum(L[:, j, :j] ** 2 * D[:, :j], -1)
            is_bad = (~(d > _PIVOT_TINY)).to(torch.float32)
            bad = torch.maximum(bad, is_bad)
            d = d * (1.0 - is_bad) + is_bad
            D[:, j] = d
            Dinv[:, j] = 1.0 / d
            s = Qww[:, j + 1 :, j] - torch.sum(
                L[:, j + 1 :, :j] * (L[:, j, :j] * D[:, :j])[:, None, :], -1
            )
            L[:, j + 1 :, j] = s * Dinv[:, j, None]
        # solve [qw | Qxw^T]: forward substitution, then back substitution
        Y = torch.cat([qw[..., None], Qxw.transpose(1, 2)], -1)  # (B, nw, 1 + nx)
        for i in range(nw):
            Y[:, i] -= torch.sum(L[:, i, :i, None] * Y[:, :i].clone(), 1)
        for i in reversed(range(nw)):
            Y[:, i] = Y[:, i] * Dinv[:, i, None] - torch.sum(
                L[:, i + 1 :, i, None] * Y[:, i + 1 :].clone(), 1
            )
        Y = -Y * (1.0 - bad)[:, None, None]  # failed stage: zero gains
        k_ff, K = Y[..., 0], Y[..., 1:]

        # Schur-form value update, upper triangle mirrored
        vx = qx + (Qxw @ k_ff[..., None])[..., 0]
        V = Qxx + Qxw @ K
        V = torch.where(upper, V, V.transpose(1, 2))
        k_out[:, k] = k_ff
        K_out[:, k] = K
        failed |= bad > 0.5
    return k_out.to(in_dtype), K_out.to(in_dtype), failed


# ------------------------------------------------------------------ the kernel


def build_kernel(nx: int, nw: int, ns: int) -> ctypes.CDLL:
    """Compile (once per hash of source, flags, shape and nvcc version) and
    load the kernel library for the shape ``(nx, nw, ns)``. Raises, before
    any build, for a shape the kernel does not take or whose lane does not
    fit the card's shared memory."""
    lib = _build.load_library("riccati_packed", (nx, nw, ns))
    fn = lib.riccati_packed_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib


@_build.counted
def riccati_backward_packed(lx, lw, lxx, lxw, lww, reg, *, N, nx, nw, ns, a, b1, b2):
    """Batched structured Riccati sweep. Inputs batch-first: lx (B, N, nx),
    lw (B, N, nw), lxx (B, N, nx, nx), lxw (B, N, nx, nw), lww (B, N, nw, nw),
    reg (B,). Returns ``(k_ff (B, N, nw), K (B, N, nw, nx), failed (B,) bool)``.

    A CUDA tensor launches the CUDA kernel and counts the launch in
    ``riccati_backward_packed.launches`` (``_build.count_launch``: on the device
    inside a CUDA graph's capture); a CPU tensor runs the plain version. Any
    other device raises.
    """
    dev = lx.device
    if dev.type == "cpu":
        return riccati_backward_packed_reference(
            lx, lw, lxx, lxw, lww, reg, N=N, nx=nx, nw=nw, ns=ns, a=a, b1=b1, b2=b2
        )
    if dev.type != "cuda":
        raise ValueError(f"riccati_backward_packed: no kernel for device {dev}")
    Bsz = lx.shape[0]
    for name, t, shape in (
        ("lx", lx, (Bsz, N, nx)),
        ("lw", lw, (Bsz, N, nw)),
        ("lxx", lxx, (Bsz, N, nx, nx)),
        ("lxw", lxw, (Bsz, N, nx, nw)),
        ("lww", lww, (Bsz, N, nw, nw)),
        ("reg", reg, (Bsz,)),
    ):
        _build.check_tensor("riccati_backward_packed", name, t, shape, dev)
    k_ff = torch.empty((Bsz, N, nw), dtype=torch.float32, device=dev)
    K = torch.empty((Bsz, N, nw, nx), dtype=torch.float32, device=dev)
    if Bsz == 0 or N == 0:  # nothing to sweep: no launch, no lane failed
        return k_ff, K, torch.zeros((Bsz,), dtype=torch.bool, device=dev)
    lib = build_kernel(nx, nw, ns)
    failed = torch.empty((Bsz,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.riccati_packed_launch(
            lx.data_ptr(), lw.data_ptr(), lxx.data_ptr(), lxw.data_ptr(),
            lww.data_ptr(), reg.data_ptr(), k_ff.data_ptr(), K.data_ptr(),
            failed.data_ptr(), Bsz, N, nx, nw, ns,
            float(a), float(b1), float(b2), stream,
        )
    _build.raise_for_status("riccati_backward_packed", err, "riccati_packed", (nx, nw, ns))
    _build.count_launch(riccati_backward_packed, Bsz, dev)
    return k_ff, K, failed

