"""The part of ``jax.random`` the fleet's kick draws from, in torch.

``robot_mpcs_tpu/parallel/fleet.py:450-456`` draws the local-minimum kick
as ``jax.random.normal(fold_in(fold_in(PRNGKey(0x5EED), step), axis_index),
shape)``. This module computes the same numbers, on any device, from a key
held as a device tensor: ``prng_key``, ``fold_in``, ``random_bits``,
``uniform`` and ``normal`` of JAX's default threefry2x32 generator, written
from JAX 0.9.0 (``jax/_src/prng.py``, ``jax/_src/random.py``) with
``jax_threefry_partitionable`` on, JAX's default there.

Unsigned 32-bit words are held in ``int64`` tensors, masked to 32 bits
after every add and shift: torch's ``uint32`` lacks most arithmetic on
CUDA and ``>>`` on ``int32`` is arithmetic. Bits and uniforms equal JAX's
bit for bit. ``normal`` evaluates XLA's f32 ``ErfInv`` (Giles' single-
precision polynomial, as XLA's math library expands ``chlo.erf_inv``)
rather than ``torch.erfinv``, whose CPU and CUDA versions are other
algorithms; its ``log1p`` is a float64 series of basic ops rounded once,
so the draw is the same on the CPU and the card.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (``jax/_src/prng.py:860-905``) on words
    held in ``int64`` tensors in ``[0, 2**32)``; broadcasts like JAX's
    ``threefry2x32_p``. Returns the two output words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & _M32)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _word(v, device) -> torch.Tensor:
    """A 32-bit word (a Python int, or a 0-d integer tensor on ``device``),
    as JAX converts it to ``uint32``, in a 0-d ``int64`` tensor on
    ``device``; no host-device copy either way."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64).reshape(()) & _M32
    return torch.full((), int(v) & _M32, dtype=torch.int64, device=device)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**32)``
    (``jax/_src/prng.py:802-829``): the words ``[seed >> 32, seed & M32]``,
    as a ``(2,)`` ``int64`` tensor."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} is not a 32-bit unsigned integer")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the key on the counter
    pair ``[0, data]`` (``jax/_src/prng.py:1092-1141, 1163-1169``).
    ``data`` may be a 0-d integer tensor on the key's device (no host read)."""
    d = _word(data, key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y1, y2])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, ``int64`` in ``[0, 2**32)``: the
    partitionable form (``jax/_src/prng.py:1184-1199``), threefry of the
    key on each element's row-major index split into hi / lo words, the
    two outputs XOR'ed."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (``jax/_src/random.py:435-475``):
    23 mantissa bits under exponent 0, minus 1, scaled to ``[minval,
    maxval)``, floored at ``minval``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span as float32 values, held in Python floats
    lo, hi = torch.tensor([minval, maxval], dtype=torch.float32).tolist()
    span = float(torch.tensor(hi, dtype=torch.float32) - torch.tensor(lo, dtype=torch.float32))
    return torch.clamp_min(floats * span + lo, lo)


#: XLA's f32 ErfInv coefficients (Giles 2010), highest power first, for
#: w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
#: terms of 2 * atanh(s) = 2 * sum s^(2k+1) / (2k+1): 19 reach float64's
#: precision for |s| <= 1/3
_ATANH_TERMS = 19


def _log1p_f64(y: torch.Tensor) -> torch.Tensor:
    """``log1p`` of float64 ``y`` in (-1, 0] from IEEE adds, multiplies and
    divides only, so that every device rounds it alike (library ``log1p``s
    differ in the last bit): ``2 * atanh(s)`` with ``s = y / (2 + y)``, or,
    below y = -0.5 (where ``1 + y`` is exact), with ``1 + y = m * 2**e`` and
    ``s = (m - 1) / (m + 1)``, plus ``e * ln 2``."""
    near = y > -0.5
    m, e = torch.frexp(1.0 + y)  # m in [0.5, 1)
    low = m < math.sqrt(0.5)
    m = torch.where(low, 2.0 * m, m)  # in [sqrt(1/2), sqrt(2))
    e = torch.where(low, e - 1, e).to(torch.float64)
    s = torch.where(near, y / (2.0 + y), (m - 1.0) / (m + 1.0))
    s2 = s * s
    series = torch.full_like(s, 1.0 / (2 * _ATANH_TERMS - 1))
    for k in range(_ATANH_TERMS - 2, -1, -1):
        series = 1.0 / (2 * k + 1) + s2 * series
    r = 2.0 * s * series
    return torch.where(near, r, r + e * math.log(2.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function of float32 ``x`` as XLA expands it in f32:
    ``w = -log1p(x * -x)``, then a degree-8 polynomial in ``w - 2.5``
    (w < 5) or ``sqrt(w) - 3`` by Horner's rule, times ``x``; ``x * inf`` at
    ``|x| == 1``. XLA's CPU backend contracts each Horner step into a fused
    multiply-add, taken here in float64 and rounded once. ``log1p`` and
    ``sqrt`` are taken in float64 and rounded once, ``log1p`` from basic
    ops (``_log1p_f64``); every other op rounds in float32. So the CPU and
    the card give the same bits, within 3 ulp of ``jax.random.normal`` on
    the CPU (XLA's own f32 ``log1p`` rounds differently). ``torch.erfinv``
    is another algorithm, up to 91 ulp from XLA's near zero."""
    w = (-_log1p_f64((x * -x).to(torch.float64))).to(torch.float32)
    small = w < 5.0
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    w = torch.where(small, w - 2.5, root - 3.0).to(torch.float64)
    p = torch.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(small, c_lt, c_ge).to(torch.float32)
        p = (c.to(torch.float64) + p.to(torch.float64) * w).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32 (``jax/_src/random.py:867-872``):
    ``sqrt(2) * erfinv(u)`` of ``u`` uniform in ``[nextafter(-1, 0), 1)``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    lo = float(torch.nextafter(-one, torch.zeros_like(one)))  # -1 + 2**-24
    u = uniform(key, shape, lo, 1.0)
    return float(torch.tensor(math.sqrt(2), dtype=torch.float32)) * erfinv(u)
