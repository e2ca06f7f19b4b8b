"""The port's ``utils/prng.py`` against ``jax.random``: the kick's key and
draw (``robot_mpcs_tpu/parallel/fleet.py:450-456``) for the steps and ranks
a fleet folds in and the shapes its robots draw.

Keys ``fold_in(fold_in(PRNGKey(0x5EED), step), rank)`` for step in {0, 1,
25, 2**31 - 1} and rank in {0, 1, 3}; shapes of panda's kick at B = 1, 32
and 4096, an odd-sized one, pointRobot's and boxer's at B = 1024.
Tolerances, and why:

* keys, bits and uniforms: bit for bit. They are integer arithmetic, then
  float32 ops that round alike in both;
* normals: within 4 ulp. XLA's ``erf_inv`` takes ``log1p`` from its own
  f32 approximation, the port from float64 rounded once (so that the CPU
  and the card agree); the largest difference is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_mpcs_tpu_torch.parallel.fleet import KICK_SEED
from robot_mpcs_tpu_torch.utils import prng

torch.set_num_threads(2)

STEPS = (0, 1, 25, 2**31 - 1)
RANKS = (0, 1, 3)
SHAPES = ((1, 20, 7), (32, 20, 7), (4096, 20, 7), (3, 5, 7), (1024, 20, 3), (1024, 10, 2))
MAX_ULP = 4


def _keys(step, rank):
    kj = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KICK_SEED), jnp.int32(step)), rank)
    kt = prng.fold_in(prng.fold_in(prng.prng_key(KICK_SEED), torch.tensor(step, dtype=torch.int32)), rank)
    return kj, kt


def _ulp(a, b):
    """Distance in units in the last place between two float32 arrays of
    one sign pattern (the int32 views' difference)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_threefry_partitionable_is_on():
    """``prng.random_bits`` follows JAX's partitionable counters; a change of
    JAX's default must fail here, not drift silently."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("step", STEPS)
def test_keys_equal_jax(step):
    for rank in RANKS:
        kj, kt = _keys(step, rank)
        assert kt.dtype == torch.int64 and tuple(kt.shape) == (2,)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
    # a Python int folds in as the same word as an int32 tensor
    want = jax.random.fold_in(jax.random.PRNGKey(KICK_SEED), step)
    np.testing.assert_array_equal(prng.fold_in(prng.prng_key(KICK_SEED), step).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("step", STEPS)
def test_draws_equal_jax(step, shape):
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    worst = 0
    for rank in RANKS:
        kj, kt = _keys(step, rank)
        bits = prng.random_bits(kt, shape)
        assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
        np.testing.assert_array_equal(
            bits.numpy(), np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(np.int64))
        for minval, maxval in ((0.0, 1.0), (float(lo), 1.0)):
            u = prng.uniform(kt, shape, minval, maxval).numpy()
            want = np.asarray(jax.random.uniform(kj, shape, jnp.float32, minval, maxval))
            np.testing.assert_array_equal(u.view(np.int32), want.view(np.int32))
        n = prng.normal(kt, shape)
        assert n.dtype == torch.float32 and tuple(n.shape) == shape
        want = np.asarray(jax.random.normal(kj, shape, jnp.float32))
        assert np.all(np.isfinite(n.numpy()))
        worst = max(worst, int(_ulp(n.numpy(), want).max()))
    print(f"step {step}, shape {shape}: normals within {worst} ulp of jax.random.normal")
    assert worst <= MAX_ULP


def test_erfinv_edges_and_range():
    """``erfinv`` is +-inf at +-1 and 0 at 0, as XLA's; ``prng_key`` takes a
    32-bit unsigned seed only."""
    x = torch.tensor([-1.0, 0.0, 1.0, 0.5], dtype=torch.float32)
    got = prng.erfinv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert got[0] == -np.inf and got[2] == np.inf and got[1] == 0.0
    assert _ulp(got[3:], want[3:]).max() <= MAX_ULP
    for seed in (-1, 2**32):
        with pytest.raises(ValueError):
            prng.prng_key(seed)
