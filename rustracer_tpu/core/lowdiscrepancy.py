"""Low-discrepancy (0,2)-sequence generation, fully vectorized.

Reference: rustracer-core/src/sampler/{lowdiscrepancy,zerotwosequence}.rs.
The reference generates scrambled van-der-Corput / Sobol' points with
gray-code incremental updates; on the device we instead evaluate sample i directly
with bit-twiddling (branch-free, O(1) per lane):
  dim 0: bit-reversed index (van der Corput), XOR-scrambled
  dim 1: Pascal-matrix (mod 2) Sobol' component, XOR-scrambled
which is the classic Kollig-Keller (0,2)-sequence construction.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Pascal matrix mod 2 columns: col[j] has bit (31-i) set iff C(j, i) is odd,
# i.e. (i & j) == i (Lucas' theorem).
_PASCAL_COLS = np.zeros(32, dtype=np.uint32)
for _j in range(32):
    v = 0
    for _i in range(_j + 1):
        if (_i & _j) == _i:
            v |= 1 << (31 - _i)
    _PASCAL_COLS[_j] = v


def reverse_bits32(x):
    x = jnp.asarray(x, jnp.uint32)
    x = ((x << 16) | (x >> 16))
    x = ((x & jnp.uint32(0x00ff00ff)) << 8) | ((x & jnp.uint32(0xff00ff00)) >> 8)
    x = ((x & jnp.uint32(0x0f0f0f0f)) << 4) | ((x & jnp.uint32(0xf0f0f0f0)) >> 4)
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x & jnp.uint32(0xcccccccc)) >> 2)
    x = ((x & jnp.uint32(0x55555555)) << 1) | ((x & jnp.uint32(0xaaaaaaaa)) >> 1)
    return x


_ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
_INV_2_32 = np.float32(2.0 ** -32)


def _bits_to_float(bits):
    return jnp.minimum(bits.astype(jnp.float32) * _INV_2_32, _ONE_MINUS_EPS)


def van_der_corput(index, scramble=0):
    """Scrambled van der Corput sample for integer index (batched)."""
    bits = reverse_bits32(jnp.asarray(index, jnp.uint32)) ^ jnp.asarray(scramble, jnp.uint32)
    return _bits_to_float(bits)


def sobol_dim2(index, scramble=0):
    """Second component of the 2D Sobol/(0,2) sequence (Pascal matrix)."""
    index = jnp.asarray(index, jnp.uint32)
    cols = jnp.asarray(_PASCAL_COLS)
    out = jnp.zeros_like(index)
    for k in range(32):
        take = ((index >> np.uint32(k)) & jnp.uint32(1)) != 0
        out = jnp.where(take, out ^ cols[k], out)
    out = out ^ jnp.asarray(scramble, jnp.uint32)
    return _bits_to_float(out)


def sample02(index, scramble2=(0, 0)):
    """(0,2)-sequence 2D point for sample `index` with XOR scrambles.

    index: (...) uint32; scramble2: pair of (...) uint32. Returns (..., 2).
    """
    x = van_der_corput(index, scramble2[0])
    y = sobol_dim2(index, scramble2[1])
    return jnp.stack([x, y], axis=-1)


def scramble_bits(key, shape, n=1):
    """Draw n uint32 scramble words (counter-based threefry; replaces the
    reference's PCG32 rng.rs — deterministic, splittable, parallel)."""
    bits = jax.random.bits(key, shape=shape + (n,), dtype=jnp.uint32)
    return tuple(bits[..., i] for i in range(n))
