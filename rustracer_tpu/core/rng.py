"""Counter-based hashing RNG utilities.

Replaces the reference's PCG32 (rustracer-core/src/rng.rs) with stateless,
per-lane integer hashing: every lane of a wavefront derives its random numbers
from (seed, pixel, sample, dimension) with no sequential state — the natural
wavefront design (vectorizes, reproducible under any sharding).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_INV_2_32 = np.float32(2.0 ** -32)
_ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _mix(h):
    """murmur3-style finalizer on uint32."""
    h = jnp.asarray(h, jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_u32(*words):
    """Combine any number of uint32 words into one well-mixed uint32."""
    h = jnp.uint32(0x9E3779B9)
    for w in words:
        w = jnp.asarray(w, jnp.uint32)
        h = _mix(h ^ w) + jnp.uint32(0x7F4A7C15)
    return _mix(h)


def hash_float(*words):
    """Uniform float32 in [0, 1) from hashed words."""
    return jnp.minimum(hash_u32(*words).astype(jnp.float32) * _INV_2_32,
                       _ONE_MINUS_EPS)
