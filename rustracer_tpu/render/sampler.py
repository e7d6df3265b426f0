"""Samplers as stateless per-lane functions.

Reference: rustracer-core/src/sampler/ (ZeroTwoSequence is the only live
sampler, api.rs:205-215). Instead of stateful per-tile sampler objects, every
lane derives dimension d of sample s at pixel p directly:
  02sequence: (0,2)-sequence point s with per-(pixel, dim) XOR scrambles
  random:     murmur-hashed uniforms
Deterministic under any sharding — the wavefront analog of the reference's
deterministic per-tile reseed (renderer.rs:83-84).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.lowdiscrepancy import sample02, van_der_corput
from ..core.rng import hash_float, hash_u32


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "02sequence"   # 02sequence | lowdiscrepancy | random
    spp: int = 16
    seed: int = 0

    def __post_init__(self):
        if self.kind in ("02sequence", "lowdiscrepancy", "zerotwosequence"):
            # round spp up to a power of two (zerotwosequence.rs:30)
            spp = 1 << int(np.ceil(np.log2(max(1, self.spp))))
            object.__setattr__(self, "spp", spp)

    def get_1d(self, pixel_idx, sample_idx, dim):
        if self.kind == "random":
            return hash_float(self.seed, pixel_idx, sample_idx, dim)
        scr = hash_u32(self.seed, pixel_idx, dim, 0x1D)
        return van_der_corput(sample_idx, scr)

    def get_2d(self, pixel_idx, sample_idx, dim):
        if self.kind == "random":
            return jnp.stack(
                [hash_float(self.seed, pixel_idx, sample_idx, dim, 0),
                 hash_float(self.seed, pixel_idx, sample_idx, dim, 1)], axis=-1)
        sx = hash_u32(self.seed, pixel_idx, dim, 0x2D0)
        sy = hash_u32(self.seed, pixel_idx, dim, 0x2D1)
        return sample02(sample_idx, (sx, sy))

    def get_camera_sample(self, pixel_xy, pixel_idx, sample_idx):
        """Returns (p_film (B,2), p_lens (B,2), time (B,)).

        Dimensions 0 (film jitter), 1 (lens), plus a 1D time dim — matching
        the reference's CameraSample layout (camera.rs:205-209)."""
        jitter = self.get_2d(pixel_idx, sample_idx, 0)
        p_film = pixel_xy.astype(jnp.float32) + jitter
        p_lens = self.get_2d(pixel_idx, sample_idx, 1)
        time = self.get_1d(pixel_idx, sample_idx, 0)
        return p_film, p_lens, time


class DimAllocator:
    """Trace-time dimension counter: integrators request dims sequentially.

    Dims 0-1 (2D) and 0 (1D) are reserved for the camera sample."""

    def __init__(self, start2d=2, start1d=1):
        self.d2 = start2d
        self.d1 = start1d

    def next_2d(self):
        d = self.d2
        self.d2 += 1
        return d

    def next_1d(self):
        d = self.d1
        self.d1 += 1
        return d
