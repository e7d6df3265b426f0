"""Reconstruction filters.

Reference: rustracer-core/src/filter/ (Box, Triangle, Gaussian,
Mitchell-Netravali). Each filter is a static config; `evaluate` is a pure
batched function of offsets from the sample position — evaluated directly on
the device instead of via the reference's precomputed 16x16 table (film.rs:92).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Filter:
    kind: str = "box"          # box | triangle | gaussian | mitchell
    xwidth: float = 0.5
    ywidth: float = 0.5
    alpha: float = 2.0         # gaussian
    b: float = 1.0 / 3.0       # mitchell
    c: float = 1.0 / 3.0

    @property
    def radius(self):
        return (self.xwidth, self.ywidth)

    def evaluate(self, dx, dy):
        """Filter weight at offset (dx, dy) from the sample point."""
        if self.kind == "box":
            w = jnp.ones_like(dx)
        elif self.kind == "triangle":
            w = jnp.maximum(0.0, self.xwidth - jnp.abs(dx)) * \
                jnp.maximum(0.0, self.ywidth - jnp.abs(dy))
        elif self.kind == "gaussian":
            def g(d, r):
                expv = np.exp(-self.alpha * r * r)
                return jnp.maximum(0.0, jnp.exp(-self.alpha * d * d) - expv)
            w = g(dx, self.xwidth) * g(dy, self.ywidth)
        elif self.kind == "mitchell":
            def m1d(x):
                x = jnp.abs(2.0 * x)
                b, c = self.b, self.c
                inner = ((12.0 - 9.0 * b - 6.0 * c) * x ** 3
                         + (-18.0 + 12.0 * b + 6.0 * c) * x ** 2
                         + (6.0 - 2.0 * b)) * (1.0 / 6.0)
                outer = ((-b - 6.0 * c) * x ** 3 + (6.0 * b + 30.0 * c) * x ** 2
                         + (-12.0 * b - 48.0 * c) * x
                         + (8.0 * b + 24.0 * c)) * (1.0 / 6.0)
                return jnp.where(x > 1.0, jnp.where(x > 2.0, 0.0, outer), inner)
            w = m1d(dx / self.xwidth) * m1d(dy / self.ywidth)
        else:
            raise ValueError(f"unknown filter kind {self.kind}")
        inside = (jnp.abs(dx) <= self.xwidth) & (jnp.abs(dy) <= self.ywidth)
        return jnp.where(inside, w, 0.0)


def make_filter(name, params=None):
    """Factory (reference api.rs make_filter)."""
    from ..scene.paramset import ParamSet
    ps = params or ParamSet()
    if name == "box":
        return Filter("box", ps.find_one_float("xwidth", 0.5),
                      ps.find_one_float("ywidth", 0.5))
    if name == "triangle":
        return Filter("triangle", ps.find_one_float("xwidth", 2.0),
                      ps.find_one_float("ywidth", 2.0))
    if name == "gaussian":
        return Filter("gaussian", ps.find_one_float("xwidth", 2.0),
                      ps.find_one_float("ywidth", 2.0),
                      alpha=ps.find_one_float("alpha", 2.0))
    if name == "mitchell":
        return Filter("mitchell", ps.find_one_float("xwidth", 2.0),
                      ps.find_one_float("ywidth", 2.0),
                      b=ps.find_one_float("B", 1.0 / 3.0),
                      c=ps.find_one_float("C", 1.0 / 3.0))
    if name == "sinc":
        # Lanczos-windowed sinc not in the live reference set; approximate
        # with mitchell per PBRT guidance rather than failing the scene.
        return Filter("mitchell", ps.find_one_float("xwidth", 4.0),
                      ps.find_one_float("ywidth", 4.0))
    raise ValueError(f"unknown filter {name!r}")
