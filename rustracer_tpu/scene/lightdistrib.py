"""Light-sampling distributions for NEE light selection.

Reference: rustracer-core/src/lightdistrib.rs. The reference offers
UniformLightDistribution (lightdistrib.rs:37-54, the implicit uniform pick in
integrators/common.py) and SpatialLightDistribution (lightdistrib.rs:59-204):
a voxel grid over the scene bounds where each voxel holds a Distribution1D
over lights, built lazily on first lookup from 128 Halton-sampled unoccluded
contribution estimates and stored in a lock-free hash table.

Dense redesign: laziness and lock-free hashing make no sense on an
accelerator. We precompute the ENTIRE dense grid in one batched jitted pass
at scene-freeze time — every voxel's 128 Halton points × every light's
sample_li evaluated as one big masked tensor op — and a lookup becomes a
single row gather + a vectorized discrete-CDF inversion. Deterministic,
lock-free, and differentiable-safe (selection probabilities are constants).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

PRIMES = (2, 3, 5, 7, 11)
N_SAMPLES = 128          # lightdistrib.rs:126
MAX_VOXELS = 64          # path.rs preprocess: SpatialLightDistribution::new(scene, 64)
MIN_CONTRIB_FRAC = 1e-3  # lightdistrib.rs:163-166


def _radical_inverse_table(n_samples: int) -> np.ndarray:
    """(n_samples, 5) Halton points, bases 2,3,5,7,11 (lightdistrib.rs:129-143
    uses radical_inverse dims 0-4: 3 for the voxel point, 2 for the light u)."""
    out = np.zeros((n_samples, len(PRIMES)), np.float64)
    for d, base in enumerate(PRIMES):
        for i in range(n_samples):
            x, inv, j = 0.0, 1.0 / base, i
            while j:
                x += (j % base) * inv
                inv /= base
                j //= base
            out[i, d] = x
    return out.astype(np.float32)


class SpatialLightGrid(NamedTuple):
    """Dense per-voxel light PMF/CDF tables (device arrays)."""
    world_lo: Any        # (3,)
    world_inv_ext: Any   # (3,)
    n_voxels: Any        # (3,) int32
    strides: Any         # (3,) int32 flat-index strides
    pmf: Any             # (V, n_lights)
    cdf: Any             # (V, n_lights) inclusive cumsum, last column == 1


class _Probe(NamedTuple):
    """Minimal interaction for sample_li probes (lightdistrib.rs:135-140
    builds an Interaction with just a position)."""
    p: Any
    t: Any


def build_spatial_grid(lt, geom, world_lo, world_hi,
                       max_voxels: int = MAX_VOXELS,
                       n_samples: int = N_SAMPLES,
                       chunk_voxels: int = 1024) -> SpatialLightGrid:
    """Precompute the full voxel grid of light-selection PMFs.

    Voxel resolution follows lightdistrib.rs:71-78: the widest bounds axis
    gets max_voxels voxels, the others proportionally (roughly cubical).
    """
    import jax
    import jax.numpy as jnp

    from . import lights as L

    world_lo = np.asarray(world_lo, np.float32)
    world_hi = np.asarray(world_hi, np.float32)
    diag = np.maximum(world_hi - world_lo, 1e-6)
    b_max = float(diag.max())
    nv = np.maximum(1, np.round(diag / b_max * max_voxels)).astype(np.int64)
    n_l = lt.n_lights
    V = int(nv.prod())

    halton = jnp.asarray(_radical_inverse_table(n_samples))  # (S, 5)
    # voxel integer coords in C order: flat = (ix*ny + iy)*nz + iz
    coords = np.stack(np.meshgrid(np.arange(nv[0]), np.arange(nv[1]),
                                  np.arange(nv[2]), indexing="ij"),
                      -1).reshape(-1, 3).astype(np.float32)
    vox_ext = (diag / nv).astype(np.float32)

    @jax.jit
    def chunk_contrib(vox_lo):
        """(C, 3) voxel lower corners → (C, n_lights) contribution sums
        (lightdistrib.rs:126-155: sum li.y()/pdf, no visibility)."""
        c = vox_lo.shape[0]
        pts = vox_lo[:, None, :] + halton[None, :, :3] * vox_ext  # (C,S,3)
        u = jnp.broadcast_to(halton[None, :, 3:5], (c, n_samples, 2))
        probe = _Probe(p=pts, t=jnp.zeros((c, n_samples), jnp.float32))
        cols = []
        for j in range(n_l):
            lid = jnp.full((c, n_samples), j, jnp.int32)
            ls = L.sample_li(lt, geom, lid, probe, u)
            y = (0.212671 * ls.li[..., 0] + 0.715160 * ls.li[..., 1]
                 + 0.072169 * ls.li[..., 2])  # Spectrum::y (spectrum.rs)
            contrib = jnp.where(ls.pdf > 0.0,
                                y / jnp.maximum(ls.pdf, 1e-20), 0.0)
            cols.append(jnp.sum(contrib, axis=1))
        return jnp.stack(cols, axis=-1)

    rows = []
    for s in range(0, V, chunk_voxels):
        chunk = coords[s:s + chunk_voxels]
        vox_lo = world_lo + chunk * vox_ext
        # pad the last chunk so every call shares one compiled shape
        pad = chunk_voxels - vox_lo.shape[0]
        if pad:
            vox_lo = np.concatenate(
                [vox_lo, np.repeat(vox_lo[-1:], pad, 0)], 0)
        out = np.asarray(chunk_contrib(jnp.asarray(vox_lo, jnp.float32)))
        rows.append(out[:chunk.shape[0]] if pad else out)
    contrib = np.concatenate(rows, 0)  # (V, n_l)

    # floor so no light has zero probability (lightdistrib.rs:157-170)
    avg = contrib.sum(-1, keepdims=True) / (n_samples * n_l)
    min_c = np.where(avg > 0.0, MIN_CONTRIB_FRAC * avg, 1.0)
    contrib = np.maximum(contrib, min_c)
    pmf = contrib / contrib.sum(-1, keepdims=True)
    cdf = np.cumsum(pmf, -1)
    cdf[:, -1] = 1.0

    strides = np.array([nv[1] * nv[2], nv[2], 1], np.int32)
    import jax.numpy as jnp2
    return SpatialLightGrid(
        world_lo=jnp2.asarray(world_lo),
        world_inv_ext=jnp2.asarray((1.0 / diag).astype(np.float32)),
        n_voxels=jnp2.asarray(nv.astype(np.int32)),
        strides=jnp2.asarray(strides),
        pmf=jnp2.asarray(pmf.astype(np.float32)),
        cdf=jnp2.asarray(cdf.astype(np.float32)))


def sample_light(grid: SpatialLightGrid, p, u):
    """Per-lane light pick: p (..., 3) world points, u (...,) uniforms →
    (lid int32, pmf float32). Mirrors lookup (lightdistrib.rs:183-204) +
    Distribution1D::sample_discrete."""
    import jax.numpy as jnp

    off = (p - grid.world_lo) * grid.world_inv_ext
    vi = jnp.clip((off * grid.n_voxels).astype(jnp.int32), 0,
                  grid.n_voxels - 1)
    flat = jnp.sum(vi * grid.strides, axis=-1)
    cdf_rows = grid.cdf[flat]                        # (..., n_l) gather
    n_l = grid.pmf.shape[-1]
    lid = jnp.minimum(
        jnp.sum((u[..., None] >= cdf_rows).astype(jnp.int32), -1), n_l - 1)
    pmf = jnp.take_along_axis(grid.pmf[flat], lid[..., None], -1)[..., 0]
    return lid, pmf


def pmf_lookup(grid: SpatialLightGrid, p, lid):
    """Selection probability of light `lid` at point p — the density the
    emission-hit side of MIS must pair with sample_light's picks
    (lightdistrib.rs lookup + Distribution1D::discrete_pdf)."""
    import jax.numpy as jnp

    off = (p - grid.world_lo) * grid.world_inv_ext
    vi = jnp.clip((off * grid.n_voxels).astype(jnp.int32), 0,
                  grid.n_voxels - 1)
    flat = jnp.sum(vi * grid.strides, axis=-1)
    lid_c = jnp.clip(lid, 0, grid.pmf.shape[-1] - 1)
    return jnp.take_along_axis(grid.pmf[flat], lid_c[..., None], -1)[..., 0]
