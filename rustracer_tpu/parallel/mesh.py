"""Multi-device sharded rendering and training over a jax Mesh.

Reference: rustracer-core/src/renderer.rs:56-76 — the reference's entire
parallel runtime is N threads pulling image tiles from a locked queue. The
wavefront equivalent (SURVEY §2.4, §5.8): lanes (pixels x samples) shard
over a device mesh with `shard_map`; each device accumulates a partial film
which is `psum`-reduced over the mesh (the film merge under mutex becomes a
collective); scene tables are replicated. The differentiable training step
psums parameter gradients the same way, device to device.

Mesh axes (the cards of one host are joined all to all, so the mesh shape
follows the algorithm alone):
  "data"   — pixel/tile data parallelism
  "sample" — samples-per-pixel parallelism (the wavefront analog of
             sequence parallelism; SURVEY §5.7)
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..render.film import Film, FilmState
from ..render.renderer import Lanes, RenderContext, scrub_radiance
from ..render.sampler import DimAllocator, SamplerConfig


def make_device_mesh(data: int = 0, sample: int = 1, devices=None) -> Mesh:
    """Mesh over available devices; data axis fills what sample doesn't."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data <= 0:
        data = n // sample
    assert data * sample == n, f"mesh {data}x{sample} != {n} devices"
    dev = np.asarray(devices).reshape(data, sample)
    return Mesh(dev, ("data", "sample"))


def _lane_step(ctx, px, py, valid, sample_idx, li_fn, camera, film, sampler):
    """One (pixels x one-sample) pass → partial FilmState (local lanes)."""
    xr, _ = film.full_resolution
    pixel_idx = (py.astype(jnp.uint32) * jnp.uint32(xr) + px.astype(jnp.uint32))
    lanes = Lanes(pixel_idx=pixel_idx,
                  sample_idx=jnp.broadcast_to(sample_idx, pixel_idx.shape)
                  .astype(jnp.uint32))
    pixel_xy = jnp.stack([px, py], axis=-1).astype(jnp.float32)
    p_film, p_lens, _ = sampler.get_camera_sample(pixel_xy, lanes.pixel_idx,
                                                  lanes.sample_idx)
    ray = camera.generate_ray_differential(p_film, p_lens)
    ray = ray.scaled_differentials(1.0 / np.sqrt(max(1, sampler.spp)))
    dims = DimAllocator()
    L = li_fn(ctx, ray, lanes, sampler, dims)
    L = scrub_radiance(L)
    return film.add_samples(film.init_state(), p_film, L, valid=valid)


def make_sharded_render_step(li_fn, camera, film: Film, sampler: SamplerConfig,
                             mesh: Mesh):
    """Build the pjit'ed multi-device render step.

    Signature: step(ctx, px, py, valid, sample_lo) → FilmState (replicated).
    px/py/valid are (n_data * L,) lane arrays sharded over "data"; each
    device additionally renders a different sample index over "sample"
    (sample_lo + its sample-axis coordinate), so one call accumulates
    `sample` spp for every lane.
    """
    n_sample = mesh.shape["sample"]

    def local_step(ctx, px, py, valid, sample_lo):
        s_idx = jax.lax.axis_index("sample").astype(jnp.uint32)
        fs = _lane_step(ctx, px, py, valid, sample_lo + s_idx,
                        li_fn, camera, film, sampler)
        # film merge: the reference's mutex merge → mesh psum
        rgb = jax.lax.psum(fs.rgb, ("data", "sample"))
        wsum = jax.lax.psum(fs.wsum, ("data", "sample"))
        splat = jax.lax.psum(fs.splat, ("data", "sample"))
        return FilmState(rgb=rgb, wsum=wsum, splat=splat)

    replicated = P()
    sharded = P("data")
    step = shard_map(local_step, mesh=mesh,
                     in_specs=(replicated, sharded, sharded, sharded,
                               replicated),
                     out_specs=replicated, check_vma=False)
    return jax.jit(step)


def render_sharded(ctx: RenderContext, li_fn, camera, film: Film,
                   sampler: SamplerConfig, mesh: Mesh, max_lanes=1 << 16,
                   progress=False):
    """Full sharded render (mirrors render/renderer.py render loop)."""
    import time
    n_data = mesh.shape["data"]
    n_sample = mesh.shape["sample"]
    assert sampler.spp % n_sample == 0, \
        f"spp {sampler.spp} must divide by sample axis {n_sample}"
    x0, y0, x1, y1 = film.get_sample_bounds()
    xs = np.arange(x0, x1, dtype=np.int32)
    ys = np.arange(y0, y1, dtype=np.int32)
    gx, gy = np.meshgrid(xs, ys)
    px_all, py_all = gx.ravel(), gy.ravel()
    n = px_all.size
    tile = min(max_lanes, n)
    tile = -(-tile // n_data) * n_data          # divisible by data axis
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    valid = np.ones(n, bool)
    if pad:
        px_all = np.concatenate([px_all, np.full(pad, x0, np.int32)])
        py_all = np.concatenate([py_all, np.full(pad, y0, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])

    step = make_sharded_render_step(li_fn, camera, film, sampler, mesh)
    acc = film.init_state()
    t_start = time.time()
    for ti in range(n_tiles):
        sl = slice(ti * tile, (ti + 1) * tile)
        for s in range(0, sampler.spp, n_sample):
            fs = step(ctx, jnp.asarray(px_all[sl]), jnp.asarray(py_all[sl]),
                      jnp.asarray(valid[sl]), jnp.uint32(s))
            acc = FilmState(rgb=acc.rgb + fs.rgb, wsum=acc.wsum + fs.wsum,
                            splat=acc.splat + fs.splat)
        if progress:
            done = (ti + 1) / n_tiles
            el = time.time() - t_start
            print(f"  shard-tile {ti + 1}/{n_tiles} elapsed {el:.1f}s",
                  flush=True)
    return film.to_image(acc)


def make_sharded_train_step(li_fn, camera, film: Film, sampler: SamplerConfig,
                            mesh: Mesh, lr=0.1):
    """Differentiable inverse-rendering step over the mesh.

    loss = mean((render(params) - target)^2); gradients w.r.t. the texture/
    material parameter pytree (ctx.textures) are psum-reduced across devices
    (the "gradient reduction backend", SURVEY §2.4) and applied with SGD.

    Signature: train(ctx, target, px, py, valid, sample_lo)
             → (new_ctx, loss (replicated scalar))
    """

    def local_render(ctx, px, py, valid, sample_lo):
        s_idx = jax.lax.axis_index("sample").astype(jnp.uint32)
        fs = _lane_step(ctx, px, py, valid, sample_lo + s_idx,
                        li_fn, camera, film, sampler)
        rgb = jax.lax.psum(fs.rgb, ("data", "sample"))
        wsum = jax.lax.psum(fs.wsum, ("data", "sample"))
        return FilmState(rgb=rgb, wsum=wsum, splat=jnp.zeros_like(rgb))

    replicated = P()
    sharded = P("data")
    render = shard_map(local_render, mesh=mesh,
                       in_specs=(replicated, sharded, sharded, sharded,
                                 replicated),
                       out_specs=replicated, check_vma=False)

    # Differentiate THROUGH the shard_map: jax's collective transpose
    # machinery inserts the gradient reduction (the psum over the mesh)
    # with the correct scaling. Hand-psum'ing per-device grads inside the
    # shard_map double-counts the film psum's transpose under
    # check_vma=False (caught by tests/test_mesh.py 1-vs-N parity).
    # Only FLOAT leaves of ctx.textures are trainable: atlas metadata
    # (atlas_meta/atlas_levels int32 offset tables) rides along untouched
    # (jax.grad rejects integer inputs).
    def step(ctx, target, px, py, valid, sample_lo):
        leaves, treedef = jax.tree.flatten(ctx.textures)
        is_f = [jnp.issubdtype(jnp.result_type(l), jnp.floating)
                for l in leaves]

        def merge(theta):
            it = iter(theta)
            return treedef.unflatten(
                [next(it) if b else l for l, b in zip(leaves, is_f)])

        def loss_fn(theta):
            fs = render(ctx._replace(textures=merge(theta)), px, py, valid,
                        sample_lo)
            img = film.to_image(fs)
            return jnp.mean((img - target) ** 2)

        theta0 = [l for l, b in zip(leaves, is_f) if b]
        loss, grads = jax.value_and_grad(loss_fn)(theta0)
        new_theta = [p - lr * g for p, g in zip(theta0, grads)]
        return ctx._replace(textures=merge(new_theta)), loss

    return jax.jit(step)
