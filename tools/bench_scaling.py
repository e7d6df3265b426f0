"""Scaling-efficiency harness: sharded render step time at data=1,2,4,...,N.

BASELINE.md demands >=80% scaling efficiency from 1 card to N. This tool
measures it on the GPUs of one host and refuses any other backend (virtual
CPU devices timeshare the same cores, so their "efficiency" measures host
contention); rates carry the cards' names and power limits.

Weak scaling: each device renders a fixed LANES_PER_DEVICE slab of Cornell
lanes with the full path integrator + psum film merge; a perfectly-scaling
run keeps step time flat as devices are added.
efficiency(N) = t(1) / t(N).

Usage: python tools/bench_scaling.py [lanes_per_device] [spp]
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rustracer_tpu.utils.device import (card_label,  # noqa: E402
                                        configure_compile_cache,
                                        require_gpu)


def build_step(mesh, res=(64, 64), spp=2):
    from helpers import cornell_box, cornell_camera
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.parallel.mesh import make_sharded_render_step

    geom, lights = cornell_box()
    ms = MaterialSet()
    const = {}
    for i, a in enumerate([[0.73] * 3, [0.63, 0.065, 0.05],
                           [0.14, 0.45, 0.09], [0.0] * 3]):
        const[f"kd{i}"] = jnp.asarray(a, jnp.float32)
        ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
    ctx = RenderContext(geom=geom, lights=lights,
                        textures={"const": const, "images": []})
    cam = cornell_camera(res)
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    sampler = SamplerConfig(kind="02sequence", spp=spp)
    integ = PathIntegrator(mat_set=ms, max_depth=4)
    step = make_sharded_render_step(integ.li, cam, film, sampler, mesh)
    return ctx, step, res


def time_mesh(n_data, lanes_per_device, spp, reps=5):
    from rustracer_tpu.parallel.mesh import make_device_mesh
    devices = jax.devices()[:n_data]
    mesh = make_device_mesh(data=n_data, sample=1, devices=devices)
    ctx, step, res = build_step(mesh, spp=spp)
    n_lanes = lanes_per_device * n_data
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.integers(0, res[0], n_lanes).astype(np.int32))
    py = jnp.asarray(rng.integers(0, res[1], n_lanes).astype(np.int32))
    valid = jnp.ones(n_lanes, bool)
    fs = step(ctx, px, py, valid, jnp.uint32(0))
    jax.block_until_ready(fs)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fs = step(ctx, px, py, valid, jnp.uint32(0))
        jax.block_until_ready(fs)
        times.append(time.perf_counter() - t0)
    return min(times)


def time_plain(lanes_per_device, spp, reps=5):
    """Same lane slab through the UNsharded single-device step — isolates
    the shard_map/psum machinery overhead (t_shard(1) / t_plain)."""
    from rustracer_tpu.parallel.mesh import make_device_mesh
    mesh = make_device_mesh(data=1, sample=1, devices=jax.devices()[:1])
    ctx, _, res = build_step(mesh, spp=spp)
    from helpers import cornell_camera
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.parallel.mesh import _lane_step

    ms = MaterialSet()
    for i in range(4):
        ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
    cam = cornell_camera(res)
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    sampler = SamplerConfig(kind="02sequence", spp=spp)
    integ = PathIntegrator(mat_set=ms, max_depth=4)
    step = jax.jit(lambda ctx, px, py, valid, s: _lane_step(
        ctx, px, py, valid, s, integ.li, cam, film, sampler))
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.integers(0, res[0], lanes_per_device)
                     .astype(np.int32))
    py = jnp.asarray(rng.integers(0, res[1], lanes_per_device)
                     .astype(np.int32))
    valid = jnp.ones(lanes_per_device, bool)
    fs = step(ctx, px, py, valid, jnp.uint32(0))
    jax.block_until_ready(fs)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(ctx, px, py, valid, jnp.uint32(0)))
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 14
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    configure_compile_cache()
    dev = require_gpu("tools/bench_scaling.py")
    n_dev = dev["count"]
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    print(f"devices: {n_dev} x {dev['kind']} ({card_label()}), "
          f"{lanes} lanes/device, {spp} spp  (weak scaling)")
    tp = time_plain(lanes, spp)
    print(f"unsharded 1-device step: {tp * 1e3:.1f} ms "
          f"(sharding overhead shows in the data=1 row)")
    print(f"{'data':>5} {'step ms':>9} {'Mray/s':>8} {'eff':>6}")
    t1 = None
    rows = []
    for n in sizes:
        t = time_mesh(n, lanes, spp)
        t1 = t if t1 is None else t1
        mrays = lanes * n * spp / t / 1e6
        eff = t1 / t
        rows.append((n, t, mrays, eff))
        print(f"{n:>5} {t * 1e3:>9.1f} {mrays:>8.2f} {eff:>6.1%}")
    return rows


if __name__ == "__main__":
    main()
