"""Bathroom 1080p step breakdown.

Decomposes the bathroom render step by timing the full step against
surgically-stubbed variants (same shapes, same scene):
  - depth-1        : camera traversal + emission only (prologue floor)
  - no-NEE         : estimate_direct_light_side stubbed to zeros — removes
                     shadow-ray traversal + light sampling/eval
  - ewa-1tap       : atlas EWA forced to 1 filter tap (instead of 8) —
                     bounds the texture-filtering share
  - closest-hit    : standalone bvh16 traversal on the camera wavefront
                     (per-traversal cost floor for this geometry)

Each variant is timed post-compile on a 2-spp slice at 1080p, like the
bench. Differences are coarse (stubs also change downstream dead-lane
masks) but give an honest first map of where the bathroom's step goes.
Runs on the GPU only; rates carry the card's name and power limit.
Usage: python tools/profile_bathroom.py [xres yres]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rustracer_tpu.utils.device import (card_label, configure_compile_cache,
                                        require_gpu)


def timed_render(ctx, cam, film, sampler, integ, res, label, n_runs=2,
                 spp_measure=2):
    from rustracer_tpu.render.renderer import Renderer, RenderConfig
    cfg = RenderConfig(max_lanes=1 << 18, collect_stats=False)
    r = Renderer(integ.li, cam, film, sampler, cfg)
    t0 = time.perf_counter()
    jax.block_until_ready(r.render_state(ctx, sample_stop=1))
    print(f"  [{label}] compiled in {time.perf_counter()-t0:.0f}s",
          flush=True)
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        jax.block_until_ready(r.render_state(ctx, sample_stop=spp_measure))
        times.append(time.perf_counter() - t0)
    best = min(times)
    rays = res[0] * res[1] * spp_measure
    print(f"  [{label}] {best:7.2f}s for {spp_measure} spp "
          f"-> {rays/best/1e3:8.1f} krays/s", flush=True)
    return best


def main():
    res = (int(sys.argv[1]), int(sys.argv[2])) if len(sys.argv) > 2 \
        else (1920, 1080)
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    from bench import build_bathroom
    import dataclasses
    configure_compile_cache()
    require_gpu("tools/profile_bathroom.py")
    print(f"card: {card_label()}", flush=True)

    print(f"building bathroom {res} ...", flush=True)
    ctx, cam, film, sampler, integ = build_bathroom(res)

    results = {}
    results["full"] = timed_render(ctx, cam, film, sampler, integ, res,
                                   "full")

    # depth-1: emission-only prologue
    integ_d1 = dataclasses.replace(integ, max_depth=1)
    results["depth1"] = timed_render(ctx, cam, film, sampler, integ_d1, res,
                                     "depth-1")

    # no-NEE: stub the light-side MIS estimator
    from rustracer_tpu.integrators import path as P
    orig_ed = P.estimate_direct_light_side
    try:
        def no_nee(ctx_, mat_set, si, lobes, lid, u_light, pmf):
            z = jnp.zeros(si.t.shape + (3,), jnp.float32)
            return z, jnp.int32(0)
        P.estimate_direct_light_side = no_nee
        results["no_nee"] = timed_render(ctx, cam, film, sampler, integ, res,
                                         "no-NEE")
    finally:
        P.estimate_direct_light_side = orig_ed

    # ewa-1tap: collapse the atlas filter to a single tap
    from rustracer_tpu.scene import atlas as AT
    orig_ewa = AT.atlas_lookup_ewa
    try:
        def one_tap(texels, meta, levels, regs, reg, si, **kw):
            kw.update(max_anisotropy=8.0, n_taps=1)
            return orig_ewa(texels, meta, levels, regs, reg, si, **kw)
        AT.atlas_lookup_ewa = one_tap
        # materials.py imports the symbol at call time (from .atlas import)
        results["ewa_1tap"] = timed_render(ctx, cam, film, sampler, integ,
                                           res, "ewa-1tap")
    finally:
        AT.atlas_lookup_ewa = orig_ewa

    # standalone closest-hit on the camera wavefront
    from rustracer_tpu.accel.traverse16 import bvh16_intersect_triangles
    from rustracer_tpu.render.renderer import Lanes
    from rustracer_tpu.render.sampler import DimAllocator
    B = 1 << 18
    xr, yr = res
    idx = np.arange(B, dtype=np.int64) % (xr * yr)
    px = jnp.asarray((idx % xr).astype(np.int32))
    py = jnp.asarray((idx // xr).astype(np.int32))
    pixel_idx = (py.astype(jnp.uint32) * jnp.uint32(xr)
                 + px.astype(jnp.uint32))
    pixel_xy = jnp.stack([px, py], -1).astype(jnp.float32)
    p_film, p_lens, _ = sampler.get_camera_sample(
        pixel_xy, pixel_idx, jnp.zeros_like(pixel_idx))
    ray = cam.generate_ray_differential(p_film, p_lens)

    def hitsum(o, d, t):
        from rustracer_tpu.core.ray import Ray
        h, tt, pid = bvh16_intersect_triangles(
            ctx.geom, Ray(o=o, d=d, t_max=t))
        return jnp.sum(jnp.where(h, tt, 0.0)) + jnp.sum(pid)
    f = jax.jit(hitsum)
    float(f(ray.o, ray.d, ray.t_max))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(f(ray.o, ray.d, ray.t_max))
        ts.append(time.perf_counter() - t0)
    thit = min(ts)
    print(f"  [closest-hit] {B} rays in {thit*1e3:.1f} ms "
          f"-> {B/thit/1e6:.2f} Mray/s", flush=True)

    print("\nbreakdown (2 spp slice):", flush=True)
    full = results["full"]
    print(f"  full step          {full:7.2f}s  (100%)")
    print(f"  depth-1 prologue   {results['depth1']:7.2f}s "
          f"({100*results['depth1']/full:.0f}%)")
    print(f"  NEE share          {full-results['no_nee']:7.2f}s "
          f"({100*(full-results['no_nee'])/full:.0f}%)")
    print(f"  EWA-taps share     {(full-results['ewa_1tap'])*8/7:7.2f}s "
          f"({100*(full-results['ewa_1tap'])*8/7/full:.0f}% extrapolated "
          f"8-tap)")
    print(f"  closest-hit/2^18   {thit:7.3f}s")


if __name__ == "__main__":
    main()
