"""Dragon (matte hero) step breakdown — where does a camera ray's time go?

Same stub-ablation methodology as profile_bathroom.py, applied to the
headline config: the matte 327k-tri dragon at 1024^2, depth 5, 2^18-lane
wavefronts. It compares the full step with stubbed variants to map how
much of it is traversal and how much per-bounce wavefront machinery:

  - depth-1     : camera traversal + emission only (prologue floor)
  - no-NEE      : estimate_direct_light_side stubbed to zeros
  - flat-sampler: get_1d/get_2d return cheap constants — bounds the
                  (0,2)-sequence scramble/Gray-code share
  - no-compact  : inter-bounce half-compaction disabled (its benefit)
  - closest-hit : standalone bvh16 traversal on the camera wavefront

Runs on the GPU only; rates carry the card's name and power limit.
Usage: python tools/profile_dragon.py [spp_measure]
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

RES = (1024, 1024)


def timed_render(ctx, cam, film, sampler, integ, label, n_runs=2,
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
    rays = RES[0] * RES[1] * spp_measure
    print(f"  [{label}] {best:7.2f}s for {spp_measure} spp "
          f"-> {rays/best/1e3:8.1f} krays/s", flush=True)
    return best


def build_matte_dragon():
    import dataclasses
    from bench import build_dragon
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture
    ctx, cam, film, sampler, integ, n_tris = build_dragon()
    ms2 = MaterialSet()
    ms2.add(MatteMaterial(kd=ConstantTexture("kd_floor")))
    ms2.add(MatteMaterial(kd=ConstantTexture("kd_dragon")))
    ms2.add(MatteMaterial(kd=ConstantTexture("kd_black")))
    const2 = dict(ctx.textures["const"])
    const2["kd_dragon"] = jnp.asarray([0.55, 0.45, 0.35], jnp.float32)
    ctx2 = ctx._replace(textures={"const": const2, "images": []})
    integ2 = dataclasses.replace(integ, mat_set=ms2)
    return ctx2, cam, film, sampler, integ2


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    import dataclasses
    configure_compile_cache()
    require_gpu("tools/profile_dragon.py")
    print(f"card: {card_label()}", flush=True)

    print("building matte dragon ...", flush=True)
    ctx, cam, film, sampler, integ = build_matte_dragon()

    results = {}
    results["full"] = timed_render(ctx, cam, film, sampler, integ, "full",
                                   spp_measure=spp)

    integ_d1 = dataclasses.replace(integ, max_depth=1)
    results["depth1"] = timed_render(ctx, cam, film, sampler, integ_d1,
                                     "depth-1", spp_measure=spp)

    integ_d2 = dataclasses.replace(integ, max_depth=2)
    results["depth2"] = timed_render(ctx, cam, film, sampler, integ_d2,
                                     "depth-2", spp_measure=spp)

    from rustracer_tpu.integrators import path as P
    orig_ed = P.estimate_direct_light_side
    try:
        def no_nee(ctx_, mat_set, si, lobes, lid, u_light, pmf):
            z = jnp.zeros(si.t.shape + (3,), jnp.float32)
            return z, jnp.int32(0)
        P.estimate_direct_light_side = no_nee
        results["no_nee"] = timed_render(ctx, cam, film, sampler, integ,
                                         "no-NEE", spp_measure=spp)
    finally:
        P.estimate_direct_light_side = orig_ed

    # flat sampler: constants instead of scrambled (0,2)-sequence points.
    # Timing-only (RR/light picks degenerate); bounds the sampler share.
    from rustracer_tpu.render.sampler import SamplerConfig
    o1, o2 = SamplerConfig.get_1d, SamplerConfig.get_2d
    try:
        SamplerConfig.get_1d = lambda self, p, s, d: \
            jnp.full(p.shape, 0.5, jnp.float32)
        SamplerConfig.get_2d = lambda self, p, s, d: \
            jnp.full(p.shape + (2,), 0.5, jnp.float32)
        results["flat_sampler"] = timed_render(
            ctx, cam, film, sampler, integ, "flat-sampler", spp_measure=spp)
    finally:
        SamplerConfig.get_1d, SamplerConfig.get_2d = o1, o2

    integ_nc = dataclasses.replace(integ, compact_interior=False)
    results["no_compact"] = timed_render(ctx, cam, film, sampler, integ_nc,
                                         "no-compact", spp_measure=spp)

    # standalone closest hit on the camera wavefront
    from rustracer_tpu.accel.traverse16 import bvh16_intersect_triangles
    B = 1 << 18
    xr, yr = RES
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

    full = results["full"]
    print(f"\nbreakdown ({spp} spp slice, {RES[0]}x{RES[1]}):", flush=True)
    print(f"  full step          {full:7.2f}s  (100%)")
    for k in ("depth1", "depth2", "no_nee", "flat_sampler", "no_compact"):
        print(f"  {k:18s} {results[k]:7.2f}s ({100*results[k]/full:.0f}%)")
    print(f"  NEE share          {full-results['no_nee']:7.2f}s "
          f"({100*(full-results['no_nee'])/full:.0f}%)")
    print(f"  sampler share      {full-results['flat_sampler']:7.2f}s "
          f"({100*(full-results['flat_sampler'])/full:.0f}%)")
    print(f"  compaction benefit {results['no_compact']-full:7.2f}s "
          f"({100*(results['no_compact']-full)/full:.0f}%)")
    print(f"  closest-hit/2^18   {thit:7.3f}s")


if __name__ == "__main__":
    main()
