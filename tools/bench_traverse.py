"""Microbenchmark + roofline: BVH traversal throughput on a dragon-class mesh.

Usage: python tools/bench_traverse.py [n_subdiv] [batch]

Reports, for the binary threaded kernel and the 16-wide kernel:
  rays/s, rows gathered per ray (mean/p99, measured by eager stepping on a
  sample), and the implied gather-row rate — so "fast" is auditable against
  the card's row-gather rate (tools/bench_gather_coherence.py): that row
  rate times rows/ray is the speed of light for gather-based traversal.

Refuses to run on any backend but a GPU; rates are printed with the card's
name and power limit.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rustracer_tpu.utils.meshgen import bumpy_sphere
from rustracer_tpu.accel.bvh import build_bvh_arrays
from rustracer_tpu.scene.tables import make_geometry
from rustracer_tpu.core.ray import Ray
from rustracer_tpu.utils.device import (card_label, configure_compile_cache,
                                        require_gpu)


def camera_like_rays(batch, seed=0):
    side = int(np.sqrt(batch))
    u = (np.arange(side) + 0.5) / side
    uu, vv = np.meshgrid(u, u)
    o = np.zeros((side * side, 3), np.float32)
    o[:, 2] = 3.0
    d = np.stack([(uu.ravel() - 0.5) * 1.2, (vv.ravel() - 0.5) * 1.2,
                  -np.ones(side * side)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(o=jnp.asarray(o), d=jnp.asarray(d),
               t_max=jnp.full(side * side, 1e30, jnp.float32))


def timed(f, geom, ray, reps=3):
    out = jax.block_until_ready(f(geom, ray))  # compile + run
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(geom, ray))
        times.append(time.perf_counter() - t0)
    return min(times), out


def measure_rows_per_ray(geom, ray, n_sample=4096):
    """Eager-step the wide kernel body on a sample, counting iterations
    (each iteration = ONE gathered row per live lane)."""
    from rustracer_tpu.accel import traverse16 as T
    B = min(n_sample, ray.t_max.shape[0])
    # stride-sample across the whole wavefront — the first B rays of a
    # camera grid are one image edge (often all misses)
    sel = np.linspace(0, ray.t_max.shape[0] - 1, B).astype(np.int32)
    r = Ray(o=ray.o[sel], d=ray.d[sel], t_max=ray.t_max[sel])
    D = geom.bvh16_depth_pad.shape[0]
    body = jax.jit(T._make_body(geom, False, D))

    def inv(c):
        return 1.0 / jnp.where(jnp.abs(c) < 1e-20,
                               jnp.where(c < 0, -1e-20, 1e-20), c)
    ox, oy, oz = r.o[..., 0], r.o[..., 1], r.o[..., 2]
    dx, dy, dz = r.d[..., 0], r.d[..., 1], r.d[..., 2]
    rayc = (ox, oy, oz, dx, dy, dz, inv(dx), inv(dy), inv(dz))
    octant = ((dx < 0).astype(jnp.int32) | ((dy < 0).astype(jnp.int32) << 1)
              | ((dz < 0).astype(jnp.int32) << 2))
    zero_i = jnp.zeros((B,), jnp.int32)
    s = (geom.bvh16_roots[octant], jnp.full((B,), T.FULL_MASK, jnp.int32),
         zero_i, r.t_max, jnp.full((B,), -1, jnp.int32), r.t_max <= 0.0,
         tuple(zero_i for _ in range(D)), tuple(zero_i for _ in range(D)),
         rayc, (zero_i, zero_i))
    iters = np.zeros(B, np.int64)
    for _ in range(1000):
        done = np.asarray(s[5])
        if done.all():
            break
        s = body(s)
        iters += ~done
    return iters


def main():
    sub = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 18
    configure_compile_cache()
    require_gpu("tools/bench_traverse.py")
    print(f"card: {card_label()}")
    verts, normals, faces = bumpy_sphere(subdivisions=sub)
    print(f"mesh: {len(faces)} tris, {len(verts)} verts", file=sys.stderr)

    tris = dict(
        tv_p=verts, tv_n=normals,
        tv_uv=np.zeros((len(verts), 2), np.float32),
        tv_s=np.zeros((len(verts), 3), np.float32),
        t_idx=faces.astype(np.int32),
        t_material=np.zeros(len(faces), np.int32),
        t_arealight=np.full(len(faces), -1, np.int32),
        t_reverse=np.zeros(len(faces), bool),
        t_has_n=np.ones(len(faces), bool),
        t_has_uv=np.zeros(len(faces), bool),
        t_alpha_tex=np.full(len(faces), -1, np.int32),
    )
    t0 = time.perf_counter()
    bvh = build_bvh_arrays(None, tris)
    print(f"build: {time.perf_counter()-t0:.2f}s  binary nodes "
          f"{bvh['bvh_meta'].shape[0]}, wide rows "
          f"{bvh['bvh16_table'].shape[0]}, wide depth "
          f"{int(bvh['bvh16_depth']) if 'bvh16_depth' in bvh else '?'}",
          file=sys.stderr)
    geom = make_geometry(None, tris, bvh)
    ray = camera_like_rays(batch)
    B = ray.t_max.shape[0]

    from rustracer_tpu.accel.traverse import bvh_intersect_triangles
    from rustracer_tpu.accel.traverse16 import (bvh16_intersect_p_triangles,
                                                bvh16_intersect_triangles)

    iters = measure_rows_per_ray(geom, ray)
    print(f"wide rows/ray: mean {iters.mean():.1f}  "
          f"p50 {np.percentile(iters, 50):.0f}  "
          f"p99 {np.percentile(iters, 99):.0f}  max {iters.max()}")

    rows = []
    for name, f in [("wide-closest", jax.jit(bvh16_intersect_triangles)),
                    ("wide-anyhit", jax.jit(bvh16_intersect_p_triangles)),
                    ("binary-closest", jax.jit(bvh_intersect_triangles))]:
        dt, out = timed(f, geom, ray)
        mrays = B / dt / 1e6
        row_rate = mrays * iters.mean() if name.startswith("wide") else None
        extra = (f"  implied row rate {row_rate:.0f} M rows/s"
                 if row_rate else "")
        print(f"{name:16s}: {dt*1e3:7.1f} ms  {mrays:7.2f} Mray/s  "
              f"bytes/lane-step 512{extra}")
        rows.append((name, dt, mrays))
    hit = np.asarray(out[0]) if isinstance(out, tuple) else np.asarray(out)
    print(f"hit fraction: {hit.mean():.3f}", file=sys.stderr)


if __name__ == "__main__":
    main()
