"""Sweep the ray-regeneration driver constants (A = active window,
S = steps between refills) on the dragon-class mesh, closest hit, on the
GPU (any other backend is refused); rates carry the card's name and power
limit.

Usage: python tools/sweep_regen.py [log2_batch]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rustracer_tpu.accel import traverse16 as t16
from rustracer_tpu.accel.bvh import build_bvh_arrays
from rustracer_tpu.scene.tables import make_geometry
from rustracer_tpu.utils.meshgen import bumpy_sphere
from rustracer_tpu.utils.device import (card_label, configure_compile_cache,
                                        require_gpu)
from bench_traverse import camera_like_rays


def dragon_geom(sub=7):
    verts, normals, faces = bumpy_sphere(subdivisions=sub)
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
    return make_geometry(None, tris, build_bvh_arrays(None, tris))


def main():
    lb = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    B = 1 << lb
    configure_compile_cache()
    require_gpu("tools/sweep_regen.py")
    print(f"card: {card_label()}")
    geom = dragon_geom()
    rays = camera_like_rays(B)

    def timed(f, reps=4):
        def once(ry):
            h, t, pid = f(geom, ry, False)[:3]
            return jnp.sum(jnp.where(h, t, 0.0)) + jnp.sum(pid)
        r = jax.jit(once)
        jax.block_until_ready(r(rays))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(r(rays))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    print(f"B=2^{lb}; plain driver (majority={t16.MAJORITY_ITERS}, "
          f"tail=1/{t16.TAIL_FRACTION}) vs regen (A, S, FRAC):", flush=True)
    t16.REGEN_MIN_B = 1 << 40          # force plain
    dt = timed(t16._traverse16)
    print(f"plain                : {dt*1e3:8.1f} ms  {B/dt/1e6:6.2f} Mray/s",
          flush=True)
    cfgs = [(13, 8, 4),                      # current production point
            (13, 4, 4), (13, 2, 4),          # eager refill
            (13, 2, 8), (13, 2, 16),
            (13, 1, 16), (13, 4, 8),
            (14, 2, 8), (14, 4, 8)]
    if len(sys.argv) > 2:                    # legacy full sweep
        cfgs = [(14, 16, 1 << 20), (14, 8, 1 << 20),
                (13, 16, 1 << 20), (13, 8, 1 << 20),
                (14, 16, 4), (13, 8, 4), (13, 16, 4),
                (14, 32, 1 << 20)]
    for lA, S, frac in cfgs:
        t16.REGEN_ACTIVE = 1 << lA
        t16.REGEN_STEPS = S
        t16.REGEN_REFILL_FRAC = frac
        dt = timed(t16._traverse16_regen)
        print(f"regen A=2^{lA} S={S:3d} F={frac}: {dt*1e3:8.1f} ms  "
              f"{B/dt/1e6:6.2f} Mray/s", flush=True)


if __name__ == "__main__":
    main()
