"""Sweep the wide-traversal divergence constants on real hardware.

The two-phase traversal (accel/traverse16.py) pays a full-width gather per
iteration for EVERY lane, finished or not, during the majority pass; the
compacted drain rounds then pay argsort + scatter overhead per round. The
optimum MAJORITY_ITERS / TAIL_FRACTION depends on the rows/ray distribution
(bench_traverse.py: p50 ~2, p99 ~21 on a dragon-class mesh), so this sweeps
both on the GPU (and refuses any other backend) and prints a table with the
card's name and power limit. Usage:

    python tools/sweep_traverse.py [n_subdiv] [batch]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np

from rustracer_tpu.utils.meshgen import bumpy_sphere
from rustracer_tpu.accel.bvh import build_bvh_arrays
from rustracer_tpu.scene.tables import make_geometry
from rustracer_tpu.accel import traverse16 as T
from rustracer_tpu.utils.device import (card_label,  # noqa: E402
                                        configure_compile_cache,
                                        require_gpu)
from bench_traverse import camera_like_rays, timed  # noqa: E402


def main():
    sub = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 18
    configure_compile_cache()
    require_gpu("tools/sweep_traverse.py")
    print(f"card: {card_label()}")
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
    bvh = build_bvh_arrays(None, tris)
    geom = make_geometry(None, tris, bvh)
    ray = camera_like_rays(batch)
    B = ray.t_max.shape[0]
    print(f"mesh {len(faces)} tris, batch {B}", file=sys.stderr)

    configs = [(12, 8), (6, 8), (4, 8), (2, 8), (4, 16), (2, 16), (2, 4)]
    best = None
    for m, tf in configs:
        T.MAJORITY_ITERS = m
        T.TAIL_FRACTION = tf
        f = jax.jit(lambda g, r: T.bvh16_intersect_triangles(g, r))
        dt, _ = timed(f, geom, ray)
        mrays = B / dt / 1e6
        print(f"majority={m:3d} tail=1/{tf:<3d}: {dt*1e3:7.1f} ms  "
              f"{mrays:6.2f} Mray/s")
        if best is None or dt < best[0]:
            best = (dt, m, tf)
    print(f"best: majority={best[1]} tail=1/{best[2]}  "
          f"{B/best[0]/1e6:.2f} Mray/s")


if __name__ == "__main__":
    main()
