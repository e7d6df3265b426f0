"""Instanced-array flagship render: a 5x5 grid of instanced hero meshes
(one shared 81,920-tri object -> 2.05M effective triangles through the
two-level BVH's instance records) under an area light, path-traced on the
GPU. Demonstrates shared-geometry instancing at scale
(reference primitive.rs:89-118 TransformedPrimitive).

Writes renders/rt-instanced-5x5.png and prints rays/s with the card's name
and power limit; refuses to run on any backend but a GPU.
Usage: python tools/gen_instanced_gallery.py [subdiv] [res] [spp]
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax.numpy as jnp
import numpy as np

from rustracer_tpu.accel.wide import build_wide_scene
from rustracer_tpu.core.transform import Transform
from rustracer_tpu.render.camera import PerspectiveCamera
from rustracer_tpu.render.film import Film
from rustracer_tpu.render.filters import Filter
from rustracer_tpu.render.renderer import RenderConfig, RenderContext, Renderer
from rustracer_tpu.render.sampler import SamplerConfig
from rustracer_tpu.scene.lights import LIGHT_AREA, make_lights
from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
from rustracer_tpu.scene.tables import make_geometry
from rustracer_tpu.scene.textures import ConstantTexture
from rustracer_tpu.utils.device import (card_label, configure_compile_cache,
                                        require_gpu)
from rustracer_tpu.utils.meshgen import bumpy_sphere


def build(subdiv=6, res=(1024, 768), spp=16, grid=5):
    mv, mn, mf = bumpy_sphere(subdivisions=subdiv, radius=0.45)

    # static: ground + light quad
    static_v = np.array([
        [-9, 0, -9], [9, 0, -9], [9, 0, 9], [-9, 0, 9],
        [-1.5, 6.0, -1.5], [1.5, 6.0, -1.5], [1.5, 6.0, 1.5], [-1.5, 6.0, 1.5],
    ], np.float32)
    static_f = np.array([
        [0, 1, 2], [0, 2, 3],
        [4, 5, 6], [4, 6, 7],          # wound so ng points DOWN (-y)
    ], np.int32)
    # verify light winding: ng = cross(p1-p0, p2-p0) must have y < 0
    p0, p1, p2 = static_v[4], static_v[5], static_v[6]
    assert np.cross(p1 - p0, p2 - p0)[1] < 0, "light faces away"

    gv = np.concatenate([static_v, mv])
    gi = np.concatenate([static_f, mf + len(static_v)])
    n_static, n_mesh = len(static_f), len(mf)
    tris = dict(
        tv_p=gv,
        tv_n=np.concatenate([np.zeros((8, 3), np.float32), mn]),
        tv_uv=np.zeros((len(gv), 2), np.float32),
        tv_s=np.zeros((len(gv), 3), np.float32),
        t_idx=gi,
        t_material=np.concatenate([np.array([0, 0, 2, 2], np.int32),
                                   np.full(n_mesh, 1, np.int32)]),
        t_arealight=np.concatenate([np.array([-1, -1, 0, 1], np.int32),
                                    np.full(n_mesh, -1, np.int32)]),
        t_reverse=np.zeros(n_static + n_mesh, bool),
        t_has_n=np.concatenate([np.zeros(n_static, bool),
                                np.ones(n_mesh, bool)]),
        t_has_uv=np.zeros(n_static + n_mesh, bool),
        t_alpha_tex=np.full(n_static + n_mesh, -1, np.int32),
    )

    rng = np.random.default_rng(7)
    instances = []
    for i in range(grid):
        for j in range(grid):
            ang = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(ang), np.sin(ang)
            sc = rng.uniform(0.8, 1.25)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                 np.float32) * sc
            m[:3, 3] = (1.6 * (i - (grid - 1) / 2),
                        0.45 * sc + 0.02,
                        1.6 * (j - (grid - 1) / 2))
            instances.append(dict(obj=0, o2w=m, w2o=np.linalg.inv(m),
                                  flip=False))
    objects = [(n_static, n_static + n_mesh)]
    t0 = time.time()
    wide = build_wide_scene(tris, objects, instances)
    geom = make_geometry(tris=tris, bvh=wide)
    print(f"instanced build: {n_mesh} object tris x {len(instances)} "
          f"instances = {n_mesh*len(instances)/1e6:.2f}M effective "
          f"({time.time()-t0:.1f}s)", flush=True)

    nq = 1
    emit = (30.0, 30.0, 30.0)
    rows = [dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=emit, prim=nq + 2,
                 twosided=False),
            dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=emit, prim=nq + 3,
                 twosided=False)]
    lights = make_lights(rows, world_center=(0, 1, 0), world_radius=15.0)

    ms = MaterialSet()
    const = {"kd_floor": jnp.asarray([0.55, 0.55, 0.58], jnp.float32),
             "kd_hero": jnp.asarray([0.6, 0.42, 0.3], jnp.float32),
             "kd_black": jnp.asarray([0.0, 0.0, 0.0], jnp.float32)}
    ms.add(MatteMaterial(kd=ConstantTexture("kd_floor")))
    ms.add(MatteMaterial(kd=ConstantTexture("kd_hero")))
    ms.add(MatteMaterial(kd=ConstantTexture("kd_black")))
    ctx = RenderContext(geom=geom, lights=lights,
                        textures={"const": const, "images": []})
    c2w = Transform.look_at([5.5, 5.0, -6.5], [0.0, 0.4, 0.0], [0, 1, 0])
    cam = PerspectiveCamera.create(c2w, fov=52.0, resolution=res)
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    sampler = SamplerConfig(kind="02sequence", spp=spp)
    from rustracer_tpu.integrators.path import PathIntegrator
    integ = PathIntegrator(mat_set=ms, max_depth=5)
    return ctx, cam, film, sampler, integ


def main():
    subdiv = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    res = (w, w * 3 // 4)
    spp = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    configure_compile_cache()
    require_gpu("tools/gen_instanced_gallery.py")
    card = card_label()
    ctx, cam, film, sampler, integ = build(subdiv, res, spp)
    r = Renderer(integ.li, cam, film, sampler,
                 RenderConfig(max_lanes=1 << 18, collect_stats=False))
    print("compiling ...", flush=True)
    t0 = time.time()
    fs = r.render_state(ctx, sample_stop=1)
    np.asarray(film.to_image(fs))
    print(f"compiled+1spp in {time.time()-t0:.0f}s; rendering {spp} spp",
          flush=True)
    t0 = time.time()
    fs = r.render_state(ctx)
    img = np.asarray(film.to_image(fs))
    dt = time.time() - t0
    rays = res[0] * res[1] * spp
    print(f"{rays/dt/1e3:.1f} krays/s ({dt:.1f}s) on {card}, "
          f"mean {img.mean():.4f}", flush=True)
    assert np.isfinite(img).all() and img.mean() > 1e-3

    from rustracer_tpu.core.spectrum import srgb_encode
    from rustracer_tpu.render.imageio import write_png8
    png = np.asarray(srgb_encode(jnp.asarray(img)))
    out = os.path.join(REPO, "renders", "rt-instanced-5x5.png")
    write_png8(out, (np.clip(png, 0, 1) * 255).astype(np.uint8))
    print("wrote", out, flush=True)


if __name__ == "__main__":
    main()
