"""Headline benchmarks on one GPU. Prints ONE JSON line per finished config.

Headline metric (BASELINE.md config 4): dragon-class mesh — 327k-triangle
procedural scan stand-in (utils/meshgen.py; no network for the real dragon
PLY), path integrator with NEE+MIS, 1024x1024 @ 64spp, max_depth 5. Value is
*camera rays per second* (W*H*spp / wall_s, steady-state, post-compile) — the
quantity the reference prints per run ("Camera rays traced",
rustracer-core/src/renderer.rs:17).

"extra" carries the secondary metrics:
  - cornell_fwd_rays_per_s        (config 2: 256x256 @ 16spp path)
  - cornell_fwdbwd_rays_per_s     (config 2 forward+backward: value_and_grad
                                   of an image loss w.r.t. material textures)
and the device the numbers come from: JAX's platform, kind and count, and the
card's name and power limit as nvidia-smi reports them.

The run refuses any backend but a GPU, and exits non-zero when a config
raised. The reference publishes no numbers (BASELINE.md); the baseline
divisor is the self-defined 1.0 Mray/s figure recorded in BASELINE.md for a
single-CPU PBRT-class tracer, so vs_baseline = value / 1e6.
"""
import json
import os
import sys
import tempfile
import time
import traceback


def log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

BASELINE_RAYS_PER_S = 1.0e6

CORNELL_RES = (256, 256)
CORNELL_SPP = 16
DRAGON_RES = (1024, 1024)
DRAGON_SPP = 64
MAX_DEPTH = 5
# BVH tables of the procedural meshes, keyed on mesh content and builder
# source (git-ignored, inside the checkout)
BVH_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bvh_cache")


def build_cornell():
    import jax.numpy as jnp
    from helpers import cornell_box, cornell_camera
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture
    from rustracer_tpu.integrators.path import PathIntegrator

    geom, lights = cornell_box()
    ms = MaterialSet()
    const = {}
    for i, a in enumerate([[0.73] * 3, [0.63, 0.065, 0.05],
                           [0.14, 0.45, 0.09], [0.0] * 3]):
        const[f"kd{i}"] = jnp.asarray(a, jnp.float32)
        ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
    ctx = RenderContext(geom=geom, lights=lights,
                        textures={"const": const, "images": []})
    cam = cornell_camera(CORNELL_RES)
    film = Film(full_resolution=CORNELL_RES, filter=Filter("box", 0.5, 0.5))
    sampler = SamplerConfig(kind="02sequence", spp=CORNELL_SPP)
    integ = PathIntegrator(mat_set=ms, max_depth=MAX_DEPTH)
    return ctx, cam, film, sampler, integ


def build_dragon(sub=7, res=None, spp=None, ply_roundtrip=True):
    """Config 4 stand-in: 327k-tri bumpy sphere (sub=8 → 1.31M tris) on a
    ground plane under an area light (the real dragon/ganesha PLYs are not
    fetchable offline). The hero mesh carries an IMAGEMAP material through
    the shared atlas so the headline number includes per-bounce EWA
    texture filtering, like a real scanned-asset scene would."""
    import numpy as np
    import jax.numpy as jnp
    from rustracer_tpu.utils.meshgen import bumpy_sphere
    from rustracer_tpu.accel.bvh import build_bvh_arrays
    from rustracer_tpu.core.transform import Transform
    from rustracer_tpu.render.camera import PerspectiveCamera
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.lights import make_lights, LIGHT_AREA
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture, ImageTexture
    from rustracer_tpu.integrators.path import PathIntegrator

    res = DRAGON_RES if res is None else res
    spp = DRAGON_SPP if spp is None else spp
    mv, mn, mf = bumpy_sphere(subdivisions=sub, radius=1.0)
    if ply_roundtrip:
        # roundtrip through the PLY exporter/loader so the loader is
        # exercised at benchmark scale (real dragon PLYs not fetchable)
        from rustracer_tpu.utils.plyio import read_ply, write_ply
        with tempfile.TemporaryDirectory() as tmp:
            ply_path = os.path.join(tmp, "dragon.ply")
            write_ply(ply_path, mv, mf, n=mn)
            t0 = time.perf_counter()
            mv, mn, _, mf = read_ply(ply_path)
        log(f"PLY load: {mf.shape[0]} tris in {time.perf_counter()-t0:.2f}s")
    n_mesh = mf.shape[0]

    # ground quad + light quad (2 tris each), appended after the mesh
    extra_v = np.array([
        [-12, -1.25, -12], [12, -1.25, -12], [12, -1.25, 12], [-12, -1.25, 12],
        # light: 2x2 quad at y=3.0 facing down (wound so ng points -y)
        [-1, 3.0, -1], [1, 3.0, -1], [1, 3.0, 1], [-1, 3.0, 1],
    ], np.float32)
    base = mv.shape[0]
    extra_f = np.array([
        [base, base + 1, base + 2], [base, base + 2, base + 3],       # ground
        [base + 4, base + 5, base + 6], [base + 4, base + 6, base + 7],  # light
    ], np.int32)

    tv_p = np.concatenate([mv, extra_v])
    tv_n = np.concatenate([mn, np.zeros((8, 3), np.float32)])
    # spherical uv on the hero mesh (the seam stretch is irrelevant for a
    # throughput bench; it feeds the atlas-EWA lookup with real gradients)
    uv_mesh = np.stack(
        [np.arctan2(mv[:, 2], mv[:, 0]) / (2 * np.pi) + 0.5,
         np.arccos(np.clip(mv[:, 1] /
                           np.maximum(np.linalg.norm(mv, axis=1), 1e-9),
                           -1, 1)) / np.pi], -1).astype(np.float32)
    tv_uv = np.concatenate([uv_mesh, np.zeros((8, 2), np.float32)])
    tv_s = np.zeros_like(tv_p)
    t_idx = np.concatenate([mf, extra_f])
    n_tris = t_idx.shape[0]
    t_material = np.concatenate([
        np.full(n_mesh, 1, np.int32), np.array([0, 0, 2, 2], np.int32)])
    t_arealight = np.concatenate([
        np.full(n_mesh + 2, -1, np.int32), np.array([0, 1], np.int32)])
    tris = dict(
        tv_p=tv_p, tv_n=tv_n, tv_uv=tv_uv, tv_s=tv_s, t_idx=t_idx,
        t_material=t_material, t_arealight=t_arealight,
        t_reverse=np.zeros(n_tris, bool),
        t_has_n=np.concatenate([np.ones(n_mesh, bool), np.zeros(4, bool)]),
        t_has_uv=np.concatenate([np.ones(n_mesh, bool), np.zeros(4, bool)]),
        t_alpha_tex=np.full(n_tris, -1, np.int32),
    )
    from rustracer_tpu.scene.tables import make_geometry
    # BVH file cache: the SAH build of the 1.31M mesh is a large share of
    # the bench's set-up, and the scene is deterministic per subdiv level —
    # keyed on a content fingerprint so any mesh change invalidates it.
    import hashlib
    import rustracer_tpu.accel.bvh as _bvhmod
    # the key includes the BUILDER source hash: a stale cache from an older
    # build_bvh_arrays (changed packing/split logic) must never be reused
    with open(_bvhmod.__file__, "rb") as f:
        ver = hashlib.sha1(f.read()).hexdigest()[:8]
    fp = hashlib.sha1(np.ascontiguousarray(tv_p[::257]).tobytes()
                      + t_idx[::257].tobytes()).hexdigest()[:16]
    cache = os.path.join(BVH_CACHE_DIR, f"bvh_{sub}_{n_tris}_{fp}_{ver}.npz")
    bvh = None
    if os.path.exists(cache):
        try:
            with np.load(cache) as z:
                bvh = {k: z[k] for k in z.files}
            log(f"BVH cache hit: {cache}")
        except Exception as e:
            log(f"BVH cache read failed ({e!r}); rebuilding")
            bvh = None
    if bvh is None:
        t0 = time.perf_counter()
        bvh = build_bvh_arrays(None, tris)
        log(f"BVH built in {time.perf_counter()-t0:.1f}s")
        try:
            os.makedirs(BVH_CACHE_DIR, exist_ok=True)
            np.savez(cache, **bvh)
        except Exception as e:
            log(f"BVH cache write failed ({e!r})")
    geom = make_geometry(tris=tris, bvh=bvh)

    nq = 1  # dummy quadric pad
    emit = (18.0, 18.0, 18.0)
    rows = [dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=emit,
                 prim=nq + n_mesh + 2, twosided=False),
            dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=emit,
                 prim=nq + n_mesh + 3, twosided=False)]
    lights = make_lights(rows, world_center=(0, 0.5, 0), world_radius=20.0,
                         geom=geom)

    ms = MaterialSet()
    const = {"kd_floor": jnp.asarray([0.6, 0.6, 0.6], jnp.float32),
             "kd_black": jnp.asarray([0.0, 0.0, 0.0], jnp.float32)}
    # hero texture: 128^2 marbled albedo, mip pyramid, served via atlas
    from rustracer_tpu.ops.mipmap import build_pyramid
    from rustracer_tpu.scene.atlas import build_atlas_meta
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 128.0
    tex = np.stack([0.45 + 0.25 * np.sin(14 * xx + 5 * np.sin(3 * yy)),
                    0.40 + 0.15 * np.sin(11 * yy + 4 * np.sin(5 * xx)),
                    0.32 + 0.10 * np.cos(9 * (xx + yy))], -1)
    images = [[jnp.asarray(lv) for lv in
               build_pyramid(tex.astype(np.float32))]]
    am = build_atlas_meta(images)
    ms.add(MatteMaterial(kd=ConstantTexture("kd_floor")))
    ms.add(MatteMaterial(kd=ImageTexture(0)))        # textured dragon
    ms.add(MatteMaterial(kd=ConstantTexture("kd_black")))
    ctx = RenderContext(geom=geom, lights=lights,
                        textures={"const": const, "images": images,
                                  "atlas_meta": am["atlas_meta"],
                                  "atlas_levels": am["atlas_levels"]})
    c2w = Transform.look_at([0.0, 1.1, -3.4], [0.0, 0.0, 0.0], [0, 1, 0])
    cam = PerspectiveCamera.create(c2w, fov=42.0, resolution=res)
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    sampler = SamplerConfig(kind="02sequence", spp=spp)
    integ = PathIntegrator(mat_set=ms, max_depth=MAX_DEPTH)
    return ctx, cam, film, sampler, integ, n_tris


def write_bathroom_scene(path, res=(1920, 1080)):
    """Write scenes/bathroom.pbrt to `path` at resolution `res`, with its
    texture paths made absolute so the copy parses from anywhere."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "scenes", "bathroom.pbrt")) as f:
        src = f.read()
    src = src.replace('"integer xresolution" [320]',
                      f'"integer xresolution" [{res[0]}]')
    src = src.replace('"integer yresolution" [180]',
                      f'"integer yresolution" [{res[1]}]')
    src = src.replace('["textures/', f'["{repo}/scenes/textures/')
    with open(path, "w") as f:
        f.write(src)


def build_bathroom(res=(1920, 1080)):
    """BASELINE config 5: the bathroom interior (scenes/bathroom.pbrt —
    18 imagemap materials through the shared atlas, window + lamps +
    infinite sky, DoF, spatial light grid) re-driven at 1080p through the
    full parser."""
    from rustracer_tpu.scene.api import parse_scene
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bathroom.pbrt")
        write_bathroom_scene(path, res)
        api = parse_scene(path)
    sc = api.scene
    return sc.context(), sc.camera, sc.film, sc.sampler, sc.integrator


def bench_forward(ctx, cam, film, sampler, integ, res, spp, n_runs,
                  max_lanes=1 << 16, spp_measure=None):
    """Steady-state camera rays/s. When spp_measure < spp, time an
    spp_measure-sample slice after warmup (identical per-sample work; the
    full-spp render is just more of the same steps)."""
    import numpy as np
    from rustracer_tpu.render.renderer import Renderer, RenderConfig

    spp_measure = spp if spp_measure is None else min(spp_measure, spp)
    cfg = RenderConfig(max_lanes=max_lanes, collect_stats=False)
    r = Renderer(integ.li, cam, film, sampler, cfg)
    # warmup / compile (1 spp over all tiles)
    log(f"forward {res}@{spp}: compiling ...")
    fs = r.render_state(ctx, sample_stop=1)
    np.asarray(film.to_image(fs))
    log(f"forward {res}@{spp}: compiled; timing {n_runs} runs "
        f"of {spp_measure} spp")
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        fs = r.render_state(ctx, sample_stop=spp_measure)
        img = film.to_image(fs)
        np.asarray(img)  # block
        times.append(time.perf_counter() - t0)
    best = min(times)
    img = np.asarray(img)
    assert np.isfinite(img).all(), "non-finite radiance in bench"
    # a black render means the scene is broken (round-4 lesson: a light
    # quad wound the wrong way emitted away from the scene for 3 rounds)
    assert img.mean() > 1e-4, f"bench render is black (mean {img.mean()})"
    return res[0] * res[1] * spp_measure / best


def make_cornell_fwdbwd(ctx, cam, film, sampler, integ, remat=False,
                        compact=False):
    """jit(value_and_grad) of a full-frame image loss w.r.t. the material
    textures (BASELINE.json fwd+bwd metric) → (vg, camera rays per call).

    loss(textures) = mean(image**2) over a min(4, spp)-sample image at the
    film's full resolution.
    remat: jax.checkpoint around each sample's radiance (recompute the
    bounce forward during backward instead of storing residuals).
    compact: leave the integrator's inter-bounce compaction on. Off by
    default: it never triggers on a closed box, so its argsort/cond is dead
    weight there (its custom_vjp exists for open differentiable scenes and
    is grad-parity-tested). Neither default has been measured on H100."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    if getattr(integ, "compact_interior", False) and not compact:
        integ = dataclasses.replace(integ, compact_interior=False)
    from rustracer_tpu.render.renderer import Lanes, scrub_radiance
    from rustracer_tpu.render.sampler import DimAllocator

    xr, yr = film.full_resolution
    xs, ys = np.meshgrid(np.arange(xr, dtype=np.int32),
                         np.arange(yr, dtype=np.int32))
    px = jnp.asarray(xs.ravel())
    py = jnp.asarray(ys.ravel())
    pixel_idx = (py.astype(jnp.uint32) * jnp.uint32(xr)
                 + px.astype(jnp.uint32))
    pixel_xy = jnp.stack([px, py], axis=-1).astype(jnp.float32)

    spp_bwd = min(4, sampler.spp)  # fwd+bwd metric uses a 4-spp loss

    def sample_radiance(textures, s):
        c = ctx._replace(textures=textures)
        lanes = Lanes(pixel_idx=pixel_idx,
                      sample_idx=jnp.broadcast_to(s, pixel_idx.shape)
                      .astype(jnp.uint32))
        p_film, p_lens, _ = sampler.get_camera_sample(
            pixel_xy, lanes.pixel_idx, lanes.sample_idx)
        ray = cam.generate_ray_differential(p_film, p_lens)
        dims = DimAllocator()
        return scrub_radiance(integ.li(c, ray, lanes, sampler, dims))

    if remat:
        sample_radiance = jax.checkpoint(sample_radiance)

    def loss_fn(textures):
        def body(acc, s):
            return acc + sample_radiance(textures, s), None
        total, _ = jax.lax.scan(body, jnp.zeros(pixel_idx.shape + (3,)),
                                jnp.arange(spp_bwd, dtype=jnp.uint32))
        mean_img = total / spp_bwd
        return jnp.mean(mean_img ** 2)

    return jax.jit(jax.value_and_grad(loss_fn)), xr * yr * spp_bwd


def bench_cornell_fwdbwd(ctx, cam, film, sampler, integ, n_runs=3,
                         remat=False, compact=False):
    """Forward+backward rays/s of make_cornell_fwdbwd's step."""
    import jax
    import numpy as np

    vg, n_rays = make_cornell_fwdbwd(ctx, cam, film, sampler, integ,
                                     remat=remat, compact=compact)
    log("fwd+bwd: compiling value_and_grad ...")
    loss, grads = vg(ctx.textures)   # compile + warmup
    jax.block_until_ready(grads)
    assert np.isfinite(float(loss))
    log("fwd+bwd: compiled; timing")
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        loss, grads = vg(ctx.textures)
        jax.block_until_ready(grads)
        times.append(time.perf_counter() - t0)
    return n_rays / min(times)


def main():
    """Run the headline config FIRST and flush a complete JSON line after
    EVERY config — a timeout mid-way still leaves the best-so-far line on
    stdout (round-2 lesson: one slow compile must not zero out all
    metrics). Remaining configs are skipped once the soft wall budget is
    spent. Exits non-zero if any config raised."""
    from rustracer_tpu.utils.device import (card_label,
                                            configure_compile_cache,
                                            require_gpu)
    configure_compile_cache()
    device = require_gpu("bench.py")
    card = card_label()
    log(f"device: {device}; card: {card}")

    t_start = time.time()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 540))
    results = {"device": device, "card": card}
    failed = []

    def fail(config):
        log(f"{config} config failed:\n{traceback.format_exc()}")
        failed.append(config)

    def emit():
        dragon = results.get("dragon_fwd_rays_per_s")
        extra = dict(results)
        if dragon is not None:
            metric = "camera_rays_per_s_dragon327k_1024_64spp_path"
            value = dragon
        elif "cornell_fwd_rays_per_s" in results:
            metric = "camera_rays_per_s_cornell_256_16spp_path"
            value = results["cornell_fwd_rays_per_s"]
        else:
            return
        print(json.dumps({
            "metric": metric,
            "value": round(value, 1),
            "unit": "rays/s",
            "vs_baseline": round(value / BASELINE_RAYS_PER_S, 3),
            "extra": extra,
        }), flush=True)

    def left():
        return budget_s - (time.time() - t_start)

    # config 4 FIRST (the headline): dragon-class mesh stress
    try:
        log("building dragon scene (mesh gen + SAH BVH + threading) ...")
        ctx, cam, film, sampler, integ, n_tris = build_dragon()
        log(f"dragon scene built: {n_tris} tris ({left():.0f}s left)")
        results["dragon_tris"] = int(n_tris)
        results["dragon_fwd_rays_per_s"] = round(bench_forward(
            ctx, cam, film, sampler, integ, DRAGON_RES, DRAGON_SPP,
            n_runs=2, max_lanes=1 << 18, spp_measure=8), 1)
        emit()
    except Exception:  # keep the remaining configs alive
        fail("dragon")

    dragon_cfg = None
    if "dragon_fwd_rays_per_s" in results:
        dragon_cfg = (ctx, cam, film, sampler, integ)

    # config 2: Cornell forward
    ctx = None
    if left() > 60:
        try:
            log(f"building cornell scene ... ({left():.0f}s left)")
            ctx, cam, film, sampler, integ = build_cornell()
            results["cornell_fwd_rays_per_s"] = round(bench_forward(
                ctx, cam, film, sampler, integ, CORNELL_RES, CORNELL_SPP,
                n_runs=5), 1)
            emit()
        except Exception:
            fail("cornell fwd")
            ctx = None
    else:
        log("skipping cornell fwd: budget spent")

    # config 2 forward+backward
    if ctx is not None and left() > 60:
        try:
            log(f"cornell fwd+bwd ... ({left():.0f}s left)")
            results["cornell_fwdbwd_rays_per_s"] = round(
                bench_cornell_fwdbwd(ctx, cam, film, sampler, integ), 1)
            emit()
        except Exception:
            fail("cornell fwd+bwd")
    else:
        log("skipping cornell fwd+bwd: budget spent or fwd failed")

    # config 5: bathroom-class interior at 1080p (18 imagemap materials
    # through the shared atlas + mirror/glass/metal + infinite + DoF)
    if left() > 90:
        try:
            log(f"building bathroom 1080p scene ... ({left():.0f}s left)")
            bctx, bcam, bfilm, bsamp, binteg = build_bathroom()
            # 2 runs x a 4-spp slice
            results["bathroom1080_fwd_rays_per_s"] = round(bench_forward(
                bctx, bcam, bfilm, bsamp, binteg, (1920, 1080), bsamp.spp,
                n_runs=2, max_lanes=1 << 18, spp_measure=4), 1)
            emit()
        except Exception:
            fail("bathroom")
    else:
        log("skipping bathroom 1080p: budget spent")

    # scale proof: 1.31M-tri hero mesh (subdiv 8), same scene structure,
    # 512^2 @ 4spp measured slice. Runs last so a tight budget skips it
    # rather than the headline configs.
    if left() > 60:
        try:
            log(f"building dragon-1M scene (subdiv 8) ... ({left():.0f}s left)")
            d = build_dragon(sub=8, res=(512, 512), spp=8,
                             ply_roundtrip=False)
            ctx1m, cam1m, film1m, samp1m, integ1m, n_tris1m = d
            log(f"dragon-1M built: {n_tris1m} tris ({left():.0f}s left)")
            results["dragon1m_tris"] = int(n_tris1m)
            results["dragon1m_fwd_rays_per_s"] = round(bench_forward(
                ctx1m, cam1m, film1m, samp1m, integ1m, (512, 512), 8,
                n_runs=2, max_lanes=1 << 18, spp_measure=4), 1)
            emit()
        except Exception:
            fail("dragon-1M")
    else:
        log("skipping dragon-1M: budget spent")

    # the SAME dragon geometry with a constant-matte hero material (no
    # atlas/EWA), so the textured-vs-matte delta is measurable
    if dragon_cfg is None:
        log("skipping dragon matte variant: dragon config did not run")
    elif left() > 60:
        try:
            import dataclasses as _dc
            import jax.numpy as jnp
            from rustracer_tpu.scene.materials import (MaterialSet,
                                                       MatteMaterial)
            from rustracer_tpu.scene.textures import ConstantTexture
            dctx, dcam, dfilm, dsamp, dinteg = dragon_cfg
            ms2 = MaterialSet()
            ms2.add(MatteMaterial(kd=ConstantTexture("kd_floor")))
            ms2.add(MatteMaterial(kd=ConstantTexture("kd_dragon")))
            ms2.add(MatteMaterial(kd=ConstantTexture("kd_black")))
            const2 = dict(dctx.textures["const"])
            const2["kd_dragon"] = jnp.asarray([0.55, 0.45, 0.35], jnp.float32)
            ctx2 = dctx._replace(textures={"const": const2, "images": []})
            integ2 = _dc.replace(dinteg, mat_set=ms2)
            log(f"dragon matte variant ... ({left():.0f}s left)")
            results["dragon_matte_fwd_rays_per_s"] = round(bench_forward(
                ctx2, dcam, dfilm, dsamp, integ2, DRAGON_RES, DRAGON_SPP,
                n_runs=2, max_lanes=1 << 18, spp_measure=8), 1)
            emit()
        except Exception:
            fail("dragon matte")
    else:
        log("skipping dragon matte variant: budget spent")

    results["wall_s"] = round(time.time() - t_start, 1)
    emit()
    if failed:
        log(f"failed configs: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
