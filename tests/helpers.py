"""Shared scene-construction helpers for tests."""
import jax
import numpy as np
import jax.numpy as jnp

from rustracer_tpu.core.transform import Transform
from rustracer_tpu.scene.tables import make_geometry
from rustracer_tpu.scene.lights import make_lights, LIGHT_AREA, LIGHT_POINT

TWO_PI = 2.0 * np.pi


def quad_dict(spheres, materials=None, arealights=None):
    """spheres: list of (center, radius)."""
    n = len(spheres)
    o2ws = [Transform.translate(*c) for c, _ in spheres]
    return dict(
        q_type=np.zeros(n, np.int32),
        q_o2w=np.stack([t.m for t in o2ws]),
        q_w2o=np.stack([t.m_inv for t in o2ws]),
        q_params=np.array([[r, -r, r, TWO_PI] for _, r in spheres], np.float32),
        q_material=np.asarray(materials if materials is not None else [0] * n,
                              np.int32),
        q_arealight=np.asarray(arealights if arealights is not None else [-1] * n,
                               np.int32),
        q_reverse=np.zeros(n, bool),
    )


class TriBuilder:
    def __init__(self):
        self.v = []
        self.uv = []
        self.idx = []
        self.mat = []
        self.al = []

    def add_quad(self, p00, p10, p11, p01, material=0, arealight=-1):
        """Two triangles for the quad p00-p10-p11-p01 (CCW)."""
        base = len(self.v)
        self.v += [p00, p10, p11, p01]
        self.uv += [(0, 0), (1, 0), (1, 1), (0, 1)]
        self.idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
        self.mat += [material, material]
        self.al += [arealight, arealight]
        return len(self.idx) - 2  # first tri index

    def build(self):
        n = len(self.idx)
        v = np.asarray(self.v, np.float32)
        return dict(
            tv_p=v,
            tv_n=np.zeros_like(v),
            tv_uv=np.asarray(self.uv, np.float32),
            tv_s=np.zeros_like(v),
            t_idx=np.asarray(self.idx, np.int32),
            t_material=np.asarray(self.mat, np.int32),
            t_arealight=np.asarray(self.al, np.int32),
            t_reverse=np.zeros(n, bool),
            t_has_n=np.zeros(n, bool),
            t_has_uv=np.ones(n, bool),
            t_alpha_tex=np.full(n, -1, np.int32),
        )


def cornell_box(light_emit=(15.0, 15.0, 15.0)):
    """Classic Cornell box in [0,1]^3, camera looking down +z.

    Returns (geom, lights, material assignment):
      mat 0 = white, 1 = red (left), 2 = green (right), 3 = light's matte
    """
    tb = TriBuilder()
    # area light ids: the 2 ceiling-light triangles are lights 0 and 1
    # floor (y=0)
    tb.add_quad((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1), material=0)
    # ceiling (y=1)
    tb.add_quad((0, 1, 1), (1, 1, 1), (1, 1, 0), (0, 1, 0), material=0)
    # back wall (z=1)
    tb.add_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1), material=0)
    # left wall (x=0) red
    tb.add_quad((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0), material=1)
    # right wall (x=1) green
    tb.add_quad((1, 0, 1), (1, 0, 0), (1, 1, 0), (1, 1, 1), material=2)
    # ceiling light: small quad slightly below ceiling, facing down
    # wound so cross(p0-p2, p1-p2) points down (-y) into the box
    first = tb.add_quad((0.35, 0.999, 0.35), (0.65, 0.999, 0.35),
                        (0.65, 0.999, 0.65), (0.35, 0.999, 0.65),
                        material=3, arealight=-2)  # placeholder
    tris = tb.build()
    # fix arealight ids: tri `first` -> light 0, first+1 -> light 1
    tris["t_arealight"][first] = 0
    tris["t_arealight"][first + 1] = 1
    geom = make_geometry(tris=tris)
    nq = 1  # dummy quadric pad
    rows = [dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=light_emit,
                 prim=nq + first, twosided=False),
            dict(type=LIGHT_AREA, pos=(0, 0, 0), emit=light_emit,
                 prim=nq + first + 1, twosided=False)]
    lights = make_lights(rows, world_center=(0.5, 0.5, 0.5), world_radius=1.0,
                         geom=geom)
    return geom, lights


def cornell_camera(res=(64, 64)):
    from rustracer_tpu.render.camera import PerspectiveCamera
    c2w = Transform.look_at([0.5, 0.5, -1.4], [0.5, 0.5, 0.5], [0, 1, 0])
    return PerspectiveCamera.create(c2w, fov=40.0, resolution=res)


def cornell_imagemap_materials(seed_base=10, imagemap_walls=(1, 2)):
    """Cornell material set + textures dict with the given wall material
    ids served as ATLAS imagemaps (8x8 noisy pyramids) and the rest as
    constant mattes. Shared by the shard_map parity tests and the
    multichip gate so both exercise the identical atlas construction.
    Returns (material_set, textures_dict)."""
    from rustracer_tpu.ops.mipmap import build_pyramid
    from rustracer_tpu.scene.atlas import build_atlas_meta
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture, ImageTexture

    ms = MaterialSet()
    const = {}
    images = []
    for i, a in enumerate([[0.73] * 3, [0.63, 0.065, 0.05],
                           [0.14, 0.45, 0.09], [0.0] * 3]):
        const[f"kd{i}"] = jnp.asarray(a, jnp.float32)
        if i in imagemap_walls:
            rng = np.random.RandomState(seed_base + i)
            img = (np.asarray(a, np.float32)[None, None]
                   * (0.6 + 0.4 * rng.rand(8, 8, 3))).astype(np.float32)
            images.append([jnp.asarray(lv) for lv in build_pyramid(img)])
            ms.add(MatteMaterial(kd=ImageTexture(len(images) - 1)))
        else:
            ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
    textures = {"const": const, "images": images}
    am = build_atlas_meta(images)
    textures["atlas_meta"] = am["atlas_meta"]
    textures["atlas_levels"] = am["atlas_levels"]
    return ms, textures


def golden_error(img, ref):
    """The golden-image measure: mean and 99th percentile of |img - ref|,
    each over the reference's mean (floored at 1e-3)."""
    err = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    scale = max(float(np.mean(ref)), 1e-3)
    return float(err.mean()) / scale, float(np.percentile(err, 99)) / scale


def shared_edge_miss_rate(n=4096, seed=77):
    """Watertight property (mesh.rs:214-260): rays aimed exactly AT points
    on an edge shared by two triangles must hit at least one of them.
    Returns (miss rate over the rays whose two triangles cover both sides
    of the edge as seen along the ray, number of such rays)."""
    from rustracer_tpu.ops.triangle import triangle_intersect

    rng = np.random.default_rng(seed)
    # two triangles sharing edge (a, b), c1 strictly on the OPPOSITE side
    # of the edge line (point reflection through the edge midpoint, plus an
    # out-of-plane offset so the pair is non-coplanar like a real mesh fold)
    a = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    b = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    c0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    nrm = np.cross(b - a, c0 - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    c1 = (a + b - c0 + nrm * rng.uniform(-0.5, 0.5, (n, 1))).astype(np.float32)
    # ray origin off-plane; target point ON the shared edge, away from the
    # endpoints (endpoint-grazing rays can leave BOTH triangles' far edges)
    o = rng.uniform(4, 6, (n, 3)).astype(np.float32) * \
        np.sign(rng.normal(size=(n, 3))).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    target = a * t + b * (1 - t)           # f32 point on the edge (rounded)
    d = (target - o)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)

    # consistent mesh winding: the shared edge is traversed (a,b) in tri0
    # and (b,a) in tri1, so the shared-edge function negates EXACTLY and
    # one side's same-sign test must accept. Jitted, so the test runs as
    # the compiler fuses it (contracting products into FMAs where it may).
    @jax.jit
    def hit_either(o, d, tmax, a, b, c0, c1):
        return (triangle_intersect(o, d, tmax, a, b, c0).hit
                | triangle_intersect(o, d, tmax, b, a, c1).hit)

    hit_any = np.asarray(hit_either(o, d, tmax, a, b, c0, c1))

    # A miss is only a CRACK when the two triangles actually cover both
    # sides of the edge as seen along the ray — rays grazing a fold
    # silhouette (projected c0/c1 on the SAME side) legitimately miss.
    # Classify in f64 shear space, excluding borderline projections.
    kz = np.argmax(np.abs(d), axis=-1)
    kx, ky = (kz + 1) % 3, (kz + 2) % 3
    ar = np.arange(n)

    def proj(p):
        q = (p - o).astype(np.float64)
        qx, qy, qz = q[ar, kx], q[ar, ky], q[ar, kz]
        dx_, dy_, dz_ = (d.astype(np.float64)[ar, kx],
                         d.astype(np.float64)[ar, ky],
                         d.astype(np.float64)[ar, kz])
        return qx - dx_ / dz_ * qz, qy - dy_ / dz_ * qz

    ax_, ay_ = proj(a)
    bx_, by_ = proj(b)

    def side(p):
        px_, py_ = proj(p)
        return (bx_ - ax_) * (py_ - ay_) - (by_ - ay_) * (px_ - ax_)

    s0, s1 = side(c0), side(c1)
    covered = (s0 * s1 < 0) & (np.abs(s0) > 1e-7) & (np.abs(s1) > 1e-7)
    return 1.0 - float(hit_any[covered].mean()), int(covered.sum())


def frame_lanes(film, n_data):
    """Every pixel of the film's sample bounds as (px, py, valid) lanes,
    padded to a multiple of n_data."""
    x0, y0, x1, y1 = film.get_sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.int32),
                         np.arange(y0, y1, dtype=np.int32))
    px, py = gx.ravel(), gy.ravel()
    pad = (-px.size) % n_data
    valid = np.concatenate([np.ones(px.size, bool), np.zeros(pad, bool)])
    px = np.concatenate([px, np.full(pad, x0, np.int32)])
    py = np.concatenate([py, np.full(pad, y0, np.int32)])
    return jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid)


def single_device_train_loss(ctx, cam, film, sampler, integ, px, py, valid,
                             n_sample):
    """One-device twin of make_sharded_train_step's loss over the SAME lanes
    and sample ids: loss(float textures, target). Differentiate only the
    float leaves (atlas_meta/levels are int32); returns (loss_fn, float
    textures)."""
    from rustracer_tpu.render.film import FilmState
    from rustracer_tpu.render.renderer import Lanes, scrub_radiance
    from rustracer_tpu.render.sampler import DimAllocator

    aux = {k: v for k, v in ctx.textures.items()
           if k in ("atlas_meta", "atlas_levels")}
    tex_f = {k: v for k, v in ctx.textures.items() if k not in aux}

    def loss(textures, target):
        c = ctx._replace(textures={**textures, **aux})
        fs = film.init_state()
        xr, _ = film.full_resolution
        for s in range(n_sample):
            pixel_idx = (py.astype(jnp.uint32) * jnp.uint32(xr)
                         + px.astype(jnp.uint32))
            lanes = Lanes(pixel_idx=pixel_idx,
                          sample_idx=jnp.full(pixel_idx.shape, s, jnp.uint32))
            pixel_xy = jnp.stack([px, py], -1).astype(jnp.float32)
            p_film, p_lens, _ = sampler.get_camera_sample(
                pixel_xy, lanes.pixel_idx, lanes.sample_idx)
            ray = cam.generate_ray_differential(p_film, p_lens)
            ray = ray.scaled_differentials(1.0 / np.sqrt(max(1, sampler.spp)))
            dims = DimAllocator()
            L = scrub_radiance(integ.li(c, ray, lanes, sampler, dims))
            fs = film.add_samples(fs, p_film, L, valid=valid)
        img = film.to_image(FilmState(fs.rgb, fs.wsum,
                                      jnp.zeros_like(fs.rgb)))
        return jnp.mean((img - target) ** 2)

    return loss, tex_f
