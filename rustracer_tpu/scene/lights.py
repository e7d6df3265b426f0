"""Light tables and batched light sampling (NEE side of MIS).

Reference: rustracer-core/src/light/{mod,point,distant,diffuse,infinite}.rs.
All lights live in one SoA table; sample_li / pdf_li evaluate every present
light *type* masked (type codes are data, the set of present types is
static). Area lights reference a primitive in the geometry tables; the
infinite light carries an equal-area env map + 2D CDF tables.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..core.math import (INFINITY, PI, absdot, cross, dot, distance_squared,
                         normalize, spherical_phi, spherical_theta)
from ..core.sampling import (Distribution1D, Distribution2D,
                             concentric_sample_disk, uniform_sample_sphere)
from ..core.transform import xform_point, xform_vector
from ..ops.quadrics import CYLINDER, DISK, SPHERE, quadric_area
from ..ops.triangle import triangle_area, triangle_sample
from ..ops.mipmap import bilerp_level, WRAP_REPEAT

LIGHT_POINT, LIGHT_DISTANT, LIGHT_AREA, LIGHT_INFINITE = 0, 1, 2, 3


class LightTables(NamedTuple):
    l_type: jnp.ndarray       # (L,) int32 (-1 = dummy)
    l_pos: jnp.ndarray        # (L, 3) point: position; distant: w_light
    l_emit: jnp.ndarray       # (L, 3) I / L / emitted radiance / inf scale
    l_prim: jnp.ndarray       # (L,) int32 global prim id (area lights)
    l_twosided: jnp.ndarray   # (L,) bool
    world_center: jnp.ndarray  # (3,)
    world_radius: jnp.ndarray  # ()
    # infinite lights — the reference caches a VECTOR of them
    # (scene.rs:28-49); maps may differ in resolution so they travel as a
    # tuple (static pytree structure), parallel to inf_rows.
    inf_maps: tuple           # K x (H, W, 3)
    inf_l2w: jnp.ndarray      # (K, 4, 4)
    inf_w2l: jnp.ndarray      # (K, 4, 4)
    inf_dists: tuple          # K x Distribution2D
    inf_rows: jnp.ndarray     # (K,) int32 row index in the light table
    # rows of NON-delta lights (area/infinite); empty shape is a STATIC
    # signal that the BSDF-sampling side of MIS can be skipped entirely
    # (estimate_direct traces no ray when every light is a delta light)
    l_nondelta_rows: jnp.ndarray  # (A,) int32
    # per-light precompute (make_lights(geom=...)): area-light prim areas
    # and triangle vertices, so per-lane NEE never gathers the big mesh
    # tables (indexing these small (L,...) tables instead is cheap). pre_flag is a
    # shape-(1,) static signal; without geom the runtime fallback gathers
    # the mesh tables as before.
    l_area: jnp.ndarray       # (L,) f32 prim area (0 for non-area rows)
    l_tri_p: jnp.ndarray      # (L, 3, 3) f32 tri vertices (world space)
    l_tri_rev: jnp.ndarray    # (L,) bool tri reverse_orientation
    pre_flag: jnp.ndarray     # shape (1,) when the precompute is present

    @property
    def n_lights(self):
        return self.l_type.shape[0]

    @property
    def has_pre(self):
        return self.pre_flag.shape[0] > 0

    @property
    def all_delta(self):
        return self.l_nondelta_rows.shape[0] == 0

    @property
    def has_lights(self):
        return True  # table always padded to >= 1; dummy rows emit nothing

    @property
    def has_infinite(self):
        return len(self.inf_maps) > 0

    @property
    def n_infinite(self):
        return len(self.inf_maps)


def make_lights(rows=None, world_center=(0, 0, 0), world_radius=100.0,
                inf_map=None, inf_l2w=None, inf_scale=None,
                infinite=None, geom=None) -> LightTables:
    """Host-side assembly. rows: list of dicts with keys
    (type, pos, emit, prim, twosided). `infinite`: list of dicts
    (map, l2w, scale); the single-light kwargs remain as a convenience.

    geom: optional GeometryTables — when given, area-light prim areas and
    triangle vertices are precomputed into tiny per-light tables so
    sample_li / pdf_li never gather the big mesh tables per lane (see
    LightTables.l_area). Area lights on INSTANCED geometry are not
    supported either way (the reference has no emissive instances; tv_p
    rows for instanced objects are object-space)."""
    rows = list(rows or [])
    infinite = list(infinite or [])
    if inf_map is not None:
        infinite.append(dict(map=inf_map, l2w=inf_l2w,
                             scale=inf_scale if inf_scale is not None
                             else (1, 1, 1)))
    inf_rows = []
    for spec in infinite:
        rows.append(dict(type=LIGHT_INFINITE, pos=(0, 0, 0),
                         emit=spec.get("scale", (1, 1, 1)), prim=-1,
                         twosided=False))
        inf_rows.append(len(rows) - 1)
    if not rows:
        rows = [dict(type=-1, pos=(0, 0, 0), emit=(0, 0, 0), prim=-1,
                     twosided=False)]
    l_type = np.array([r["type"] for r in rows], np.int32)
    l_pos = np.array([r["pos"] for r in rows], np.float32)
    l_emit = np.array([r["emit"] for r in rows], np.float32)
    l_prim = np.array([r.get("prim", -1) for r in rows], np.int32)
    l_two = np.array([r.get("twosided", False) for r in rows], bool)

    inf_maps = []
    inf_dists = []
    l2ws = []
    w2ls = []
    for spec in infinite:
        m = np.asarray(spec["map"], np.float32)
        l2w = spec.get("l2w")
        if l2w is None:
            l2w = np.eye(4, dtype=np.float32)
        l2w = np.asarray(l2w, np.float32)
        w2l = np.linalg.inv(l2w.astype(np.float64)).astype(np.float32)
        # importance image: luminance x sin(theta) (infinite.rs:84-94)
        h = m.shape[0]
        lum = m @ np.array([0.212671, 0.715160, 0.072169], np.float32)
        sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h).astype(np.float32)
        inf_maps.append(jnp.asarray(m))
        inf_dists.append(Distribution2D.create(jnp.asarray(
            lum * sin_theta[:, None])))
        l2ws.append(l2w)
        w2ls.append(w2l)
    K = len(infinite)
    inf_l2w_arr = np.stack(l2ws) if K else np.zeros((0, 4, 4), np.float32)
    inf_w2l_arr = np.stack(w2ls) if K else np.zeros((0, 4, 4), np.float32)

    # per-light precompute from the geometry tables (host-side float32,
    # replicating triangle_area's formula so pdfs match the fallback path)
    L = len(rows)
    l_area = np.zeros(L, np.float32)
    l_tri_p = np.zeros((L, 3, 3), np.float32)
    l_tri_rev = np.zeros(L, bool)
    if geom is not None:
        nq = int(geom.n_quadrics)
        g_tidx = np.asarray(geom.t_idx)
        g_tvp = np.asarray(geom.tv_p, dtype=np.float32)
        g_trev = np.asarray(geom.t_reverse)
        g_qtype = np.asarray(geom.q_type)
        g_qparams = np.asarray(geom.q_params, dtype=np.float32)
        for i, r in enumerate(rows):
            prim = int(l_prim[i])
            if r["type"] != LIGHT_AREA or prim < 0:
                continue
            if prim >= nq:
                tid = prim - nq
                pts = g_tvp[g_tidx[tid]]                       # (3, 3)
                l_tri_p[i] = pts
                l_tri_rev[i] = bool(g_trev[tid])
                c = np.cross(pts[1] - pts[0], pts[2] - pts[0])
                l_area[i] = np.float32(0.5) * np.float32(
                    np.sqrt(np.float32(np.dot(c, c))))
            else:
                l_area[i] = float(quadric_area(
                    jnp.asarray(g_qtype[prim]),
                    jnp.asarray(g_qparams[prim])))

    return LightTables(
        l_type=jnp.asarray(l_type), l_pos=jnp.asarray(l_pos),
        l_emit=jnp.asarray(l_emit), l_prim=jnp.asarray(l_prim),
        l_twosided=jnp.asarray(l_two),
        l_area=jnp.asarray(l_area), l_tri_p=jnp.asarray(l_tri_p),
        l_tri_rev=jnp.asarray(l_tri_rev),
        pre_flag=jnp.zeros(1 if geom is not None else 0, jnp.int32),
        world_center=jnp.asarray(world_center, jnp.float32),
        world_radius=jnp.asarray(world_radius, jnp.float32),
        inf_maps=tuple(inf_maps), inf_l2w=jnp.asarray(inf_l2w_arr),
        inf_w2l=jnp.asarray(inf_w2l_arr), inf_dists=tuple(inf_dists),
        inf_rows=jnp.asarray(np.array(inf_rows, np.int32)),
        l_nondelta_rows=jnp.asarray(np.array(
            [i for i, r in enumerate(rows)
             if r["type"] in (LIGHT_AREA, LIGHT_INFINITE)], np.int32)),
    )


def is_delta_light(l_type):
    return (l_type == LIGHT_POINT) | (l_type == LIGHT_DISTANT)


# ---------------------------------------------------------------------------
# area-light shape sampling over geometry tables
# ---------------------------------------------------------------------------

def _sample_prim(geom, prim, u, tri_pre=None):
    """Uniform-area sample on global primitive `prim` (quadric or triangle).
    Returns (p, ng, p_error, area). Reference shapes/*::sample.

    tri_pre: optional (p0, p1, p2, reverse, area) per-lane triangle data
    from the LightTables precompute — avoids the 5 big-table gathers the
    fallback pays per lane (quadric tables are small either way)."""
    nq = geom.n_quadrics
    is_tri = prim >= nq
    qid = jnp.clip(jnp.where(is_tri, 0, prim), 0, nq - 1)
    tid = jnp.clip(jnp.where(is_tri, prim - nq, 0), 0, geom.n_triangles - 1)

    # triangle
    if tri_pre is None:
        idx = geom.t_idx[tid]
        p0 = geom.tv_p[idx[..., 0]]
        p1 = geom.tv_p[idx[..., 1]]
        p2 = geom.tv_p[idx[..., 2]]
        t_rev = geom.t_reverse[tid]
        t_area = triangle_area(p0, p1, p2)
    else:
        p0, p1, p2, t_rev, t_area = tri_pre
    tp, tn, terr = triangle_sample(u, p0, p1, p2)
    tn = jnp.where(t_rev[..., None], -tn, tn)

    # quadric (object-space sample -> world)
    q_type = geom.q_type[qid]
    q_params = geom.q_params[qid]
    o2w = geom.q_o2w[qid]
    w2o = geom.q_w2o[qid]
    radius = q_params[..., 0]
    # sphere: uniform-area sampling of the z/phi-CLIPPED region via
    # Archimedes (z uniform in [zmin, zmax], phi uniform in [0, phimax] is
    # exactly uniform in area), with the matching clipped area below. The
    # reference samples the FULL sphere with a clipped-area pdf
    # (sphere.rs:227-243 + area()) — inconsistent for partial spheres; this
    # is the corrected estimator (identical for full spheres).
    sp_z = q_params[..., 1] + u[..., 0] * (q_params[..., 2] - q_params[..., 1])
    sp_phi = u[..., 1] * q_params[..., 3]
    sp_sin = jnp.sqrt(jnp.maximum(
        0.0, 1.0 - (sp_z / jnp.maximum(radius, 1e-8)) ** 2))
    sp_n_obj = jnp.stack([sp_sin * jnp.cos(sp_phi),
                          sp_sin * jnp.sin(sp_phi),
                          sp_z / jnp.maximum(radius, 1e-8)], axis=-1)
    sp_obj = radius[..., None] * sp_n_obj
    # disk: params [height, radius, inner_radius, phimax]
    d_xy = concentric_sample_disk(u) * q_params[..., 1, None]
    dk_obj = jnp.concatenate(
        [d_xy, jnp.broadcast_to(q_params[..., 0, None], d_xy[..., :1].shape)], -1)
    dk_n_obj = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), sp_obj.shape)
    # cylinder: z in [z0,z1], phi in [0,phimax]
    z = q_params[..., 1] + u[..., 0] * (q_params[..., 2] - q_params[..., 1])
    phi = u[..., 1] * q_params[..., 3]
    cy_obj = jnp.stack([radius * jnp.cos(phi), radius * jnp.sin(phi), z], -1)
    cy_n_obj = jnp.stack([jnp.cos(phi), jnp.sin(phi), jnp.zeros_like(phi)], -1)

    obj = jnp.where((q_type == SPHERE)[..., None], sp_obj,
                    jnp.where((q_type == CYLINDER)[..., None], cy_obj, dk_obj))
    n_obj = jnp.where((q_type == SPHERE)[..., None], sp_n_obj,
                      jnp.where((q_type == CYLINDER)[..., None], cy_n_obj,
                                dk_n_obj))
    qp = xform_point(o2w, obj)
    from ..core.transform import xform_normal
    qn = normalize(xform_normal(w2o, n_obj))
    qn = jnp.where(geom.q_reverse[qid][..., None], -qn, qn)
    # clipped area matches the clipped-region sampling above
    q_area = quadric_area(q_type, q_params)
    q_err = jnp.abs(qp) * 1e-5 + 1e-6

    p = jnp.where(is_tri[..., None], tp, qp)
    n = jnp.where(is_tri[..., None], tn, qn)
    err = jnp.where(is_tri[..., None], terr, q_err)
    area = jnp.where(is_tri, t_area, q_area)
    return p, n, err, area


class _ConeSample(NamedTuple):
    valid: jnp.ndarray  # (B,) lanes where cone sampling applies
    p: jnp.ndarray      # (B, 3) sample point on the sphere
    n: jnp.ndarray      # (B, 3) outward normal at the sample
    err: jnp.ndarray    # (B, 3)
    pdf: jnp.ndarray    # (B,) solid-angle pdf (uniform over the cone)


def _sphere_cone_geom(geom, prim, ref_p):
    """Shared cone geometry for FULL sphere quadrics seen from outside
    (sphere.rs:245-340): returns (valid, center, radius, dc, dc2,
    cos_theta_max, qid). Clipped spheres and interior points fall back to
    uniform-area sampling. Assumes no scaling in the sphere's o2w (the
    reference makes the same assumption: it mixes the object-space radius
    with the world-space center, sphere.rs:249-252)."""
    nq = geom.n_quadrics
    is_q = prim < nq
    qid = jnp.clip(jnp.where(is_q, prim, 0), 0, nq - 1)
    qp = geom.q_params[qid]
    r = qp[..., 0]
    full = (qp[..., 1] <= -r + 1e-5 * jnp.maximum(r, 1e-8)) & \
        (qp[..., 2] >= r - 1e-5 * jnp.maximum(r, 1e-8)) & \
        (qp[..., 3] >= 2.0 * PI - 1e-4)
    center = geom.q_o2w[qid][..., :3, 3]
    dvec = center - ref_p
    dc2 = jnp.maximum(jnp.sum(dvec * dvec, -1), 1e-20)
    dc = jnp.sqrt(dc2)
    outside = dc2 > r * r
    valid = is_q & (geom.q_type[qid] == SPHERE) & full & outside & (r > 0.0)
    sin2max = jnp.clip(r * r / dc2, 0.0, 1.0)
    cosmax = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2max))
    return valid, center, r, dvec, dc, dc2, cosmax, qid


def cone_pdf_wi(geom, prim, ref_p):
    """Solid-angle pdf of the cone strategy: 1 / (2π(1−cosθmax))
    (sphere.rs:312-340 pdf_wi, sampling/mod.rs uniform_cone_pdf). Returns
    (pdf, valid); valid=False lanes must use the area-based pdf."""
    valid, _, _, _, _, _, cosmax, _ = _sphere_cone_geom(geom, prim, ref_p)
    pdf = 1.0 / jnp.maximum(2.0 * PI * (1.0 - cosmax), 1e-9)
    return jnp.where(valid, pdf, 0.0), valid


def _sphere_cone_sample(geom, prim, ref_p, u) -> _ConeSample:
    """Uniform solid-angle sample of the cone a full sphere subtends from
    an exterior point (sphere.rs:245-310): dramatically lower variance than
    area sampling for small/distant sphere lights — every sample lands on
    the visible cap."""
    valid, center, r, dvec, dc, dc2, cosmax, qid = _sphere_cone_geom(
        geom, prim, ref_p)
    cost = (1.0 - u[..., 0]) + u[..., 0] * cosmax
    sint = jnp.sqrt(jnp.maximum(0.0, 1.0 - cost * cost))
    phi = u[..., 1] * 2.0 * PI
    # distance from ref to the sphere along the sampled cone direction,
    # then the spherical-triangle angle alpha at the sphere center
    ds = dc * cost - jnp.sqrt(jnp.maximum(0.0, r * r - dc2 * sint * sint))
    cosa = (dc2 + r * r - ds * ds) / jnp.maximum(2.0 * dc * r, 1e-12)
    cosa = jnp.clip(cosa, -1.0, 1.0)
    sina = jnp.sqrt(jnp.maximum(0.0, 1.0 - cosa * cosa))
    from ..core.math import coordinate_system
    wc = dvec / dc[..., None]
    wcx, wcy = coordinate_system(wc)
    n_s = (sina * jnp.cos(phi))[..., None] * (-wcx) \
        + (sina * jnp.sin(phi))[..., None] * (-wcy) \
        + cosa[..., None] * (-wc)
    p_s = center + r[..., None] * n_s
    n_out = jnp.where(geom.q_reverse[qid][..., None], -n_s, n_s)
    pdf = 1.0 / jnp.maximum(2.0 * PI * (1.0 - cosmax), 1e-9)
    err = jnp.abs(p_s) * 1e-5 + 1e-6
    return _ConeSample(valid=valid, p=p_s, n=n_out, err=err,
                       pdf=jnp.where(valid, pdf, 0.0))


def prim_area(geom, prim):
    nq = geom.n_quadrics
    is_tri = prim >= nq
    qid = jnp.clip(jnp.where(is_tri, 0, prim), 0, nq - 1)
    tid = jnp.clip(jnp.where(is_tri, prim - nq, 0), 0, geom.n_triangles - 1)
    idx = geom.t_idx[tid]
    t_area = triangle_area(geom.tv_p[idx[..., 0]], geom.tv_p[idx[..., 1]],
                           geom.tv_p[idx[..., 2]])
    q_type = geom.q_type[qid]
    q_params = geom.q_params[qid]
    q_area = quadric_area(q_type, q_params)
    return jnp.where(is_tri, t_area, q_area)


# ---------------------------------------------------------------------------
# sample_li / pdf_li / Le
# ---------------------------------------------------------------------------

class LightSample(NamedTuple):
    wi: jnp.ndarray        # (B, 3)
    li: jnp.ndarray        # (B, 3)
    pdf: jnp.ndarray       # (B,) solid-angle pdf
    p_target: jnp.ndarray  # (B, 3) point for the shadow ray
    n_target: jnp.ndarray  # (B, 3)
    err_target: jnp.ndarray  # (B, 3)
    is_delta: jnp.ndarray  # (B,)
    at_infinity: jnp.ndarray  # (B,) shadow ray is a direction probe


def _inf_uv_to_dir(lt, k, uv):
    theta = uv[..., 1] * PI
    phi = uv[..., 0] * 2.0 * PI
    st, ct = jnp.sin(theta), jnp.cos(theta)
    w_l = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    return xform_vector(lt.inf_l2w[k], w_l), st


def _inf_dir_to_uv(lt, k, w):
    w_l = normalize(xform_vector(lt.inf_w2l[k], w))
    theta = spherical_theta(w_l)
    phi = spherical_phi(w_l)
    return jnp.stack([phi / (2.0 * PI), theta / PI], axis=-1), jnp.sin(theta)


def infinite_le(lt: LightTables, d):
    """Radiance for escaped rays: SUM over the scene's infinite lights
    (reference scene.rs:51-63 sums infinite_lights le; infinite.rs le())."""
    out = jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    for k in range(lt.n_infinite):
        uv, _ = _inf_dir_to_uv(lt, k, d)
        scale = lt.l_emit[lt.inf_rows[k]]
        out = out + bilerp_level(lt.inf_maps[k], uv, WRAP_REPEAT) * scale
    return out


def infinite_le_one(lt: LightTables, lid, d):
    """Escaped-ray radiance from ONE infinite light (per-lane row id) —
    the BSDF-sampling side of MIS must only count the light it sampled
    (integrator/mod.rs:300-316 light.le(ray))."""
    out = jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    for k in range(lt.n_infinite):
        uv, _ = _inf_dir_to_uv(lt, k, d)
        le = bilerp_level(lt.inf_maps[k], uv, WRAP_REPEAT) * \
            lt.l_emit[lt.inf_rows[k]]
        out = jnp.where((lid == lt.inf_rows[k])[..., None], le, out)
    return out


def sample_li(lt: LightTables, geom, lid, si, u) -> LightSample:
    """Sample incident direction from light `lid` (per-lane int32) seen from
    si.p. All four light types evaluated masked."""
    ltype = lt.l_type[lid]
    pos = lt.l_pos[lid]
    emit = lt.l_emit[lid]
    p = si.p
    B = si.t.shape

    # point (point.rs:13-71)
    d_pt = pos - p
    dist2_pt = jnp.maximum(jnp.sum(d_pt * d_pt, -1), 1e-12)
    wi_pt = d_pt * jax_rsqrt(dist2_pt)[..., None]
    li_pt = emit / dist2_pt[..., None]

    # distant (distant.rs:15-88): pos holds w_light
    wi_di = pos
    li_di = emit
    p_di = p + wi_di * (2.0 * lt.world_radius)

    # area (diffuse.rs:12-98): uniform-area shape sample; FULL spheres seen
    # from outside use subtended-cone sampling instead (sphere.rs:245-310)
    prim = lt.l_prim[lid]
    tri_pre = None
    if lt.has_pre:
        pts = lt.l_tri_p[lid]                 # (..., 3, 3) tiny-table gather
        tri_pre = (pts[..., 0, :], pts[..., 1, :], pts[..., 2, :],
                   lt.l_tri_rev[lid], lt.l_area[lid])
    p_a, n_a, err_a, area = _sample_prim(geom, prim, u, tri_pre)
    cs = _sphere_cone_sample(geom, prim, p, u)
    p_a = jnp.where(cs.valid[..., None], cs.p, p_a)
    n_a = jnp.where(cs.valid[..., None], cs.n, n_a)
    err_a = jnp.where(cs.valid[..., None], cs.err, err_a)
    d_a = p_a - p
    dist2_a = jnp.maximum(jnp.sum(d_a * d_a, -1), 1e-12)
    wi_a = d_a * jax_rsqrt(dist2_a)[..., None]
    cos_l = dot(n_a, -wi_a)
    two = lt.l_twosided[lid]
    facing = jnp.where(two, jnp.abs(cos_l) > 1e-7, cos_l > 1e-7)
    li_a = jnp.where(facing[..., None], emit, 0.0)
    pdf_a = dist2_a / jnp.maximum(jnp.abs(cos_l) * area, 1e-12)
    pdf_a = jnp.where(cs.valid, cs.pdf, pdf_a)
    pdf_a = jnp.where(facing, pdf_a, 0.0)

    # infinite (infinite.rs:35-220): each infinite light has its own map /
    # CDF / frame; evaluate masked by the sampled row (lid == inf_rows[k])
    if lt.has_infinite:
        wi_inf = wi_pt
        pdf_inf = jnp.zeros(B)
        li_inf = jnp.zeros(B + (3,))
        p_inf = p_di
        for k in range(lt.n_infinite):
            mine = lid == lt.inf_rows[k]
            uv_s, map_pdf = lt.inf_dists[k].sample_continuous(u)
            wi_k, sin_t = _inf_uv_to_dir(lt, k, uv_s)
            pdf_k = map_pdf / jnp.maximum(2.0 * PI * PI * sin_t, 1e-9)
            pdf_k = jnp.where(sin_t > 1e-7, pdf_k, 0.0)
            li_k = bilerp_level(lt.inf_maps[k], uv_s, WRAP_REPEAT) * emit
            wi_inf = jnp.where(mine[..., None], wi_k, wi_inf)
            pdf_inf = jnp.where(mine, pdf_k, pdf_inf)
            li_inf = jnp.where(mine[..., None], li_k, li_inf)
            p_inf = jnp.where(mine[..., None],
                              p + wi_k * (2.0 * lt.world_radius), p_inf)
    else:
        wi_inf = wi_pt
        pdf_inf = jnp.zeros(B)
        li_inf = jnp.zeros(B + (3,))
        p_inf = p_di

    def pick(pt, di, ar, inf):
        def w(c, a, b):
            if a.ndim > len(B):
                c = c[..., None]
            return jnp.where(c, a, b)
        out = w(ltype == LIGHT_POINT, pt, jnp.zeros_like(pt))
        out = w(ltype == LIGHT_DISTANT, di, out)
        out = w(ltype == LIGHT_AREA, ar, out)
        out = w(ltype == LIGHT_INFINITE, inf, out)
        return out

    ones = jnp.ones(B)
    wi = pick(wi_pt, wi_di, wi_a, wi_inf)
    li = pick(li_pt, li_di, li_a, li_inf)
    pdf = pick(ones, ones, pdf_a, pdf_inf)
    p_t = pick(pos, p_di, p_a, p_inf)
    n_t = pick(-wi_pt, -wi_di, n_a, -wi_inf)
    err_t = pick(jnp.zeros(B + (3,)), jnp.zeros(B + (3,)), err_a,
                 jnp.zeros(B + (3,)))
    delta = is_delta_light(ltype)
    at_inf = (ltype == LIGHT_DISTANT) | (ltype == LIGHT_INFINITE)
    # dummy rows (-1) emit nothing
    li = jnp.where((ltype >= 0)[..., None], li, 0.0)
    pdf = jnp.where(ltype >= 0, pdf, 0.0)
    return LightSample(wi=wi, li=li, pdf=pdf, p_target=p_t, n_target=n_t,
                       err_target=err_t, is_delta=delta, at_infinity=at_inf)


def jax_rsqrt(x):
    import jax
    return jax.lax.rsqrt(jnp.maximum(x, 1e-20))


def pdf_li(lt: LightTables, geom, lid, si, wi):
    """Solid-angle pdf of sample_li for direction wi (light/mod.rs pdf_li) —
    used on the BSDF-sampling side of MIS."""
    ltype = lt.l_type[lid]
    B = si.t.shape
    pdf = jnp.zeros(B)

    # area: intersect the light prim with ray (p, wi)
    prim = lt.l_prim[lid]
    nq = geom.n_quadrics
    is_tri = prim >= nq
    qid = jnp.clip(jnp.where(is_tri, 0, prim), 0, nq - 1)
    tid = jnp.clip(jnp.where(is_tri, prim - nq, 0), 0, geom.n_triangles - 1)
    from ..core.ray import Ray
    from ..ops.triangle import triangle_intersect
    from ..ops.quadrics import quadric_intersect
    ray_o = si.p + wi * 1e-4
    t_max = jnp.full(B, INFINITY)
    if lt.has_pre:
        pts = lt.l_tri_p[lid]                 # tiny-table gather
        p0, p1, p2 = pts[..., 0, :], pts[..., 1, :], pts[..., 2, :]
    else:
        idx = geom.t_idx[tid]
        p0 = geom.tv_p[idx[..., 0]]
        p1 = geom.tv_p[idx[..., 1]]
        p2 = geom.tv_p[idx[..., 2]]
    th = triangle_intersect(ray_o, wi, t_max, p0, p1, p2)
    t_ng = normalize(cross(p0 - p2, p1 - p2))
    o_obj = xform_point(geom.q_w2o[qid], ray_o)
    d_obj = xform_vector(geom.q_w2o[qid], wi)
    qh = quadric_intersect(geom.q_type[qid], o_obj, d_obj, t_max,
                           geom.q_params[qid])
    q_n = normalize(xform_vector(geom.q_o2w[qid], jnp.cross(qh.dpdu, qh.dpdv)))
    hit = jnp.where(is_tri, th.hit, qh.hit)
    t_hit = jnp.where(is_tri, th.t, qh.t)
    n_l = jnp.where(is_tri[..., None], t_ng, q_n)
    area = lt.l_area[lid] if lt.has_pre else prim_area(geom, prim)
    p_hit = ray_o + t_hit[..., None] * wi
    dist2 = distance_squared(si.p, p_hit)
    cos_l = absdot(n_l, wi)
    pdf_area_lights = jnp.where(hit & (cos_l > 1e-7),
                                dist2 / jnp.maximum(cos_l * area, 1e-12), 0.0)
    # cone strategy density for full spheres from outside (sphere.rs:312-340
    # returns the uniform-cone pdf without re-intersecting)
    cpdf, cvalid = cone_pdf_wi(geom, prim, si.p)
    pdf_area_lights = jnp.where(cvalid, cpdf, pdf_area_lights)
    pdf = jnp.where(ltype == LIGHT_AREA, pdf_area_lights, pdf)

    for k in range(lt.n_infinite):
        uv, sin_t = _inf_dir_to_uv(lt, k, wi)
        p_inf = lt.inf_dists[k].pdf(uv) / jnp.maximum(
            2.0 * PI * PI * sin_t, 1e-9)
        p_inf = jnp.where(sin_t > 1e-7, p_inf, 0.0)
        pdf = jnp.where(lid == lt.inf_rows[k], p_inf, pdf)
    return pdf


def pdf_li_hit(lt: LightTables, geom, lid, prev_p, d, p_hit, n_hit):
    """Solid-angle pdf that sample_li at `prev_p` would have produced the
    direction toward a KNOWN area-light hit (p_hit, n_hit on light row
    `lid`). Equivalent to pdf_li for area lights, but computed directly
    from the hit the path tracer already has — no re-intersection
    (shapes/*::pdf_wi density, diffuse.rs pdf_li). Must stay consistent
    with sample_li's area strategy."""
    lid_c = jnp.clip(lid, 0, lt.n_lights - 1)
    prim = lt.l_prim[lid_c]
    area = lt.l_area[lid_c] if lt.has_pre else prim_area(geom, prim)
    dist2 = jnp.maximum(distance_squared(prev_p, p_hit), 1e-12)
    cos_l = absdot(n_hit, d)
    pdf = dist2 / jnp.maximum(cos_l * area, 1e-12)
    pdf = jnp.where((lid >= 0) & (cos_l > 1e-7), pdf, 0.0)
    # cone strategy density for full spheres from outside (sphere.rs:312-340)
    cpdf, cvalid = cone_pdf_wi(geom, prim, prev_p)
    return jnp.where((lid >= 0) & cvalid, cpdf, pdf)


def infinite_le_mis(lt: LightTables, d, prev_pdf, prev_spec, pmf_fn):
    """MIS-weighted escape radiance: for each infinite light, weight its le
    by the power heuristic against the light-sampling strategy's density
    for direction d (the merged wavefront formulation — the BSDF-side MIS
    sample IS the path's bounce ray; reference estimate_direct
    integrator/mod.rs:300-316 evaluates the same pairing with a separate
    ray). `pmf_fn(row)` returns the per-lane selection pmf of a light row
    (uniform 1/n or the spatial-grid pmf at the scattering point)."""
    from ..core.sampling import power_heuristic
    out = jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    for k in range(lt.n_infinite):
        uv, sin_t = _inf_dir_to_uv(lt, k, d)
        le = bilerp_level(lt.inf_maps[k], uv, WRAP_REPEAT) * \
            lt.l_emit[lt.inf_rows[k]]
        pdf_k = lt.inf_dists[k].pdf(uv) / jnp.maximum(
            2.0 * PI * PI * sin_t, 1e-9)
        pdf_k = jnp.where(sin_t > 1e-7, pdf_k, 0.0)
        light_pdf = pdf_k * pmf_fn(lt.inf_rows[k])
        w = jnp.where(prev_spec, 1.0,
                      power_heuristic(1.0, prev_pdf, 1.0, light_pdf))
        out = out + w[..., None] * le
    return out


def arealight_le(lt: LightTables, arealight_id, n, w):
    """Emitted radiance from an area light's surface toward w
    (diffuse.rs l())."""
    lid = jnp.clip(arealight_id, 0, lt.n_lights - 1)
    emit = lt.l_emit[lid]
    two = lt.l_twosided[lid]
    ok = (arealight_id >= 0) & (jnp.where(two, jnp.ones_like(two),
                                          dot(n, w) > 0.0))
    return jnp.where(ok[..., None], emit, 0.0)


def light_power(lt: LightTables, geom):
    """Approximate total power per light (light/*::power) for the power
    light-sampling distribution."""
    area = lt.l_area if lt.has_pre else prim_area(geom, lt.l_prim)
    lum = jnp.sum(lt.l_emit * jnp.asarray([0.212671, 0.715160, 0.072169]), -1)
    pw_point = 4.0 * PI * lum
    pw_dist = PI * lt.world_radius ** 2 * lum
    pw_area = lum * area * PI * jnp.where(lt.l_twosided, 2.0, 1.0)
    pw_inf = jnp.zeros_like(lum)
    for k in range(lt.n_infinite):
        avg = jnp.mean(jnp.sum(lt.inf_maps[k] * jnp.asarray(
            [0.212671, 0.715160, 0.072169]), -1))
        pw_k = PI * lt.world_radius ** 2 * lum * avg
        pw_inf = jnp.where(jnp.arange(lt.n_lights) == lt.inf_rows[k],
                           pw_k, pw_inf)
    pw = jnp.where(lt.l_type == LIGHT_POINT, pw_point,
                   jnp.where(lt.l_type == LIGHT_DISTANT, pw_dist,
                             jnp.where(lt.l_type == LIGHT_AREA, pw_area,
                                       jnp.where(lt.l_type == LIGHT_INFINITE,
                                                 pw_inf, 0.0))))
    return pw
