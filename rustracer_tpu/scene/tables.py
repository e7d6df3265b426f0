"""Flat tensor scene representation and the closest-hit / any-hit kernels.

The reference builds a trait-object graph (Shape → GeometricPrimitive → BVH,
rustracer-core/src/{primitive.rs,scene.rs}); here the whole scene is a pytree
of flat SoA arrays — quadric tables, triangle buffers, a flattened BVH — and
intersection is a batched two-phase wavefront kernel: (1) find the closest
(t, prim) per lane, (2) rebuild the full SurfaceInteraction for winners only.

Global primitive ids: [0, Q) are quadrics, [Q, Q+T) are triangles.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.interaction import Interaction, make_shading_frame
from ..core.math import INFINITY, cross, dot, face_forward, normalize
from ..core.ray import Ray
from ..core.transform import xform_normal, xform_point, xform_vector
from ..ops.quadrics import quadric_hit_t, quadric_intersect
from ..ops.triangle import (triangle_intersect, triangle_partial_derivs,
                            triangle_point_error)


class GeometryTables(NamedTuple):
    # quadrics (padded to >= 1 with a never-hit dummy)
    q_type: jnp.ndarray       # (Q,) int32: 0 sphere / 1 cylinder / 2 disk
    q_o2w: jnp.ndarray        # (Q, 4, 4)
    q_w2o: jnp.ndarray        # (Q, 4, 4)
    q_params: jnp.ndarray     # (Q, 4)
    q_material: jnp.ndarray   # (Q,) int32 (-1 none)
    q_arealight: jnp.ndarray  # (Q,) int32 (-1 none)
    q_reverse: jnp.ndarray    # (Q,) bool: reverse_orientation ^ swaps_handedness
    # triangle mesh soup (world space, padded to >= 1 dummy tri)
    tv_p: jnp.ndarray         # (V, 3)
    tv_n: jnp.ndarray         # (V, 3) zeros if absent
    tv_uv: jnp.ndarray        # (V, 2)
    tv_s: jnp.ndarray         # (V, 3) shading tangents, zeros if absent
    t_idx: jnp.ndarray        # (T, 3) int32
    t_material: jnp.ndarray   # (T,) int32
    t_arealight: jnp.ndarray  # (T,) int32
    t_reverse: jnp.ndarray    # (T,) bool
    t_has_n: jnp.ndarray      # (T,) bool
    t_has_uv: jnp.ndarray     # (T,) bool
    t_alpha_tex: jnp.ndarray  # (T,) int32 alpha-atlas id (-1 none)
    t_shadow_alpha_tex: jnp.ndarray  # (T,) int32 shadow-alpha atlas id
    # packed per-triangle shading rows: ONE (T, 32) row gather replaces the
    # 13 separate table gathers build_interaction otherwise pays per lane
    # (t_idx + 3x tv_p + 3x tv_n + 3x tv_uv + flags + material + arealight).
    # Chosen where a gather cost per index, not per byte; not yet measured
    # on H100. Layout per row:
    #   [0:9) p0 p1 p2 | [9:18) n0 n1 n2 | [18:24) uv0 uv1 uv2 |
    #   24 flags (bit0 has_uv, bit1 has_n, bit2 reverse, bitcast i32) |
    #   25 material (bitcast) | 26 arealight (bitcast) | 27:32 pad
    t_shade: jnp.ndarray      # (T, 32) float32
    # baked alpha-mask atlas (bundle.py::_bake_alpha); length-1 = disabled
    alpha_atlas: jnp.ndarray  # (A,) float32 flattened texels
    alpha_meta: jnp.ndarray   # (K, 3) int32 [offset, width, height]
    # flattened BVH over ALL primitives (see accel/bvh.py); length-1 = disabled
    bvh_lo: jnp.ndarray       # (N, 3) node AABB min
    bvh_hi: jnp.ndarray       # (N, 3) node AABB max
    bvh_meta: jnp.ndarray     # (N, 3) int32: [prim_offset_or_second_child, n_prims, axis]
    bvh_prims: jnp.ndarray    # (P,) int32 ordered global prim ids
    bvh_nodes_packed: jnp.ndarray  # (N, 8): lo(3) hi(3) child mp (bitcast)
    bvh_leaf_packed: jnp.ndarray   # (L, 40): 4 x [p0 p1 p2 tid] baked tris
    bvh_threaded: jnp.ndarray      # (8N, 8): per-octant stackless links
    # 16-wide BVH (accel/wide.py): unified 128-float records, 8 per-octant
    # interior copies + shared leaf block; length-1 table = disabled
    bvh16_table: jnp.ndarray       # (R, 128)
    bvh16_roots: jnp.ndarray       # (8,) int32 per-octant root rows
    bvh16_depth_pad: jnp.ndarray   # shape (depth,) — static stack depth
    # object instancing (primitive.rs:89-118 TransformedPrimitive): shared
    # per-object BLAS entered via instance records in the wide BVH; the
    # instanced triangles' rows in tv_p/t_idx hold OBJECT-space data and a
    # hit carries (tri_id, instance_id). Length-1 identity = no instances.
    inst_o2w: jnp.ndarray          # (I, 4, 4)
    inst_w2o: jnp.ndarray          # (I, 4, 4)
    inst_flip: jnp.ndarray         # (I,) bool — transform swaps handedness
    # shape-(1,) when any REAL prim is a medium interface (material "none",
    # no area light — path.rs:143-152 pass-through), shape-(0,) otherwise:
    # a static signal so interface-free scenes skip the re-trace loop
    iface_flag: jnp.ndarray

    @property
    def n_quadrics(self):
        return self.q_type.shape[0]

    @property
    def n_triangles(self):
        return self.t_idx.shape[0]

    @property
    def has_bvh(self):
        return self.bvh_meta.shape[0] > 1

    @property
    def has_bvh16(self):
        return self.bvh16_table.shape[0] > 1

    @property
    def has_instances(self):
        return self.inst_o2w.shape[0] > 1

    @property
    def has_alpha(self):
        """Static (shape-based) — scenes without alpha masks keep the plain
        intersection kernels with zero overhead."""
        return self.alpha_atlas.shape[0] > 1

    @property
    def has_interfaces(self):
        return self.iface_flag.shape[0] > 0


def _dummy_quadric():
    return dict(
        q_type=np.zeros(1, np.int32),
        q_o2w=np.eye(4, dtype=np.float32)[None],
        q_w2o=np.eye(4, dtype=np.float32)[None],
        q_params=np.array([[0.0, 1.0, 2.0, 2.0 * np.pi]], np.float32),
        q_material=np.full(1, -1, np.int32),
        q_arealight=np.full(1, -1, np.int32),
        q_reverse=np.zeros(1, bool),
    )


def _dummy_tris():
    return dict(
        tv_p=np.zeros((3, 3), np.float32),
        tv_n=np.zeros((3, 3), np.float32),
        tv_uv=np.zeros((3, 2), np.float32),
        tv_s=np.zeros((3, 3), np.float32),
        t_idx=np.zeros((1, 3), np.int32),
        t_material=np.full(1, -1, np.int32),
        t_arealight=np.full(1, -1, np.int32),
        t_reverse=np.zeros(1, bool),
        t_has_n=np.zeros(1, bool),
        t_has_uv=np.zeros(1, bool),
        t_alpha_tex=np.full(1, -1, np.int32),
    )


def _pack_shade_rows(t):
    """Bake the per-triangle shading attributes into (T, 32) rows (layout
    documented on GeometryTables.t_shade). Values are bit-exact copies of
    the separate tables, so build_interaction's results are unchanged."""
    idx = np.asarray(t["t_idx"], np.int32)
    tv_p = np.asarray(t["tv_p"], np.float32)
    tv_n = np.asarray(t["tv_n"], np.float32)
    tv_uv = np.asarray(t["tv_uv"], np.float32)
    T = idx.shape[0]
    rec = np.zeros((T, 32), np.float32)
    for v in range(3):
        rec[:, 3 * v:3 * v + 3] = tv_p[idx[:, v]]
        rec[:, 9 + 3 * v:12 + 3 * v] = tv_n[idx[:, v]]
        rec[:, 18 + 2 * v:20 + 2 * v] = tv_uv[idx[:, v]]
    flags = (np.asarray(t["t_has_uv"]).astype(np.int32)
             | (np.asarray(t["t_has_n"]).astype(np.int32) << 1)
             | (np.asarray(t["t_reverse"]).astype(np.int32) << 2))
    rec[:, 24] = flags.view(np.float32)
    rec[:, 25] = np.asarray(t["t_material"], np.int32).view(np.float32)
    rec[:, 26] = np.asarray(t["t_arealight"], np.int32).view(np.float32)
    return rec


def make_geometry(quadrics: Optional[dict] = None, tris: Optional[dict] = None,
                  bvh: Optional[dict] = None,
                  alpha: Optional[dict] = None) -> GeometryTables:
    """Assemble (host-side, numpy in) → GeometryTables (jnp out)."""
    # medium interfaces detected BEFORE dummy substitution (dummy rows carry
    # material -1 but are never hit and must not force the re-trace loop)
    n_iface = 0
    for src, mk, ak in ((quadrics, "q_material", "q_arealight"),
                        (tris, "t_material", "t_arealight")):
        if src and len(src.get(mk, [])):
            n_iface += int(np.sum((np.asarray(src[mk]) < 0)
                                  & (np.asarray(src[ak]) < 0)))
    q = quadrics if quadrics and len(quadrics.get("q_type", [])) else _dummy_quadric()
    t = tris if tris and len(tris.get("t_idx", [])) else _dummy_tris()
    t.setdefault("t_shadow_alpha_tex",
                 np.full(len(t["t_idx"]), -1, np.int32))
    t["t_shade"] = _pack_shade_rows(t)
    if alpha is None:
        alpha = dict(alpha_atlas=np.ones(1, np.float32),
                     alpha_meta=np.zeros((1, 3), np.int32))
    if bvh is None:
        bvh = {}
    bvh.setdefault("bvh_lo", np.zeros((1, 3), np.float32))
    bvh.setdefault("bvh_hi", np.zeros((1, 3), np.float32))
    bvh.setdefault("bvh_meta", np.zeros((1, 3), np.int32))
    bvh.setdefault("bvh_prims", np.zeros(1, np.int32))
    bvh.setdefault("bvh_nodes_packed", np.zeros((1, 8), np.float32))
    bvh.setdefault("bvh_leaf_packed", np.zeros((1, 40), np.float32))
    bvh.setdefault("bvh_threaded", np.zeros((1, 8), np.float32))
    bvh.setdefault("bvh16_table", np.zeros((1, 128), np.float32))
    bvh.setdefault("bvh16_roots", np.zeros(8, np.int32))
    if "bvh16_depth" in bvh:
        bvh["bvh16_depth_pad"] = np.zeros(int(bvh.pop("bvh16_depth")),
                                          np.float32)
    bvh.setdefault("bvh16_depth_pad", np.zeros(1, np.float32))
    bvh.setdefault("inst_o2w", np.eye(4, dtype=np.float32)[None])
    bvh.setdefault("inst_w2o", np.eye(4, dtype=np.float32)[None])
    bvh.setdefault("inst_flip", np.zeros(1, bool))
    merged = {}
    merged.update(q)
    merged.update(t)
    merged.update(bvh)
    merged.update(alpha)
    merged["iface_flag"] = np.zeros(1 if n_iface else 0, np.int32)
    return GeometryTables(**{k: jnp.asarray(v) for k, v in merged.items()})


# ---------------------------------------------------------------------------
# Phase 1: closest-hit search → (hit, t, prim_id)
# ---------------------------------------------------------------------------

def _quadric_object_ray(tables, ray, qid=None):
    """Transform world rays to object space. qid None = broadcast over all Q."""
    if qid is None:
        w2o = tables.q_w2o                            # (Q, 4, 4)
        o = xform_point(w2o, ray.o[..., None, :])     # (..., Q, 3)
        d = xform_vector(w2o, ray.d[..., None, :])
    else:
        w2o = tables.q_w2o[qid]                       # (..., 4, 4)
        o = xform_point(w2o, ray.o)
        d = xform_vector(w2o, ray.d)
    return o, d


def intersect_quadrics_all(tables: GeometryTables, ray: Ray):
    """Brute-force closest hit over all quadrics: returns (hit, t, qid).

    Implemented as a fori_loop over quadrics with elementwise best-tracking
    instead of a (B, Q) broadcast + argmin: the previous accelerator's XLA
    fusion pass crashed or degenerated to minutes-long compiles when a
    cross-Q reduce was fused into the intersection producers (the plain form
    on the GPU is ROADMAP queue 3 item 3). Quadric counts are small, so the
    sequential loop costs little.
    """
    nq = tables.n_quadrics
    ox, oy, oz = ray.o[..., 0], ray.o[..., 1], ray.o[..., 2]
    dx, dy, dz = ray.d[..., 0], ray.d[..., 1], ray.d[..., 2]

    def body(i, carry):
        # component-form transform + hit-t only: keeps the loop body dense
        # elementwise (a (B, 3) intermediate maps the size-3 axis onto the
        # 128-lane dim at ~2% utilization)
        t_best, qid = carry
        m = tables.q_w2o[i]
        oc = (m[0, 0] * ox + m[0, 1] * oy + m[0, 2] * oz + m[0, 3],
              m[1, 0] * ox + m[1, 1] * oy + m[1, 2] * oz + m[1, 3],
              m[2, 0] * ox + m[2, 1] * oy + m[2, 2] * oz + m[2, 3])
        dc = (m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz,
              m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz,
              m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz)
        t, hit = quadric_hit_t(tables.q_type[i], oc, dc, t_best,
                               tables.q_params[i])
        better = hit & (t < t_best)
        return (jnp.where(better, t, t_best),
                jnp.where(better, i, qid))

    t0 = ray.t_max
    qid0 = jnp.full(ray.t_max.shape, -1, jnp.int32)
    if nq <= 2:
        t_best, qid = (t0, qid0)
        for i in range(nq):
            t_best, qid = body(i, (t_best, qid))
    else:
        t_best, qid = jax.lax.fori_loop(0, nq, body, (t0, qid0))
    hit = qid >= 0
    return hit, jnp.where(hit, t_best, INFINITY), jnp.maximum(qid, 0)


def intersect_triangles_brute(tables: GeometryTables, ray: Ray):
    """Brute-force closest hit over all triangles: (hit, t, tid).

    fori_loop over triangles (same compiler rationale as the quadric loop);
    only used for tiny scenes — meshes go through the BVH."""
    nt = tables.n_triangles

    def body(i, carry):
        t_best, tid = carry
        idx = tables.t_idx[i]
        th = triangle_intersect(ray.o, ray.d, t_best, tables.tv_p[idx[0]],
                                tables.tv_p[idx[1]], tables.tv_p[idx[2]])
        better = th.hit & (th.t < t_best)
        return (jnp.where(better, th.t, t_best),
                jnp.where(better, i, tid))

    t0 = ray.t_max
    tid0 = jnp.full(ray.t_max.shape, -1, jnp.int32)
    if nt <= 2:
        t_best, tid = (t0, tid0)
        for i in range(nt):
            t_best, tid = body(i, (t_best, tid))
    else:
        t_best, tid = jax.lax.fori_loop(0, nt, body, (t0, tid0))
    hit = tid >= 0
    return hit, jnp.where(hit, t_best, INFINITY), jnp.maximum(tid, 0)


def _closest_prim(tables: GeometryTables, ray: Ray):
    """Closest hit over quadrics + triangles → (hit, t, global prim id,
    instance id). Instance id is -1 except for hits on instanced triangles
    (primitive.rs:89-118)."""
    nq = tables.n_quadrics
    qhit, qt, qid = intersect_quadrics_all(tables, ray)
    inst = jnp.full(ray.t_max.shape, -1, jnp.int32)
    if tables.has_bvh16:
        from ..accel.traverse16 import bvh16_intersect_triangles_inst
        ray_t = ray._replace(t_max=jnp.where(qhit, qt, ray.t_max))
        thit, tt, tid, inst = bvh16_intersect_triangles_inst(tables, ray_t)
    elif tables.has_bvh:
        from ..accel.traverse import bvh_intersect_triangles
        # tighten t_max with the quadric hit before traversal
        ray_t = ray._replace(t_max=jnp.where(qhit, qt, ray.t_max))
        thit, tt, tid = bvh_intersect_triangles(tables, ray_t)
    else:
        assert not tables.has_instances, \
            "instanced scenes require the wide BVH (bvh16) path"
        thit, tt, tid = intersect_triangles_brute(tables, ray)
    use_tri = thit & (~qhit | (tt < qt))
    hit = qhit | thit
    t = jnp.where(use_tri, tt, qt)
    prim = jnp.where(use_tri, tid + nq, qid)
    return hit, t, prim, jnp.where(use_tri, inst, -1)


def _alpha_at(tables: GeometryTables, aid, uv):
    """Bilinear sample of the baked alpha atlas (wrap repeat). aid < 0 → 1."""
    meta = tables.alpha_meta[jnp.maximum(aid, 0)]
    off = meta[..., 0]
    w = meta[..., 1]
    h = meta[..., 2]
    wf = jnp.maximum(w, 1).astype(jnp.float32)
    hf = jnp.maximum(h, 1).astype(jnp.float32)
    u = uv[..., 0] * wf - 0.5
    v = uv[..., 1] * hf - 0.5
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du = u - u0
    dv = v - v0
    u0 = u0.astype(jnp.int32)
    v0 = v0.astype(jnp.int32)
    wi = jnp.maximum(w, 1)
    hi = jnp.maximum(h, 1)

    def texel(ui, vi):
        ui = jnp.mod(ui, wi)
        vi = jnp.mod(vi, hi)
        return tables.alpha_atlas[off + vi * wi + ui]

    a = (texel(u0, v0) * (1 - du) * (1 - dv)
         + texel(u0 + 1, v0) * du * (1 - dv)
         + texel(u0, v0 + 1) * (1 - du) * dv
         + texel(u0 + 1, v0 + 1) * du * dv)
    return jnp.where(aid >= 0, a, 1.0)


def _inst_xform_pts(tables: GeometryTables, inst, *pts):
    """Object→world transform of gathered vertex positions for instanced
    hits (inst >= 0); static hits pass through unchanged."""
    if not tables.has_instances or inst is None:
        return pts
    o2w = tables.inst_o2w[jnp.maximum(inst, 0)]
    use = (inst >= 0)[..., None]
    return tuple(jnp.where(use, xform_point(o2w, p), p) for p in pts)


def _tri_hit_uv(tables: GeometryTables, ray: Ray, t, tid, inst=None):
    """Interpolated uv of triangle `tid` at ray parameter ~t."""
    idx = tables.t_idx[tid]
    p0 = tables.tv_p[idx[..., 0]]
    p1 = tables.tv_p[idx[..., 1]]
    p2 = tables.tv_p[idx[..., 2]]
    p0, p1, p2 = _inst_xform_pts(tables, inst, p0, p1, p2)
    th = triangle_intersect(ray.o, ray.d, t * 1.0001 + 1e-4, p0, p1, p2)
    has_uv = tables.t_has_uv[tid]
    z = jnp.zeros_like(t)
    o = jnp.ones_like(t)
    uv0 = jnp.where(has_uv[..., None], tables.tv_uv[idx[..., 0]],
                    jnp.stack([z, z], -1))
    uv1 = jnp.where(has_uv[..., None], tables.tv_uv[idx[..., 1]],
                    jnp.stack([o, z], -1))
    uv2 = jnp.where(has_uv[..., None], tables.tv_uv[idx[..., 2]],
                    jnp.stack([o, o], -1))
    return (th.b0[..., None] * uv0 + th.b1[..., None] * uv1
            + th.b2[..., None] * uv2)


def _closest_with_alpha(tables: GeometryTables, ray: Ray, cols,
                        max_rounds=64):
    """Closest hit honoring alpha cutouts: hits whose alpha evaluates to 0
    are skipped by re-tracing from just past the rejected surface
    (reference mesh.rs:355-367 rejects per-triangle; the wavefront re-trace
    visits the same surfaces in order). `cols` lists the per-triangle
    alpha-atlas columns to test (camera: alpha; shadow: alpha+shadowalpha,
    mesh.rs:572-577)."""
    nq = tables.n_quadrics
    bs = ray.t_max.shape

    def trace_round(t_off):
        o2 = ray.o + ray.d * t_off[..., None]
        r2 = ray._replace(o=o2, t_max=ray.t_max - t_off)
        hit, t, prim, inst = _closest_prim(tables, r2)
        is_tri = hit & (prim >= nq)
        tid = jnp.clip(jnp.where(is_tri, prim - nq, 0), 0,
                       tables.n_triangles - 1)
        uv = _tri_hit_uv(tables, r2, t, tid, inst)
        rej = jnp.zeros(bs, bool)
        for col in cols:
            aid = jnp.where(is_tri, col[tid], -1)
            rej = rej | (is_tri & (aid >= 0) & (_alpha_at(tables, aid, uv)
                                                == 0.0))
        return hit, t, prim, inst, rej

    hit0, t0, prim0, inst0, rej0 = trace_round(jnp.zeros(bs, jnp.float32))
    # loop state carries the rejected surface's local t so the next round
    # restarts just past it
    state = (jnp.zeros(bs, jnp.float32),                 # t_off
             jnp.where(rej0, False, hit0),               # accepted hit
             jnp.where(rej0, INFINITY, t0),              # accepted local t
             jnp.where(rej0, -1, prim0),                 # accepted prim
             jnp.where(rej0, -1, inst0),                 # accepted instance
             rej0 & hit0,                                # pending re-trace
             jnp.zeros((), jnp.int32),                   # round counter
             jnp.where(rej0, t0, 0.0))                   # rejected local t

    def body2(s):
        t_off, hit, t_loc, prim, inst, pending, k, rej_t = s
        t_off = jnp.where(pending,
                          t_off + rej_t * 1.0001 + 1e-5, t_off)
        h2, t2, p2, i2, rej2 = trace_round(t_off)
        accept = pending & ~rej2
        hit = jnp.where(accept, h2, hit)
        t_loc = jnp.where(accept, t2, t_loc)
        prim = jnp.where(accept, p2, prim)
        inst = jnp.where(accept, i2, inst)
        rej_t = jnp.where(pending & rej2, t2, rej_t)
        pending = pending & rej2 & h2 & (t_off < ray.t_max)
        return (t_off, hit, t_loc, prim, inst, pending, k + 1, rej_t)

    def cond2(s):
        return jnp.any(s[5]) & (s[6] < max_rounds)

    t_off, hit, t_loc, prim, inst, _, _, _ = jax.lax.while_loop(cond2, body2,
                                                                state)
    t = jnp.where(hit, t_off + t_loc, INFINITY)
    prim = jnp.where(hit, jnp.maximum(prim, 0), 0)
    return hit, t, prim, inst, t_off


def scene_intersect(tables: GeometryTables, ray: Ray) -> Interaction:
    """Closest-hit over the whole scene → full SurfaceInteraction batch.

    Triangles go through the BVH when present (accel/traverse.py); quadric
    counts are tiny and stay brute-force either way. Alpha-masked scenes
    re-trace past cutout hits (mesh.rs alpha semantics)."""
    if tables.has_alpha:
        hit, t, prim, inst, t_off = _closest_with_alpha(
            tables, ray, cols=(tables.t_alpha_tex,))
        # rebuild the interaction against the advanced ray so the winning
        # surface is re-intersected exactly
        ray_adv = ray._replace(o=ray.o + ray.d * t_off[..., None],
                               t_max=ray.t_max - t_off)
        si = build_interaction(tables, ray_adv, hit,
                               jnp.where(hit, t - t_off, INFINITY), prim,
                               inst)
        return si._replace(t=jnp.where(hit, t, INFINITY))
    hit, t, prim, inst = _closest_prim(tables, ray)
    return build_interaction(tables, ray, hit, t, prim, inst)


def _si_where(mask, a: Interaction, b: Interaction) -> Interaction:
    """Per-lane select between two Interaction batches (mask (B,))."""
    def w(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return jnp.where(m, x, y)
    return jax.tree_util.tree_map(w, a, b)


def scene_intersect_passthrough(tables: GeometryTables, ray: Ray,
                                max_skips: int = 8) -> Interaction:
    """Closest hit that passes THROUGH medium-interface prims (material
    "none"/-1 and no area light): the reference's path tracer continues a
    BSDF-less hit in the same direction without consuming a bounce
    (path.rs:143-152). Wavefront form: lanes whose hit is an interface
    re-trace from just past it, up to max_skips rounds (while_loop — an
    interface-free wavefront exits after one cond eval, and interface-free
    SCENES skip the loop statically via has_interfaces). Emissive
    material-less prims are treated as real hits (they emit, then the lane
    dies), matching the reference for every scene whose lights carry
    materials."""
    si = scene_intersect(tables, ray)
    if not tables.has_interfaces or max_skips <= 0:
        return si

    def pend(s):
        return s.valid & (s.material < 0) & (s.arealight < 0)

    def cond(carry):
        s, _, k = carry
        return jnp.any(pend(s)) & (k < max_skips)

    def body(carry):
        s, o_cur, k = carry
        p = pend(s)
        r2 = s.spawn_ray(ray.d)
        o2 = jnp.where(p[..., None], r2.o, o_cur)
        r = Ray(o=o2, d=ray.d, t_max=jnp.where(p, r2.t_max, 0.0))
        s2 = scene_intersect(tables, r)
        return _si_where(p, s2, s), o2, k + 1

    si, _, _ = jax.lax.while_loop(
        cond, body, (si, ray.o, jnp.zeros((), jnp.int32)))
    return si


def scene_intersect_p(tables: GeometryTables, ray: Ray):
    """Any-hit (shadow) test: returns (...) bool occluded."""
    if tables.has_alpha:
        # shadow rays honor BOTH alpha and shadowalpha (mesh.rs:572-577)
        hit, _, _, _, _ = _closest_with_alpha(
            tables, ray,
            cols=(tables.t_alpha_tex, tables.t_shadow_alpha_tex))
        return hit
    qhit, _, _ = intersect_quadrics_all(tables, ray)
    if tables.has_bvh16:
        from ..accel.traverse16 import bvh16_intersect_p_triangles
        thit = bvh16_intersect_p_triangles(tables, ray._replace(
            t_max=jnp.where(qhit, jnp.zeros_like(ray.t_max), ray.t_max)))
        return qhit | thit
    if tables.has_bvh:
        from ..accel.traverse import bvh_intersect_p_triangles
        thit = bvh_intersect_p_triangles(tables, ray._replace(
            t_max=jnp.where(qhit, jnp.zeros_like(ray.t_max), ray.t_max)))
        return qhit | thit
    thit, _, _ = intersect_triangles_brute(tables, ray)
    return qhit | thit


# ---------------------------------------------------------------------------
# Phase 2: rebuild the winning hit's SurfaceInteraction
# ---------------------------------------------------------------------------

def build_interaction(tables: GeometryTables, ray: Ray, hit, t, prim,
                      inst=None) -> Interaction:
    nq = tables.n_quadrics
    is_tri = prim >= nq
    qid = jnp.clip(jnp.where(is_tri, 0, prim), 0, nq - 1)
    tid = jnp.clip(jnp.where(is_tri, prim - nq, 0), 0, tables.n_triangles - 1)

    # --- quadric branch (single gathered quadric per lane) ---
    o_obj, d_obj = _quadric_object_ray(tables, ray, qid)
    q_params = tables.q_params[qid]
    q_type = tables.q_type[qid]
    qh = quadric_intersect(q_type, o_obj, d_obj,
                           jnp.where(hit, t * 1.0001 + 1e-4, ray.t_max),
                           q_params)
    o2w = tables.q_o2w[qid]
    w2o = tables.q_w2o[qid]
    q_p = xform_point(o2w, qh.p)
    # conservative world-space error: |M| * err + gamma3 * (|M||p| + |trans|)
    from ..core.math import gamma
    from ..core.transform import apply_mat3
    absM = jnp.abs(o2w)
    e1 = jnp.stack(apply_mat3(absM, qh.p_error[..., 0], qh.p_error[..., 1],
                              qh.p_error[..., 2]), axis=-1)
    ap = jnp.abs(qh.p)
    e2 = jnp.stack(apply_mat3(absM, ap[..., 0], ap[..., 1], ap[..., 2]),
                   axis=-1)
    q_perr = e1 + gamma(3) * (e2 + jnp.abs(o2w[..., :3, 3]))
    q_dpdu = xform_vector(o2w, qh.dpdu)
    q_dpdv = xform_vector(o2w, qh.dpdv)
    q_n = normalize(cross(q_dpdu, q_dpdv))
    q_rev = tables.q_reverse[qid]
    q_n = jnp.where(q_rev[..., None], -q_n, q_n)
    # normal derivatives (sphere: n = p/r so dn/du = dp/du / r — exact;
    # cylinder: dn/du = dp/du / r, dn/dv = 0; disk: flat, 0). The reference
    # computes these via the Weingarten equations (sphere.rs/cylinder.rs);
    # for these quadrics the closed forms coincide.
    radius = q_params[..., 0]
    inv_r = 1.0 / jnp.maximum(radius, 1e-8)
    ku = jnp.where(q_type == 2, 0.0, inv_r)              # disk → 0
    kv = jnp.where(q_type == 0, inv_r, 0.0)              # sphere only
    q_dndu = xform_normal(w2o, qh.dpdu * ku[..., None])
    q_dndv = xform_normal(w2o, qh.dpdv * kv[..., None])
    q_dndu = jnp.where(q_rev[..., None], -q_dndu, q_dndu)
    q_dndv = jnp.where(q_rev[..., None], -q_dndv, q_dndv)
    q_uv = qh.uv
    q_mat = tables.q_material[qid]
    q_al = tables.q_arealight[qid]

    # --- triangle branch ---
    # ONE packed-row gather (t_shade layout) replaces 13 separate table
    # gathers (see GeometryTables.t_shade). Instanced hits (inst >= 0): the stored
    # rows are OBJECT-space; transform the three vertices (and below, the
    # vertex normals) to world so the rest of the branch is
    # space-agnostic. The reference instead transforms the finished
    # interaction (primitive.rs:100-113); doing it at the vertices keeps
    # the watertight re-intersection exact.
    rec = tables.t_shade[tid]                 # (..., 32)
    bc = lambda c: jax.lax.bitcast_convert_type(rec[..., c], jnp.int32)
    p0, p1, p2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
    p0, p1, p2 = _inst_xform_pts(tables, inst, p0, p1, p2)
    th = triangle_intersect(ray.o, ray.d, jnp.where(hit, t * 1.0001 + 1e-4, ray.t_max),
                            p0, p1, p2)
    flags = bc(24)
    has_uv = (flags & 1) != 0
    uv_default = jnp.stack([
        jnp.stack([jnp.zeros_like(t), jnp.zeros_like(t)], -1),
        jnp.stack([jnp.ones_like(t), jnp.zeros_like(t)], -1),
        jnp.stack([jnp.ones_like(t), jnp.ones_like(t)], -1)], axis=-2)  # (..., 3, 2)
    uv0 = jnp.where(has_uv[..., None], rec[..., 18:20], uv_default[..., 0, :])
    uv1 = jnp.where(has_uv[..., None], rec[..., 20:22], uv_default[..., 1, :])
    uv2 = jnp.where(has_uv[..., None], rec[..., 22:24], uv_default[..., 2, :])
    t_p, t_perr = triangle_point_error(th.b0, th.b1, th.b2, p0, p1, p2)
    t_uv = th.b0[..., None] * uv0 + th.b1[..., None] * uv1 + th.b2[..., None] * uv2
    t_dpdu, t_dpdv = triangle_partial_derivs(p0, p1, p2, uv0, uv1, uv2)
    t_ng = normalize(cross(p0 - p2, p1 - p2))
    t_rev = (flags & 4) != 0
    if tables.has_instances and inst is not None:
        # a handedness-swapping instance transform flips orientation
        # (primitive.rs via transform.swaps_handedness)
        t_rev = t_rev ^ ((inst >= 0)
                         & tables.inst_flip[jnp.maximum(inst, 0)])
    t_ng = jnp.where(t_rev[..., None], -t_ng, t_ng)
    # shading normal from vertex normals
    has_n = (flags & 2) != 0
    nv0 = rec[..., 9:12]
    nv1 = rec[..., 12:15]
    nv2 = rec[..., 15:18]
    if tables.has_instances and inst is not None:
        iw2o = tables.inst_w2o[jnp.maximum(inst, 0)]
        use_i = (inst >= 0)[..., None]
        nv0 = jnp.where(use_i, xform_normal(iw2o, nv0), nv0)
        nv1 = jnp.where(use_i, xform_normal(iw2o, nv1), nv1)
        nv2 = jnp.where(use_i, xform_normal(iw2o, nv2), nv2)
    n_interp = normalize(th.b0[..., None] * nv0
                         + th.b1[..., None] * nv1
                         + th.b2[..., None] * nv2)
    n_interp = jnp.where(t_rev[..., None], -n_interp, n_interp)
    t_ns = jnp.where(has_n[..., None], n_interp, t_ng)
    # keep geometric normal on the same side as shading normal (mesh.rs)
    t_ng = jnp.where(has_n[..., None], face_forward(t_ng, t_ns), t_ng)
    # shading-normal derivatives from vertex normals (mesh.rs dndu/dndv)
    from ..ops.triangle import triangle_normal_derivs
    t_dndu, t_dndv = triangle_normal_derivs(nv0, nv1, nv2, uv0, uv1, uv2)
    t_dndu = jnp.where((has_n & ~t_rev)[..., None], t_dndu,
                       jnp.where((has_n & t_rev)[..., None], -t_dndu, 0.0))
    t_dndv = jnp.where((has_n & ~t_rev)[..., None], t_dndv,
                       jnp.where((has_n & t_rev)[..., None], -t_dndv, 0.0))
    t_mat = bc(25)
    t_al = bc(26)

    # --- select ---
    w = lambda a, b: jnp.where(is_tri[..., None], a, b)
    ws = lambda a, b: jnp.where(is_tri, a, b)
    p = w(t_p, q_p)
    p_error = w(t_perr, q_perr)
    n = w(t_ng, q_n)
    uv = w(t_uv, q_uv)
    dpdu = w(t_dpdu, q_dpdu)
    dpdv = w(t_dpdv, q_dpdv)
    dndu = w(t_dndu, q_dndu)
    dndv = w(t_dndv, q_dndv)
    ns = w(t_ns, q_n)
    material = ws(t_mat, q_mat)
    arealight = ws(t_al, q_al)
    ss, ts = make_shading_frame(ns, dpdu)
    zero3 = jnp.zeros_like(p)
    zero = jnp.zeros_like(t)
    neg1 = jnp.full(t.shape, -1, jnp.int32)
    # Sanitize miss lanes: the masked quadric/triangle math above runs at
    # t=INFINITY for misses and produces non-finite p/n/dpdu. Downstream code
    # masks them out of the *forward* result, but any product `a * nan`
    # poisons the cotangent of `a` in the backward pass (0 * nan = nan), so
    # gradients w.r.t. material/light parameters would turn NaN. Pin miss
    # lanes to finite placeholders instead.
    h3 = hit[..., None]
    zhat = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), p.shape)
    xhat = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), p.shape)
    yhat = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), p.shape)
    p = jnp.where(h3, p, ray.o)
    p_error = jnp.where(h3, p_error, 0.0)
    n = jnp.where(h3, n, zhat)
    ns = jnp.where(h3, ns, zhat)
    ss = jnp.where(h3, ss, xhat)
    ts = jnp.where(h3, ts, yhat)
    uv = jnp.where(h3, uv, 0.0)
    dpdu = jnp.where(h3, dpdu, xhat)
    dpdv = jnp.where(h3, dpdv, yhat)
    dndu = jnp.where(h3 & jnp.isfinite(dndu), dndu, 0.0)
    dndv = jnp.where(h3 & jnp.isfinite(dndv), dndv, 0.0)
    return Interaction(
        valid=hit, t=t, p=p, p_error=p_error, wo=normalize(-ray.d),
        n=n, uv=uv, dpdu=dpdu, dpdv=dpdv, ns=ns, ss=ss, ts=ts,
        material=jnp.where(hit, material, neg1),
        arealight=jnp.where(hit, arealight, neg1),
        prim_id=jnp.where(hit, prim, neg1),
        dudx=zero, dvdx=zero, dudy=zero, dvdy=zero, dpdx=zero3, dpdy=zero3,
        dndu=dndu, dndv=dndv,
    )
