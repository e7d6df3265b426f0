"""Batched quadric intersection/sampling kernels: sphere, cylinder, disk.

Reference: rustracer-core/src/shapes/{sphere,cylinder,disk}.rs. All functions
take object-space rays as (..., 3) arrays and are fully branch-free (masked
lanes instead of early returns). Instead of the reference's EFloat interval
arithmetic we use the numerically-stable quadratic plus conservative
`gamma(n)`-scaled error bounds — robustness comes from offset_ray_origin.

Quadric param layout (tables.q_params, (..., 4)):
  sphere:   [radius, z_min, z_max, phi_max]
  cylinder: [radius, z_min, z_max, phi_max]
  disk:     [height, radius, inner_radius, phi_max]
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math import (PI, gamma, quadratic, dot, cross, length_squared,
                         normalize, vec)

# q_type codes
SPHERE, CYLINDER, DISK = 0, 1, 2


class QuadricHit(NamedTuple):
    hit: jnp.ndarray      # (...) bool
    t: jnp.ndarray        # (...) ray parameter
    p: jnp.ndarray        # (..., 3) object-space hit point (refined)
    p_error: jnp.ndarray  # (..., 3) object-space error bound
    uv: jnp.ndarray       # (..., 2)
    dpdu: jnp.ndarray     # (..., 3) object space
    dpdv: jnp.ndarray     # (..., 3)


def _phi_of(p):
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    return jnp.where(phi < 0.0, phi + 2.0 * PI, phi)


def sphere_intersect(o, d, t_max, radius, z_min, z_max, phi_max):
    """Sphere (reference sphere.rs:70-200), vectorized and maskable.

    Handles the z/phi-clipped partial sphere incl. retry with t1 when t0's
    hit is clipped away.
    """
    a = length_squared(d)
    b = 2.0 * dot(o, d)
    c = length_squared(o) - radius * radius
    t0, t1, has = quadratic(a, b, c)

    def eval_at(t):
        p = o + t[..., None] * d
        # reproject onto the sphere (reference "refine sphere intersection")
        p = p * (radius / jnp.maximum(jnp.sqrt(length_squared(p)), 1e-20))[..., None]
        # avoid phi degenerate at poles
        px = jnp.where((p[..., 0] == 0.0) & (p[..., 1] == 0.0), 1e-5 * radius, p[..., 0])
        p = jnp.stack([px, p[..., 1], p[..., 2]], axis=-1)
        phi = _phi_of(p)
        full = phi_max >= 2.0 * PI - 1e-6
        z_ok = (p[..., 2] >= z_min) & (p[..., 2] <= z_max)
        clip_ok = jnp.where(full & (z_min <= -radius) & (z_max >= radius),
                            jnp.ones_like(z_ok), z_ok & (phi <= phi_max))
        return p, phi, clip_ok

    p0, phi0, ok0 = eval_at(t0)
    p1, phi1, ok1 = eval_at(t1)
    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok0
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok1
    use1 = (~valid0) & valid1
    hit = valid0 | valid1
    t = jnp.where(use1, t1, t0)
    p = jnp.where(use1[..., None], p1, p0)
    phi = jnp.where(use1, phi1, phi0)

    # parametric representation (sphere.rs:160-205)
    theta = jnp.arccos(jnp.clip(p[..., 2] / radius, -1.0, 1.0))
    theta_min = jnp.arccos(jnp.clip(z_min / radius, -1.0, 1.0))
    theta_max = jnp.arccos(jnp.clip(z_max / radius, -1.0, 1.0))
    u = phi / phi_max
    span = theta_max - theta_min
    span = jnp.where(jnp.abs(span) > 1e-9, span, 1.0)
    v = (theta - theta_min) / span
    z_radius = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    inv_zr = 1.0 / jnp.maximum(z_radius, 1e-20)
    cos_phi = p[..., 0] * inv_zr
    sin_phi = p[..., 1] * inv_zr
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(phi)], axis=-1)
    dpdv = jnp.stack([p[..., 2] * cos_phi, p[..., 2] * sin_phi,
                      -radius * jnp.sin(theta)], axis=-1) * \
        jnp.broadcast_to(theta_max - theta_min, phi.shape)[..., None]
    p_error = gamma(5) * jnp.abs(p)
    return QuadricHit(hit=hit, t=t, p=p, p_error=p_error,
                      uv=jnp.stack([u, v], axis=-1), dpdu=dpdu, dpdv=dpdv)


def cylinder_intersect(o, d, t_max, radius, z_min, z_max, phi_max):
    """Cylinder (reference cylinder.rs:60-200)."""
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - radius * radius
    a_safe = jnp.where(a == 0.0, 1e-20, a)
    t0, t1, has = quadratic(a_safe, b, c)
    has = has & (a > 0.0)

    def eval_at(t):
        p = o + t[..., None] * d
        hit_rad = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        s = radius / jnp.maximum(hit_rad, 1e-20)
        p = jnp.stack([p[..., 0] * s, p[..., 1] * s, p[..., 2]], axis=-1)
        phi = _phi_of(p)
        ok = (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)
        return p, phi, ok

    p0, phi0, ok0 = eval_at(t0)
    p1, phi1, ok1 = eval_at(t1)
    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok0
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok1
    use1 = (~valid0) & valid1
    hit = valid0 | valid1
    t = jnp.where(use1, t1, t0)
    p = jnp.where(use1[..., None], p1, p0)
    phi = jnp.where(use1, phi1, phi0)

    u = phi / phi_max
    v = (p[..., 2] - z_min) / jnp.maximum(z_max - z_min, 1e-20)
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(phi)], axis=-1)
    zspan = jnp.broadcast_to(z_max - z_min, phi.shape)
    dpdv = jnp.stack([jnp.zeros_like(phi), jnp.zeros_like(phi), zspan], axis=-1)
    p_error = gamma(3) * jnp.abs(jnp.stack(
        [p[..., 0], p[..., 1], jnp.zeros_like(phi)], axis=-1))
    return QuadricHit(hit=hit, t=t, p=p, p_error=p_error,
                      uv=jnp.stack([u, v], axis=-1), dpdu=dpdu, dpdv=dpdv)


def disk_intersect(o, d, t_max, height, radius, inner_radius, phi_max):
    """Disk in z=height plane (reference disk.rs:40-150)."""
    dz = d[..., 2]
    parallel = jnp.abs(dz) < 1e-12
    t = (height - o[..., 2]) / jnp.where(parallel, 1.0, dz)
    p = o + t[..., None] * d
    dist2 = p[..., 0] ** 2 + p[..., 1] ** 2
    phi = _phi_of(p)
    hit = (~parallel) & (t > 0.0) & (t < t_max) & \
        (dist2 <= radius * radius) & (dist2 >= inner_radius * inner_radius) & \
        (phi <= phi_max)
    r_hit = jnp.sqrt(dist2)
    u = phi / phi_max
    one_minus_v = (r_hit - inner_radius) / jnp.maximum(radius - inner_radius, 1e-20)
    v = 1.0 - one_minus_v
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(phi)], axis=-1)
    inv_r = 1.0 / jnp.maximum(r_hit, 1e-20)
    dpdv = jnp.stack([p[..., 0] * inv_r, p[..., 1] * inv_r,
                      jnp.zeros_like(phi)], axis=-1) * \
        ((inner_radius - radius) * jnp.ones_like(phi))[..., None]
    p = jnp.stack([p[..., 0], p[..., 1],
                   jnp.broadcast_to(height, p[..., 2].shape)], axis=-1)
    p_error = jnp.zeros_like(p)
    return QuadricHit(hit=hit, t=t, p=p, p_error=p_error,
                      uv=jnp.stack([u, v], axis=-1), dpdu=dpdu, dpdv=dpdv)


def _sphere_hit_t(oc, dc, t_max, radius, z_min, z_max, phi_max):
    """Closest-hit (t, hit) only, pure component math (lane-dense)."""
    ox, oy, oz = oc
    dx, dy, dz = dc
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ox * dx + oy * dy + oz * dz)
    c = ox * ox + oy * oy + oz * oz - radius * radius
    t0, t1, has = quadratic(a, b, c)

    def ok_at(t):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        s = radius / jnp.maximum(jnp.sqrt(px * px + py * py + pz * pz), 1e-20)
        px, py, pz = px * s, py * s, pz * s
        px = jnp.where((px == 0.0) & (py == 0.0), 1e-5 * radius, px)
        phi = jnp.arctan2(py, px)
        phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
        full = phi_max >= 2.0 * PI - 1e-6
        z_ok = (pz >= z_min) & (pz <= z_max)
        return jnp.where(full & (z_min <= -radius) & (z_max >= radius),
                         jnp.ones_like(z_ok), z_ok & (phi <= phi_max))

    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok_at(t0)
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok_at(t1)
    t = jnp.where(valid0, t0, t1)
    return t, valid0 | valid1


def _cylinder_hit_t(oc, dc, t_max, radius, z_min, z_max, phi_max):
    ox, oy, oz = oc
    dx, dy, dz = dc
    a = dx * dx + dy * dy
    b = 2.0 * (dx * ox + dy * oy)
    c = ox * ox + oy * oy - radius * radius
    t0, t1, has = quadratic(jnp.where(a == 0.0, 1e-20, a), b, c)
    has = has & (a > 0.0)

    def ok_at(t):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        phi = jnp.arctan2(py, px)
        phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
        return (pz >= z_min) & (pz <= z_max) & (phi <= phi_max)

    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok_at(t0)
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok_at(t1)
    t = jnp.where(valid0, t0, t1)
    return t, valid0 | valid1


def _disk_hit_t(oc, dc, t_max, height, radius, inner_radius, phi_max):
    ox, oy, oz = oc
    dx, dy, dz = dc
    parallel = jnp.abs(dz) < 1e-12
    t = (height - oz) / jnp.where(parallel, 1.0, dz)
    px, py = ox + t * dx, oy + t * dy
    dist2 = px * px + py * py
    phi = jnp.arctan2(py, px)
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    hit = (~parallel) & (t > 0.0) & (t < t_max) & \
        (dist2 <= radius * radius) & \
        (dist2 >= inner_radius * inner_radius) & (phi <= phi_max)
    return t, hit


def quadric_hit_t(q_type, oc, dc, t_max, params):
    """(t, hit) for ONE quadric type code (a scalar) over a lane batch.

    oc/dc are object-space ray component triples; `lax.switch` runs only the
    matching kernel (the fori_loop caller visits one quadric per step).
    """
    import jax
    r0, r1, r2, r3 = (params[..., i] for i in range(4))
    return jax.lax.switch(
        jnp.clip(q_type, 0, 2),
        [lambda: _sphere_hit_t(oc, dc, t_max, r0, r1, r2, r3),
         lambda: _cylinder_hit_t(oc, dc, t_max, r0, r1, r2, r3),
         lambda: _disk_hit_t(oc, dc, t_max, r0, r1, r2, r3)])


def quadric_intersect(q_type, o, d, t_max, params):
    """Dispatch on quadric type with masked evaluation of all three kernels.

    All args broadcast; q_type (...,) int32. Cheap because the three kernels
    share most subexpressions' cost and everything stays elementwise.
    """
    r0, r1, r2, r3 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    hs = sphere_intersect(o, d, t_max, r0, r1, r2, r3)
    hc = cylinder_intersect(o, d, t_max, r0, r1, r2, r3)
    hd = disk_intersect(o, d, t_max, r0, r1, r2, r3)

    vector_fields = {"p", "p_error", "uv", "dpdu", "dpdv"}

    def sel(field):
        a = getattr(hs, field)
        b = getattr(hc, field)
        c = getattr(hd, field)
        # scalar fields are (..., Q); vector fields (..., Q, C) need an
        # extra broadcast axis on q_type
        qt = q_type[..., None] if field in vector_fields else q_type
        return jnp.where(qt == SPHERE, a, jnp.where(qt == CYLINDER, b, c))

    return QuadricHit(*(sel(f) for f in QuadricHit._fields))


def quadric_area(q_type, params):
    radius, z0, z1, phi_max = (params[..., i] for i in range(4))
    sphere_a = phi_max * radius * (z1 - z0)
    cyl_a = (z1 - z0) * radius * phi_max
    # disk: params = [height, radius, inner_radius, phi_max]
    disk_a = params[..., 3] * 0.5 * (params[..., 1] ** 2 - params[..., 2] ** 2)
    return jnp.where(q_type == SPHERE, sphere_a,
                     jnp.where(q_type == CYLINDER, cyl_a, disk_a))


def quadric_world_bounds_np(q_type, o2w, params):
    """Host-side conservative world AABBs for the BVH build (numpy)."""
    import numpy as np
    n = q_type.shape[0]
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    for i in range(n):
        if q_type[i] == DISK:
            h, r = params[i, 0], params[i, 1]
            obj_lo = np.array([-r, -r, h - 1e-4])
            obj_hi = np.array([r, r, h + 1e-4])
        else:
            r, z0, z1 = params[i, 0], params[i, 1], params[i, 2]
            obj_lo = np.array([-r, -r, z0])
            obj_hi = np.array([r, r, z1])
        corners = np.array([[obj_lo[0] if a == 0 else obj_hi[0],
                             obj_lo[1] if b == 0 else obj_hi[1],
                             obj_lo[2] if c == 0 else obj_hi[2]]
                            for a in (0, 1) for b in (0, 1) for c in (0, 1)],
                           np.float32)
        w = corners @ o2w[i, :3, :3].T + o2w[i, :3, 3]
        lo[i] = w.min(axis=0)
        hi[i] = w.max(axis=0)
    return lo, hi
