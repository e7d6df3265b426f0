"""Batched watertight ray-triangle intersection and triangle sampling.

Reference: rustracer-core/src/shapes/mesh.rs:214-260 (the PBRT watertight
test: translate/permute/shear + edge functions). The reference's f64 fallback
at exactly-zero edge functions (mesh.rs:236-244) is reproduced in pure f32 via
error-free Dekker two-products (no f64 on the device path): where an edge function
rounds to exactly 0, its sign is re-resolved from the exactly-computed
residual, which is at least as accurate as the f64 recompute.

All functions broadcast: rays (..., 3) against triangles (..., 3) vertex
arrays; callers arrange broadcasting, e.g. (B, 1, 3) rays x (1, T, 3) tris.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math import cross, dot, gamma, length_squared, normalize
from ..core.sampling import uniform_sample_triangle


class TriHit(NamedTuple):
    hit: jnp.ndarray   # (...) bool
    t: jnp.ndarray     # (...)
    b0: jnp.ndarray    # barycentrics
    b1: jnp.ndarray
    b2: jnp.ndarray


def _unpack(v):
    """(..., 3) → three (...,) components.

    Layout note: all math below is component-wise over the lane batch —
    unpacking once and computing in (B,) scalars keeps the elementwise work
    dense over B instead of over a size-3 minor axis.
    """
    return v[..., 0], v[..., 1], v[..., 2]


def _two_prod(a, b):
    """Error-free f32 product via Dekker/Veltkamp splitting: returns (p, err)
    with a*b == p + err exactly (round-to-nearest, no overflow). The splitter
    is 2^ceil(24/2) + 1 for the 24-bit f32 mantissa."""
    split = jnp.float32(4097.0)
    ca = a * split
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = b * split
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def _edge_fn(ax, ay, bx, by):
    """Edge function ax*by - ay*bx with the mesh.rs:236-244 zero fallback:
    where the f32 result rounds to exactly 0, the sign is recovered from the
    error-free residual (the f32 equivalent of the reference's f64 recompute;
    the residual sum is a faithful rounding of the exact value)."""
    p1, e1 = _two_prod(ax, by)
    p2, e2 = _two_prod(ay, bx)
    d = p1 - p2
    # p1 - p2 is exact when d == 0 (Sterbenz), so the residual alone decides.
    # Dekker splitting overflows (a*4097 -> inf, err = nan) for coordinates
    # above ~2^103; keep the plain-f32 zero there instead of propagating nan.
    exact = (e1 - e2)
    exact = jnp.where(jnp.isfinite(exact), exact, jnp.float32(0.0))
    return jnp.where(d == 0.0, exact, d)


def triangle_intersect(o, d, t_max, p0, p1, p2):
    """Watertight intersect; everything broadcasts (mesh.rs:214-260)."""
    return triangle_intersect_c(_unpack(o), _unpack(d), t_max,
                                _unpack(p0), _unpack(p1), _unpack(p2))


def triangle_intersect_c(oc, dc, t_max, p0c, p1c, p2c):
    """Component-triple variant (callers with pre-split SoA buffers)."""
    ox, oy, oz = oc
    dcx, dcy, dcz = dc
    # pick kz = max |d| component (argmax tie-break: first), cyclic kx/ky
    adx, ady, adz = jnp.abs(dcx), jnp.abs(dcy), jnp.abs(dcz)
    is0 = (adx >= ady) & (adx >= adz)
    is1 = ~is0 & (ady >= adz)

    def permute(cx, cy, cz):
        # kz=0 → (y,z,x); kz=1 → (z,x,y); kz=2 → (x,y,z)
        px = jnp.where(is0, cy, jnp.where(is1, cz, cx))
        py = jnp.where(is0, cz, jnp.where(is1, cx, cy))
        pz = jnp.where(is0, cx, jnp.where(is1, cy, cz))
        return px, py, pz

    dx, dy, dz = permute(dcx, dcy, dcz)
    sz = 1.0 / dz
    sx = -dx * sz
    sy = -dy * sz

    def shear(pc):
        px, py, pz = pc
        ptx, pty, ptz = permute(px - ox, py - oy, pz - oz)
        return ptx + sx * ptz, pty + sy * ptz, ptz * sz

    x0, y0, z0 = shear(p0c)
    x1, y1, z1 = shear(p1c)
    x2, y2, z2 = shear(p2c)

    e0 = _edge_fn(x1, y1, x2, y2)
    e1 = _edge_fn(x2, y2, x0, y0)
    e2 = _edge_fn(x0, y0, x1, y1)

    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    nonzero = det != 0.0
    inv_det = 1.0 / jnp.where(nonzero, det, 1.0)
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    t = t_scaled * inv_det
    # conservative error bound on t (PBRT 3.9.6)
    max_zt = jnp.maximum(jnp.maximum(jnp.abs(z0), jnp.abs(z1)), jnp.abs(z2))
    max_xt = jnp.maximum(jnp.maximum(jnp.abs(x0), jnp.abs(x1)), jnp.abs(x2))
    max_yt = jnp.maximum(jnp.maximum(jnp.abs(y0), jnp.abs(y1)), jnp.abs(y2))
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_z = gamma(3) * max_zt
    delta_x = gamma(5) * (max_xt + max_zt)
    delta_y = gamma(5) * (max_yt + max_zt)
    delta_e = 2.0 * (gamma(2) * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    delta_t = 3.0 * (gamma(3) * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * \
        jnp.abs(inv_det)

    hit = same_sign & nonzero & (t > delta_t) & (t < t_max)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    return TriHit(hit=hit, t=t, b0=b0, b1=b1, b2=b2)


def triangle_point_error(b0, b1, b2, p0, p1, p2):
    """p and gamma(7)-scaled error bound at barycentric point (PBRT)."""
    p = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    abs_sum = (jnp.abs(b0[..., None] * p0) + jnp.abs(b1[..., None] * p1)
               + jnp.abs(b2[..., None] * p2))
    return p, gamma(7) * abs_sum


def triangle_area(p0, p1, p2):
    return 0.5 * jnp.sqrt(jnp.maximum(length_squared(cross(p1 - p0, p2 - p0)), 0.0))


def triangle_sample(u, p0, p1, p2):
    """Uniform area sample → (p, n_unnormalized_len? , p_error).

    Returns (p, ng, p_error); ng is the (normalized) geometric normal
    following the winding (reference mesh.rs sample)."""
    b = uniform_sample_triangle(u)
    b0 = b[..., 0]
    b1 = b[..., 1]
    b2 = 1.0 - b0 - b1
    p = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    ng = normalize(cross(p1 - p0, p2 - p0))
    abs_sum = (jnp.abs(b0[..., None] * p0) + jnp.abs(b1[..., None] * p1)
               + jnp.abs(b2[..., None] * p2))
    return p, ng, gamma(6) * abs_sum


def triangle_partial_derivs(p0, p1, p2, uv0, uv1, uv2):
    """dpdu/dpdv from the uv parameterization (mesh.rs get_uvs + derivs)."""
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degenerate = jnp.abs(det) < 1e-12
    inv = 1.0 / jnp.where(degenerate, 1.0, det)
    dpdu = (duv12[..., 1, None] * dp02 - duv02[..., 1, None] * dp12) * inv[..., None]
    dpdv = (-duv12[..., 0, None] * dp02 + duv02[..., 0, None] * dp12) * inv[..., None]
    # fall back to an arbitrary frame around the geometric normal
    ng = cross(p2 - p0, p1 - p0)
    from ..core.math import coordinate_system
    fb_u, fb_v = coordinate_system(normalize(ng))
    dpdu = jnp.where(degenerate[..., None], fb_u, dpdu)
    dpdv = jnp.where(degenerate[..., None], fb_v, dpdv)
    return dpdu, dpdv


def triangle_normal_derivs(n0, n1, n2, uv0, uv1, uv2):
    """Shading-normal derivatives dndu/dndv from vertex normals — the same
    2x2 uv solve as the position derivatives (reference mesh.rs shading
    dndu/dndv). Zero on a degenerate uv parameterization."""
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dn02 = n0 - n2
    dn12 = n1 - n2
    det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degenerate = jnp.abs(det) < 1e-12
    inv = 1.0 / jnp.where(degenerate, 1.0, det)
    dndu = (duv12[..., 1, None] * dn02 - duv02[..., 1, None] * dn12) * inv[..., None]
    dndv = (-duv12[..., 0, None] * dn02 + duv02[..., 0, None] * dn12) * inv[..., None]
    z = jnp.zeros_like(dndu)
    return (jnp.where(degenerate[..., None], z, dndu),
            jnp.where(degenerate[..., None], z, dndv))
