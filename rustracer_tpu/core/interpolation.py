"""Catmull-Rom spline + Fourier-series machinery (batched).

Reference: rustracer-core/src/interpolation.rs — catmull_rom_weights
(:108-156), integrate_catmull_rom (:158-186), invert_catmull_rom (:188-260),
fourier (:262-276), sample_fourier (:279-352), sample_catmull_rom_2d (:6-106).

Wavefront differences: every routine is batched over lanes; the reference's
"iterate until |F-u|<1e-6" Newton-bisection loops become fixed-trip
`lax.fori_loop`s (converged lanes keep refining harmlessly); the cosine
recurrence cos(k φ) becomes a dense (B, m_max) cos evaluation — one
elementwise op instead of a serial dependency chain.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PI = np.pi
INV_2_PI = 1.0 / (2.0 * np.pi)
NEWTON_ITERS = 30


def find_interval(nodes, x):
    """Largest i with nodes[..., i] <= x, clamped to [0, N-2].

    Reference lib.rs find_interval (bisection); vectorized count of
    nodes <= x. `nodes` may be (N,) shared or (..., N) per-lane rows.
    """
    n = nodes.shape[-1]
    le = nodes <= x[..., None]
    return jnp.clip(jnp.sum(le.astype(jnp.int32), axis=-1) - 1, 0, n - 2)


def _node_at(nodes, i):
    """nodes[..., i] with broadcasting for shared (N,) node vectors."""
    if nodes.ndim == 1:
        return nodes[i]
    nodes_b = jnp.broadcast_to(nodes, i.shape + nodes.shape[-1:])
    return jnp.take_along_axis(nodes_b, i[..., None], axis=-1)[..., 0]


def catmull_rom_weights(nodes, x):
    """Batched catmull_rom_weights (interpolation.rs:108-156).

    nodes: (N,) shared or (..., N) per-lane monotone knot rows.
    x: (...,) query points.
    Returns (offset (...,) int32, weights (..., 4), valid (...,) bool).
    Out-of-bounds lanes get valid=False and zero weights.
    """
    nodes = jnp.asarray(nodes, jnp.float32)
    n = nodes.shape[-1]
    valid = (x >= nodes[..., 0]) & (x <= nodes[..., -1])
    idx = find_interval(nodes, x)
    x0 = _node_at(nodes, idx)
    x1 = _node_at(nodes, idx + 1)
    t = (x - x0) / jnp.maximum(x1 - x0, 1e-20)
    t2 = t * t
    t3 = t2 * t

    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2

    # first node weight
    nodes_m1 = _node_at(nodes, jnp.maximum(idx - 1, 0))
    w0_in = (t3 - 2.0 * t2 + t) * (x1 - x0) / jnp.maximum(x1 - nodes_m1, 1e-20)
    w0_edge = t3 - 2.0 * t2 + t
    has_prev = idx > 0
    w0 = jnp.where(has_prev, -w0_in, 0.0)
    w1 = jnp.where(has_prev, w1, w1 - w0_edge)
    w2 = w2 + jnp.where(has_prev, w0_in, w0_edge)

    # last node weight
    nodes_p2 = _node_at(nodes, jnp.minimum(idx + 2, n - 1))
    w3_in = (t3 - t2) * (x1 - x0) / jnp.maximum(nodes_p2 - x0, 1e-20)
    w3_edge = t3 - t2
    has_next = idx + 2 < n
    w1 = w1 - jnp.where(has_next, w3_in, w3_edge)
    w2 = w2 + jnp.where(has_next, 0.0, w3_edge)
    w3 = jnp.where(has_next, w3_in, 0.0)

    weights = jnp.stack([w0, w1, w2, w3], axis=-1)
    weights = jnp.where(valid[..., None], weights, 0.0)
    return (idx - 1).astype(jnp.int32), weights, valid


def integrate_catmull_rom_np(x, values):
    """Host-side CDF build (interpolation.rs:158-186). values (..., N) numpy.

    Returns (cdf (..., N), total (...,)).
    """
    x = np.asarray(x, np.float32)
    v = np.asarray(values, np.float32)
    n = x.shape[-1]
    cdf = np.zeros(v.shape, np.float32)
    f0 = v[..., :-1]
    f1 = v[..., 1:]
    width = x[1:] - x[:-1]
    d0 = np.empty_like(f0)
    d0[..., 1:] = width[1:] * (f1[..., 1:] - v[..., :-2]) / (x[2:] - x[:-2])
    d0[..., 0] = f1[..., 0] - f0[..., 0]
    d1 = np.empty_like(f0)
    d1[..., :-1] = width[:-1] * (v[..., 2:] - f0[..., :-1]) / (x[2:] - x[:-2])
    d1[..., -1] = f1[..., -1] - f0[..., -1]
    seg = ((d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5) * width
    cdf[..., 1:] = np.cumsum(seg, axis=-1)
    return cdf, cdf[..., -1]


def _segment_derivs(f_m1, f0, f1, f2, x_m1, x0, x1, x2, has_prev, has_next):
    width = x1 - x0
    d0 = jnp.where(has_prev,
                   width * (f1 - f_m1) / jnp.maximum(x1 - x_m1, 1e-20),
                   f1 - f0)
    d1 = jnp.where(has_next,
                   width * (f2 - f0) / jnp.maximum(x2 - x0, 1e-20),
                   f1 - f0)
    return d0, d1


def _invert_spline_segment(f0, f1, d0, d1, u):
    """Newton-bisection for t in [0,1] with ∫spline(t)=u
    (interpolation.rs:63-106). Returns (t, fhat)."""
    t0 = jnp.where(jnp.abs(f0 - f1) > 1e-12,
                   (f0 - jnp.sqrt(jnp.maximum(
                       0.0, f0 * f0 + 2.0 * u * (f1 - f0)))) /
                   jnp.where(jnp.abs(f0 - f1) > 1e-12, f0 - f1, 1.0),
                   u / jnp.maximum(f0, 1e-20))

    def body(_, carry):
        t, a, b = carry
        t = jnp.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2.0 * d0 - d1) + f1 - f0 +
            t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0) +
                                   t * (d0 + d1 + 2.0 * (f0 - f1))))
        lo = Fhat - u < 0.0
        a = jnp.where(lo, t, a)
        b = jnp.where(lo, b, t)
        t = t - (Fhat - u) / jnp.where(jnp.abs(fhat) > 1e-20, fhat, 1.0)
        return t, a, b

    t, a, b = jax.lax.fori_loop(
        0, NEWTON_ITERS, body,
        (t0, jnp.zeros_like(u), jnp.ones_like(u)))
    t = jnp.clip(t, a, b)
    fhat = f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0) +
                               t * (d0 + d1 + 2.0 * (f0 - f1))))
    return t, fhat


def invert_catmull_rom(x, values, u):
    """Batched invert_catmull_rom (interpolation.rs:188-260).

    x, values: (N,) knot positions / monotone values. u: (...,).
    """
    x = jnp.asarray(x, jnp.float32)
    values = jnp.asarray(values, jnp.float32)
    n = x.shape[0]
    below = u <= values[0]
    above = u >= values[-1]
    i = find_interval(values, u)
    x0, x1 = x[i], x[i + 1]
    f0, f1 = values[i], values[i + 1]
    d0, d1 = _segment_derivs(
        values[jnp.maximum(i - 1, 0)], f0, f1,
        values[jnp.minimum(i + 2, n - 1)],
        x[jnp.maximum(i - 1, 0)], x0, x1, x[jnp.minimum(i + 2, n - 1)],
        i > 0, i + 2 < n)

    # Newton-bisection on the spline value itself (not its integral)
    def body(_, carry):
        t, a, b = carry
        t = jnp.where((t > a) & (t < b), t, 0.5 * (a + b))
        t2 = t * t
        t3 = t2 * t
        Fhat = ((2.0 * t3 - 3.0 * t2 + 1.0) * f0 +
                (-2.0 * t3 + 3.0 * t2) * f1 +
                (t3 - 2.0 * t2 + t) * d0 + (t3 - t2) * d1)
        fhat = ((6.0 * t2 - 6.0 * t) * f0 + (-6.0 * t2 + 6.0 * t) * f1 +
                (3.0 * t2 - 4.0 * t + 1.0) * d0 + (3.0 * t2 - 2.0 * t) * d1)
        lo = Fhat - u < 0.0
        a = jnp.where(lo, t, a)
        b = jnp.where(lo, b, t)
        t = t - (Fhat - u) / jnp.where(jnp.abs(fhat) > 1e-20, fhat, 1.0)
        return t, a, b

    t, a, b = jax.lax.fori_loop(
        0, NEWTON_ITERS, body,
        (jnp.full_like(u, 0.5), jnp.zeros_like(u), jnp.ones_like(u)))
    t = jnp.clip(t, a, b)
    out = x0 + t * (x1 - x0)
    return jnp.where(below, x[0], jnp.where(above, x[-1], out))


def fourier(ak, cos_phi):
    """Evaluate sum_k ak[k] cos(k φ) (interpolation.rs:262-276).

    ak: (..., M) — zero-padded coefficients. cos_phi: (...,).
    """
    m = ak.shape[-1]
    phi = jnp.arccos(jnp.clip(cos_phi, -1.0, 1.0))
    k = jnp.arange(m, dtype=jnp.float32)
    return jnp.sum(ak * jnp.cos(phi[..., None] * k), axis=-1)


def sample_fourier(ak, u):
    """Batched sample_fourier (interpolation.rs:279-352).

    ak: (..., M) zero-padded luminance coefficients; u: (...,) in [0,1).
    Returns (Y, pdf, phi).
    """
    m = ak.shape[-1]
    flip = u >= 0.5
    u = jnp.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    a0 = ak[..., 0]
    k = jnp.arange(m, dtype=jnp.float32)
    k_recip = jnp.where(k > 0, 1.0 / jnp.maximum(k, 1.0), 0.0)

    def eval_Ff(phi):
        kphi = phi[..., None] * k
        F = a0 * phi + jnp.sum(ak * k_recip * jnp.sin(kphi), axis=-1)
        f = jnp.sum(ak * jnp.cos(kphi), axis=-1)
        return F - u * a0 * PI, f

    def body(_, carry):
        phi, a, b = carry
        F, f = eval_Ff(phi)
        hi = F > 0.0
        b = jnp.where(hi, phi, b)
        a = jnp.where(hi, a, phi)
        phi = phi - F / jnp.where(jnp.abs(f) > 1e-20, f, 1.0)
        phi = jnp.where((phi > a) & (phi < b), phi, 0.5 * (a + b))
        return phi, a, b

    phi, _, _ = jax.lax.fori_loop(
        0, NEWTON_ITERS, body,
        (jnp.full_like(u, 0.5 * PI), jnp.zeros_like(u),
         jnp.full_like(u, PI)))
    _, f = eval_Ff(phi)
    phi = jnp.where(flip, 2.0 * PI - phi, phi)
    pdf = INV_2_PI * f / jnp.maximum(a0, 1e-20)
    pdf = jnp.where(a0 > 0, pdf, 0.0)
    return f, pdf, phi


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u):
    """Batched sample_catmull_rom_2d (interpolation.rs:6-106).

    nodes1, nodes2: (N,) shared or (..., N) per-lane knot rows.
    values, cdf: (..., N1, N2) — per-lane tables (leading dims broadcast
      against alpha/u) or (N1, N2) shared.
    alpha: (...,) conditioning variable; u: (...,) uniform sample.
    Returns (x, fval, pdf).
    """
    nodes2 = jnp.asarray(nodes2, jnp.float32)
    n2 = nodes2.shape[-1]
    off, w, valid = catmull_rom_weights(nodes1, alpha)

    def interp(tab, idx):
        # tab (..., N1, N2); idx (...,) int — gather tab[off+i, idx] weighted
        out = 0.0
        for i in range(4):
            row = jnp.clip(off + i, 0, tab.shape[-2] - 1)
            out = out + w[..., i] * jnp.take_along_axis(
                jnp.take_along_axis(
                    tab, jnp.broadcast_to(
                        row[..., None, None],
                        row.shape + (1, tab.shape[-1])), axis=-2)[..., 0, :],
                idx[..., None], axis=-1)[..., 0]
        return out

    maximum = interp(cdf, jnp.full(alpha.shape, n2 - 1, jnp.int32))
    u = u * maximum

    # invert the interpolated cdf: binary search over columns
    def cdf_at(j):
        return interp(cdf, j)

    lo = jnp.zeros(alpha.shape, jnp.int32)
    hi = jnp.full(alpha.shape, n2 - 1, jnp.int32)

    def bs_body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        le = cdf_at(mid) <= u
        lo = jnp.where(le, mid, lo)
        hi = jnp.where(le, hi, mid)
        return lo, hi

    n_steps = int(np.ceil(np.log2(max(2, n2)))) + 1
    lo, hi = jax.lax.fori_loop(0, n_steps, bs_body, (lo, hi))
    idx = jnp.clip(lo, 0, n2 - 2)

    f0 = interp(values, idx)
    f1 = interp(values, idx + 1)
    x0 = _node_at(nodes2, idx)
    x1 = _node_at(nodes2, idx + 1)
    width = x1 - x0
    u_seg = (u - cdf_at(idx)) / jnp.maximum(width, 1e-20)

    f_m1 = interp(values, jnp.maximum(idx - 1, 0))
    f_p2 = interp(values, jnp.minimum(idx + 2, n2 - 1))
    d0, d1 = _segment_derivs(
        f_m1, f0, f1, f_p2,
        _node_at(nodes2, jnp.maximum(idx - 1, 0)), x0, x1,
        _node_at(nodes2, jnp.minimum(idx + 2, n2 - 1)),
        idx > 0, idx + 2 < n2)

    t, fhat = _invert_spline_segment(f0, f1, d0, d1, u_seg)
    x = x0 + width * t
    pdf = fhat / jnp.maximum(maximum, 1e-20)
    bad = ~valid | (maximum <= 0)
    return (jnp.where(bad, 0.0, x), jnp.where(bad, 0.0, fhat),
            jnp.where(bad, 0.0, pdf))
