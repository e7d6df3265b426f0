"""Batched lobe-stack BSDF engine.

Reference: rustracer-core/src/bsdf/ (Bsdf + BxDF trait objects, mod.rs:94-251)
and the concrete lobes in lambertian.rs / oren_nayar.rs / fresnel.rs /
microfacet.rs / disney.rs. The wavefront design replaces per-hit arena-
allocated trait objects with a fixed-width SoA "lobe stack": every lane
carries up to MAX_LOBES lobes as (type, params[16]) rows, and f/pdf/sample_f
are branch-free masked evaluations over the set of lobe types that are
statically present in the scene.

Param slot layout (params[..., 16]):
  [0:3]  PA   — primary color (R / T / Rd / base color)
  [3:6]  PB   — secondary color (T, Rs, conductor eta)
  [6:9]  PC   — tertiary color (conductor k, Disney cspec0)
  [9]    s0   — eta (relative IOR)
  [10]   s1   — alpha_x
  [11]   s2   — alpha_y
  [12]   s3   — microfacet distribution code (BECKMANN/TROWBRIDGE/GTR1)
  [13]   s4   — fresnel code (FR_NOOP/FR_DIELECTRIC/FR_CONDUCTOR/FR_DISNEY)
  [14]   s5   — misc (Oren-Nayar A, Disney metallic, retro roughness)
  [15]   s6   — misc (Oren-Nayar B, clearcoat gloss)
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..core.math import (INV_PI, PI, abs_cos_theta, cos_theta, dot,
                         normalize, reflect, refract, same_hemisphere)
from ..core.sampling import cosine_sample_hemisphere
from .fresnel import (FR_CONDUCTOR, FR_DIELECTRIC, FR_DISNEY, FR_NOOP,
                      fr_conductor, fr_dielectric, schlick_fresnel)
from .microfacet import (distribution_d, distribution_g, distribution_g1,
                         distribution_pdf, distribution_sample_wh)

# --- lobe type codes ---
LAMBERTIAN_REFL = 0
OREN_NAYAR = 1
LAMBERTIAN_TRANS = 2
SPECULAR_REFL = 3
SPECULAR_TRANS = 4
FRESNEL_SPECULAR = 5
MICROFACET_REFL = 6
MICROFACET_TRANS = 7
FRESNEL_BLEND = 8
DISNEY_DIFFUSE = 9
DISNEY_RETRO = 10
DISNEY_SHEEN = 11
DISNEY_CLEARCOAT = 12
DISNEY_FAKE_SS = 13
FOURIER = 14
N_LOBE_TYPES = 15

# --- BxDF type flags (bsdf/mod.rs BxDFType) ---
REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
ALL = REFLECTION | TRANSMISSION | DIFFUSE | GLOSSY | SPECULAR

_LOBE_FLAGS = np.zeros(N_LOBE_TYPES, np.int32)
_LOBE_FLAGS[LAMBERTIAN_REFL] = REFLECTION | DIFFUSE
_LOBE_FLAGS[OREN_NAYAR] = REFLECTION | DIFFUSE
_LOBE_FLAGS[LAMBERTIAN_TRANS] = TRANSMISSION | DIFFUSE
_LOBE_FLAGS[SPECULAR_REFL] = REFLECTION | SPECULAR
_LOBE_FLAGS[SPECULAR_TRANS] = TRANSMISSION | SPECULAR
_LOBE_FLAGS[FRESNEL_SPECULAR] = REFLECTION | TRANSMISSION | SPECULAR
_LOBE_FLAGS[MICROFACET_REFL] = REFLECTION | GLOSSY
_LOBE_FLAGS[MICROFACET_TRANS] = TRANSMISSION | GLOSSY
_LOBE_FLAGS[FRESNEL_BLEND] = REFLECTION | GLOSSY
_LOBE_FLAGS[DISNEY_DIFFUSE] = REFLECTION | DIFFUSE
_LOBE_FLAGS[DISNEY_RETRO] = REFLECTION | DIFFUSE
_LOBE_FLAGS[DISNEY_SHEEN] = REFLECTION | DIFFUSE
_LOBE_FLAGS[DISNEY_CLEARCOAT] = REFLECTION | GLOSSY
_LOBE_FLAGS[DISNEY_FAKE_SS] = REFLECTION | DIFFUSE
_LOBE_FLAGS[FOURIER] = REFLECTION | TRANSMISSION | GLOSSY


class LobeStack(NamedTuple):
    """(B, M) lobes per lane. eta is the lane's relative IOR for ray
    differentials / RR (bsdf/mod.rs Bsdf.eta). `fourier` optionally carries
    the scene's stacked FourierTableSet (ops/fourier.py) for FOURIER lobes —
    params[15] is the per-lobe table id."""
    type: jnp.ndarray     # (B, M) int32
    params: jnp.ndarray   # (B, M, 16) float32
    active: jnp.ndarray   # (B, M) bool
    eta: jnp.ndarray      # (B,) float32
    fourier: object = None  # FourierTableSet or None

    @property
    def max_lobes(self):
        return self.type.shape[-1]


def empty_lobes(batch_shape, max_lobes):
    return LobeStack(
        type=jnp.zeros(batch_shape + (max_lobes,), jnp.int32),
        params=jnp.zeros(batch_shape + (max_lobes, 16), jnp.float32),
        active=jnp.zeros(batch_shape + (max_lobes,), bool),
        eta=jnp.ones(batch_shape, jnp.float32),
    )


def lobe_flags(ltype):
    return jnp.asarray(_LOBE_FLAGS)[ltype]


def _matches(ltype, flags):
    """BxDF::matches — all of the lobe's flags within the query flags."""
    lf = lobe_flags(ltype)
    return (lf & flags) == lf


def _is_specular(ltype):
    return (lobe_flags(ltype) & SPECULAR) != 0


# ---------------------------------------------------------------------------
# fresnel dispatch
# ---------------------------------------------------------------------------

def _fresnel(code, cos_i, params):
    """→ (..., 3) reflectance by fresnel code (fresnel.rs Fresnel trait)."""
    s0 = params[..., 9]
    pb = params[..., 3:6]
    pc = params[..., 6:9]
    batch = jnp.broadcast_shapes(cos_i.shape, code.shape, s0.shape)
    out = jnp.ones(batch + (3,), jnp.float32)
    fd = fr_dielectric(cos_i, jnp.ones_like(s0), s0)[..., None]
    out = jnp.where((code == FR_DIELECTRIC)[..., None], fd, out)
    fc = fr_conductor(cos_i, jnp.ones_like(pb), pb, pc)
    out = jnp.where((code == FR_CONDUCTOR)[..., None], fc, out)
    # Disney fresnel: lerp(metallic, dielectric, schlick to cspec0)
    metallic = params[..., 14]
    fdisney = (1.0 - metallic)[..., None] * fd + \
        metallic[..., None] * schlick_fresnel(jnp.abs(cos_i)[..., None], pc)
    out = jnp.where((code == FR_DISNEY)[..., None], fdisney, out)
    return out


# ---------------------------------------------------------------------------
# per-type f / pdf in shading space (wo, wi (..., 3); params (..., 16))
# ---------------------------------------------------------------------------

def _schlick_weight(c):
    m = jnp.clip(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _f_one_type(T, params, wo, wi):
    """Non-specular f for lobe type T (a static int). Returns (..., 3)."""
    pa = params[..., 0:3]
    same = same_hemisphere(wo, wi)
    aci = abs_cos_theta(wi)
    aco = abs_cos_theta(wo)
    degenerate = (aci < 1e-8) | (aco < 1e-8)

    if T == LAMBERTIAN_REFL:
        return jnp.where(same[..., None], pa * INV_PI, 0.0)
    if T == LAMBERTIAN_TRANS:
        return jnp.where(same[..., None], 0.0, pa * INV_PI)
    if T == OREN_NAYAR:
        A = params[..., 14]
        B = params[..., 15]
        sin_ti = jnp.sqrt(jnp.maximum(0.0, 1.0 - wi[..., 2] ** 2))
        sin_to = jnp.sqrt(jnp.maximum(0.0, 1.0 - wo[..., 2] ** 2))
        # max(0, cos(phi_i - phi_o))
        safe = lambda s: jnp.where(s < 1e-4, 1.0, s)
        cpi, spi = wi[..., 0] / safe(sin_ti), wi[..., 1] / safe(sin_ti)
        cpo, spo = wo[..., 0] / safe(sin_to), wo[..., 1] / safe(sin_to)
        d_cos = jnp.maximum(0.0, cpi * cpo + spi * spo)
        d_cos = jnp.where((sin_ti < 1e-4) | (sin_to < 1e-4), 0.0, d_cos)
        big = jnp.maximum(aci, aco)
        small = jnp.minimum(aci, aco)
        sin_alpha = jnp.sqrt(jnp.maximum(0.0, 1.0 - big * big))
        tan_beta = jnp.sqrt(jnp.maximum(0.0, 1.0 - small * small)) / \
            jnp.maximum(small, 1e-8)
        f = pa * INV_PI * (A + B * d_cos * sin_alpha * tan_beta)[..., None]
        return jnp.where(same[..., None], f, 0.0)
    if T == MICROFACET_REFL:
        wh = wi + wo
        wh_len = jnp.sqrt(jnp.maximum(jnp.sum(wh * wh, -1), 1e-20))
        wh_n = wh / wh_len[..., None]
        ax, ay, dist = params[..., 10], params[..., 11], params[..., 12].astype(jnp.int32)
        F = _fresnel(params[..., 13].astype(jnp.int32), dot(wi, wh_n), params)
        d = distribution_d(dist, wh_n, ax, ay)
        g = distribution_g(dist, wo, wi, ax, ay)
        f = pa * F * (d * g / jnp.maximum(4.0 * aci * aco, 1e-8))[..., None]
        ok = same & ~degenerate & (wh_len > 1e-8)
        return jnp.where(ok[..., None], f, 0.0)
    if T == MICROFACET_TRANS:
        eta = params[..., 9]
        # transmission: eta by side of surface wo is on
        e = jnp.where(cos_theta(wo) > 0.0, eta, 1.0 / eta)
        wh = wo + wi * e[..., None]
        wh = normalize(wh)
        wh = jnp.where((cos_theta(wh) < 0.0)[..., None], -wh, wh)
        ax, ay, dist = params[..., 10], params[..., 11], params[..., 12].astype(jnp.int32)
        wo_dot = dot(wo, wh)
        wi_dot = dot(wi, wh)
        ok = (~same) & ~degenerate & (wo_dot * wi_dot < 0.0)
        F = fr_dielectric(wo_dot, jnp.ones_like(e), eta)
        d = distribution_d(dist, wh, ax, ay)
        g = distribution_g(dist, wo, wi, ax, ay)
        denom = (wo_dot + e * wi_dot) ** 2
        factor = 1.0 / jnp.maximum(e, 1e-8)  # radiance transport scaling
        f = pa * ((1.0 - F) * d * g * e * e * jnp.abs(wi_dot) * jnp.abs(wo_dot)
                  * factor * factor /
                  jnp.maximum(aci * aco * denom, 1e-10))[..., None]
        return jnp.where(ok[..., None], f, 0.0)
    if T == FRESNEL_BLEND:
        rd = pa
        rs = params[..., 3:6]
        ax, ay = params[..., 10], params[..., 11]
        dist = params[..., 12].astype(jnp.int32)
        diffuse = (28.0 / (23.0 * PI)) * rd * (1.0 - rs) * \
            ((1.0 - (1.0 - 0.5 * aci) ** 5) *
             (1.0 - (1.0 - 0.5 * aco) ** 5))[..., None]
        wh = wi + wo
        wh_len2 = jnp.sum(wh * wh, -1)
        wh_n = wh * (1.0 / jnp.sqrt(jnp.maximum(wh_len2, 1e-20)))[..., None]
        d = distribution_d(dist, wh_n, ax, ay)
        f_schlick = rs + _schlick_weight(dot(wi, wh_n))[..., None] * (1.0 - rs)
        spec = (d / jnp.maximum(4.0 * jnp.abs(dot(wi, wh_n)) *
                                jnp.maximum(aci, aco), 1e-8))[..., None] * f_schlick
        ok = same & ~degenerate & (wh_len2 > 1e-16)
        return jnp.where(ok[..., None], diffuse + jnp.where(
            (wh_len2 > 1e-16)[..., None], spec, 0.0), 0.0)
    if T == DISNEY_DIFFUSE:
        fo = _schlick_weight(aco)
        fi = _schlick_weight(aci)
        f = pa * (INV_PI * (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi))[..., None]
        return jnp.where(same[..., None], f, 0.0)
    if T == DISNEY_RETRO:
        wh = wi + wo
        wh_len2 = jnp.sum(wh * wh, -1)
        wh_n = wh * (1.0 / jnp.sqrt(jnp.maximum(wh_len2, 1e-20)))[..., None]
        cos_d = dot(wi, wh_n)
        rough = params[..., 14]
        rr = 2.0 * rough * cos_d * cos_d
        fo = _schlick_weight(aco)
        fi = _schlick_weight(aci)
        f = pa * (INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0)))[..., None]
        return jnp.where((same & (wh_len2 > 1e-16))[..., None], f, 0.0)
    if T == DISNEY_SHEEN:
        wh = wi + wo
        wh_len2 = jnp.sum(wh * wh, -1)
        wh_n = wh * (1.0 / jnp.sqrt(jnp.maximum(wh_len2, 1e-20)))[..., None]
        f = pa * _schlick_weight(dot(wi, wh_n))[..., None]
        return jnp.where((same & (wh_len2 > 1e-16))[..., None], f, 0.0)
    if T == DISNEY_CLEARCOAT:
        weight = pa[..., 0]
        gloss = params[..., 15]
        wh = wi + wo
        wh_len2 = jnp.sum(wh * wh, -1)
        wh_n = wh * (1.0 / jnp.sqrt(jnp.maximum(wh_len2, 1e-20)))[..., None]
        from .microfacet import GTR1
        dr = distribution_d(jnp.full(weight.shape, GTR1, jnp.int32), wh_n,
                            gloss, gloss)
        fr = schlick_fresnel(jnp.abs(dot(wi, wh_n)), 0.04)
        # fixed 0.25 alpha GGX shadowing (disney.rs clearcoat)
        from .microfacet import TROWBRIDGE
        gr = distribution_g(jnp.full(weight.shape, TROWBRIDGE, jnp.int32),
                            wo, wi, jnp.full_like(weight, 0.25),
                            jnp.full_like(weight, 0.25))
        v = weight * gr * fr * dr * 0.25
        f = jnp.stack([v, v, v], axis=-1)
        return jnp.where((same & (wh_len2 > 1e-16))[..., None], f, 0.0)
    if T == DISNEY_FAKE_SS:
        # Hanrahan-Krueger approximation (disney.rs DisneyFakeSS)
        wh = wi + wo
        wh_len2 = jnp.sum(wh * wh, -1)
        wh_n = wh * (1.0 / jnp.sqrt(jnp.maximum(wh_len2, 1e-20)))[..., None]
        cos_d = dot(wi, wh_n)
        rough = params[..., 14]
        fss90 = cos_d * cos_d * rough
        fo = _schlick_weight(aco)
        fi = _schlick_weight(aci)
        fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
        ss = 1.25 * (fss * (1.0 / jnp.maximum(aco + aci, 1e-4) - 0.5) + 0.5)
        f = pa * (INV_PI * ss)[..., None]
        return jnp.where((same & (wh_len2 > 1e-16))[..., None], f, 0.0)
    # specular types contribute 0 to f
    return jnp.zeros(wo.shape[:-1] + (3,), jnp.float32)


def _pdf_one_type(T, params, wo, wi):
    same = same_hemisphere(wo, wi)
    aci = abs_cos_theta(wi)
    cos_pdf = aci * INV_PI

    if T in (LAMBERTIAN_REFL, OREN_NAYAR, DISNEY_DIFFUSE, DISNEY_RETRO,
             DISNEY_SHEEN, DISNEY_FAKE_SS):
        return jnp.where(same, cos_pdf, 0.0)
    if T == LAMBERTIAN_TRANS:
        return jnp.where(same, 0.0, cos_pdf)
    if T in (MICROFACET_REFL, DISNEY_CLEARCOAT):
        wh = normalize(wo + wi)
        ax, ay = params[..., 10], params[..., 11]
        if T == DISNEY_CLEARCOAT:
            from .microfacet import GTR1
            dist = jnp.full(ax.shape, GTR1, jnp.int32)
            ax = ay = params[..., 15]
        else:
            dist = params[..., 12].astype(jnp.int32)
        pdf = distribution_pdf(dist, wo, wh, ax, ay) / \
            jnp.maximum(4.0 * jnp.abs(dot(wo, wh)), 1e-8)
        return jnp.where(same, pdf, 0.0)
    if T == MICROFACET_TRANS:
        eta = params[..., 9]
        e = jnp.where(cos_theta(wo) > 0.0, eta, 1.0 / eta)
        wh = normalize(wo + wi * e[..., None])
        ax, ay, dist = params[..., 10], params[..., 11], params[..., 12].astype(jnp.int32)
        wo_dot = dot(wo, wh)
        wi_dot = dot(wi, wh)
        ok = (~same) & (wo_dot * wi_dot < 0.0)
        denom = (wo_dot + e * wi_dot) ** 2
        dwh_dwi = jnp.abs(e * e * wi_dot) / jnp.maximum(denom, 1e-10)
        pdf = distribution_pdf(dist, wo, wh, ax, ay) * dwh_dwi
        return jnp.where(ok, pdf, 0.0)
    if T == FRESNEL_BLEND:
        wh = normalize(wo + wi)
        ax, ay = params[..., 10], params[..., 11]
        dist = params[..., 12].astype(jnp.int32)
        pdf_wh = distribution_pdf(dist, wo, wh, ax, ay) / \
            jnp.maximum(4.0 * jnp.abs(dot(wo, wh)), 1e-8)
        return jnp.where(same, 0.5 * (cos_pdf + pdf_wh), 0.0)
    # specular: pdf 0
    return jnp.zeros(wo.shape[:-1], jnp.float32)


def eval_f(ltype, params, wo, wi, types_present: Sequence[int], fourier=None):
    """Masked dispatch of _f_one_type over the statically-present types."""
    batch = jnp.broadcast_shapes(ltype.shape, wo.shape[:-1])
    out = jnp.zeros(batch + (3,), jnp.float32)
    for T in types_present:
        if T in (SPECULAR_REFL, SPECULAR_TRANS, FRESNEL_SPECULAR):
            continue
        if T == FOURIER:
            if fourier is None:
                continue  # no table set bound: treat FOURIER lobes as black
            from .fourier import fourier_f
            tid = params[..., 15].astype(jnp.int32)
            val = fourier_f(fourier, tid,
                            jnp.broadcast_to(wo, batch + (3,)),
                            jnp.broadcast_to(wi, batch + (3,)))
        else:
            val = _f_one_type(T, params, wo, wi)
        out = jnp.where((ltype == T)[..., None], val, out)
    return out


def eval_pdf(ltype, params, wo, wi, types_present: Sequence[int],
             fourier=None):
    batch = jnp.broadcast_shapes(ltype.shape, wo.shape[:-1])
    out = jnp.zeros(batch, jnp.float32)
    for T in types_present:
        if T in (SPECULAR_REFL, SPECULAR_TRANS, FRESNEL_SPECULAR):
            continue
        if T == FOURIER:
            if fourier is None:
                continue  # no table set bound: pdf 0
            from .fourier import fourier_pdf
            tid = params[..., 15].astype(jnp.int32)
            val = fourier_pdf(fourier, tid,
                              jnp.broadcast_to(wo, batch + (3,)),
                              jnp.broadcast_to(wi, batch + (3,)))
        else:
            val = _pdf_one_type(T, params, wo, wi)
        out = jnp.where(ltype == T, val, out)
    return out


# ---------------------------------------------------------------------------
# per-type sampling (chosen lobe per lane: ltype (B,), params (B,16))
# ---------------------------------------------------------------------------

def sample_lobe(ltype, params, wo, u, types_present: Sequence[int],
                fourier=None):
    """Sample wi from the chosen lobe. Returns (wi, specular_f, specular_pdf,
    is_specular). For non-specular lobes, f/pdf must be computed by summing
    over all lobes afterwards (bsdf/mod.rs:138-251 semantics)."""
    B3 = wo.shape
    wi = jnp.zeros(B3, jnp.float32)
    spec_f = jnp.zeros(B3, jnp.float32)
    spec_pdf = jnp.zeros(wo.shape[:-1], jnp.float32)

    cos_o = cos_theta(wo)
    aco = abs_cos_theta(wo)
    pa = params[..., 0:3]
    pb = params[..., 3:6]
    eta = params[..., 9]

    diffuse_like = [T for T in types_present if T in (
        LAMBERTIAN_REFL, OREN_NAYAR, DISNEY_DIFFUSE, DISNEY_RETRO,
        DISNEY_SHEEN, DISNEY_FAKE_SS)]
    if diffuse_like:
        w = cosine_sample_hemisphere(u)
        w = jnp.where((cos_o < 0.0)[..., None],
                      w * jnp.asarray([1.0, 1.0, -1.0]), w)
        mask = jnp.zeros(wo.shape[:-1], bool)
        for T in diffuse_like:
            mask = mask | (ltype == T)
        wi = jnp.where(mask[..., None], w, wi)
    if LAMBERTIAN_TRANS in types_present:
        w = cosine_sample_hemisphere(u)
        w = jnp.where((cos_o > 0.0)[..., None],
                      w * jnp.asarray([1.0, 1.0, -1.0]), w)
        wi = jnp.where((ltype == LAMBERTIAN_TRANS)[..., None], w, wi)
    if MICROFACET_REFL in types_present or DISNEY_CLEARCOAT in types_present:
        ax, ay = params[..., 10], params[..., 11]
        dist = params[..., 12].astype(jnp.int32)
        if DISNEY_CLEARCOAT in types_present:
            from .microfacet import GTR1
            is_cc = ltype == DISNEY_CLEARCOAT
            ax = jnp.where(is_cc, params[..., 15], ax)
            ay = jnp.where(is_cc, params[..., 15], ay)
            dist = jnp.where(is_cc, GTR1, dist)
        wh = distribution_sample_wh(dist, wo, u, ax, ay)
        w = reflect(wo, wh)
        mask = (ltype == MICROFACET_REFL) | (ltype == DISNEY_CLEARCOAT)
        wi = jnp.where(mask[..., None], w, wi)
    if MICROFACET_TRANS in types_present:
        ax, ay = params[..., 10], params[..., 11]
        dist = params[..., 12].astype(jnp.int32)
        wh = distribution_sample_wh(dist, wo, u, ax, ay)
        e = jnp.where(cos_o > 0.0, 1.0 / eta, eta)
        wh_f = jnp.where((dot(wo, wh) < 0.0)[..., None], -wh, wh)
        w, ok = refract(wo, wh_f, e)
        w = jnp.where(ok[..., None], w, -wo)  # TIR → degenerate, f will be 0
        wi = jnp.where((ltype == MICROFACET_TRANS)[..., None], w, wi)
    if FOURIER in types_present and fourier is not None:
        from .fourier import fourier_sample_f
        tid = params[..., 15].astype(jnp.int32)
        w_f, _, _ = fourier_sample_f(fourier, tid, wo, u)
        wi = jnp.where((ltype == FOURIER)[..., None], w_f, wi)
    if FRESNEL_BLEND in types_present:
        ax, ay = params[..., 10], params[..., 11]
        dist = params[..., 12].astype(jnp.int32)
        use_spec = u[..., 0] >= 0.5
        u_d = jnp.stack([jnp.minimum(2.0 * u[..., 0], 0.9999), u[..., 1]], -1)
        u_s = jnp.stack([jnp.minimum(2.0 * (u[..., 0] - 0.5), 0.9999), u[..., 1]], -1)
        w_d = cosine_sample_hemisphere(u_d)
        w_d = jnp.where((cos_o < 0.0)[..., None], w_d * jnp.asarray([1., 1., -1.]), w_d)
        wh = distribution_sample_wh(dist, wo, u_s, ax, ay)
        w_s = reflect(wo, wh)
        w = jnp.where(use_spec[..., None], w_s, w_d)
        wi = jnp.where((ltype == FRESNEL_BLEND)[..., None], w, wi)

    # --- specular lobes: compute wi, f, pdf directly ---
    if SPECULAR_REFL in types_present:
        w = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
        F = _fresnel(params[..., 13].astype(jnp.int32), cos_theta(w), params)
        f = pa * F / jnp.maximum(abs_cos_theta(w), 1e-8)[..., None]
        m = ltype == SPECULAR_REFL
        wi = jnp.where(m[..., None], w, wi)
        spec_f = jnp.where(m[..., None], f, spec_f)
        spec_pdf = jnp.where(m, 1.0, spec_pdf)
    if SPECULAR_TRANS in types_present:
        entering = cos_o > 0.0
        e = jnp.where(entering, 1.0 / eta, eta)
        n = jnp.where(entering[..., None],
                      jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), wo.shape),
                      jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), wo.shape))
        w, ok = refract(wo, n, e)
        F = fr_dielectric(cos_o, jnp.ones_like(eta), eta)
        ft = pa * (1.0 - F)[..., None] * (e * e)[..., None]
        f = ft / jnp.maximum(abs_cos_theta(w), 1e-8)[..., None]
        f = jnp.where(ok[..., None], f, 0.0)
        m = ltype == SPECULAR_TRANS
        wi = jnp.where(m[..., None], w, wi)
        spec_f = jnp.where(m[..., None], f, spec_f)
        spec_pdf = jnp.where(m, 1.0, spec_pdf)
    if FRESNEL_SPECULAR in types_present:
        F = fr_dielectric(cos_o, jnp.ones_like(eta), eta)
        pick_refl = u[..., 0] < F
        # reflection part
        w_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
        f_r = pa * F[..., None] / jnp.maximum(abs_cos_theta(w_r), 1e-8)[..., None]
        # transmission part
        entering = cos_o > 0.0
        e = jnp.where(entering, 1.0 / eta, eta)
        n = jnp.where(entering[..., None],
                      jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), wo.shape),
                      jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), wo.shape))
        w_t, ok = refract(wo, n, e)
        f_t = pb * ((1.0 - F) * e * e)[..., None] / \
            jnp.maximum(abs_cos_theta(w_t), 1e-8)[..., None]
        f_t = jnp.where(ok[..., None], f_t, 0.0)
        w = jnp.where(pick_refl[..., None], w_r, w_t)
        f = jnp.where(pick_refl[..., None], f_r, f_t)
        pdf = jnp.where(pick_refl, F, 1.0 - F)
        m = ltype == FRESNEL_SPECULAR
        wi = jnp.where(m[..., None], w, wi)
        spec_f = jnp.where(m[..., None], f, spec_f)
        spec_pdf = jnp.where(m, pdf, spec_pdf)

    is_spec = _is_specular(ltype)
    return wi, spec_f, spec_pdf, is_spec


# ---------------------------------------------------------------------------
# Bsdf-level API (world-space wrappers; bsdf/mod.rs:94-251)
# ---------------------------------------------------------------------------

def world_to_local(ss, ts, ns, v):
    return jnp.stack([dot(v, ss), dot(v, ts), dot(v, ns)], axis=-1)


def local_to_world(ss, ts, ns, v):
    return v[..., 0, None] * ss + v[..., 1, None] * ts + v[..., 2, None] * ns


def num_matching(lobes: LobeStack, flags):
    m = lobes.active & _matches(lobes.type, flags)
    return jnp.sum(m.astype(jnp.int32), axis=-1)


def bsdf_f(lobes: LobeStack, si, wo_w, wi_w, types_present, flags=ALL):
    """Sum matching lobes' f (bsdf/mod.rs:94-111) with the geometric-normal
    reflect/transmit test."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = world_to_local(si.ss, si.ts, si.ns, wi_w)
    ok_wo = jnp.abs(wo[..., 2]) > 1e-8
    reflect_w = dot(wi_w, si.n) * dot(wo_w, si.n) > 0.0
    lf = lobe_flags(lobes.type)
    hemi_ok = jnp.where(reflect_w[..., None], (lf & REFLECTION) != 0,
                        (lf & TRANSMISSION) != 0)
    m = lobes.active & _matches(lobes.type, flags) & hemi_ok
    f = eval_f(lobes.type, lobes.params, wo[..., None, :], wi[..., None, :],
               types_present, fourier=lobes.fourier)
    f = jnp.where(m[..., None], f, 0.0)
    return jnp.where(ok_wo[..., None], jnp.sum(f, axis=-2), 0.0)


def bsdf_pdf(lobes: LobeStack, si, wo_w, wi_w, types_present, flags=ALL):
    """Average matching lobes' pdf (bsdf/mod.rs pdf)."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = world_to_local(si.ss, si.ts, si.ns, wi_w)
    ok_wo = jnp.abs(wo[..., 2]) > 1e-8
    m = lobes.active & _matches(lobes.type, flags)
    pdf = eval_pdf(lobes.type, lobes.params, wo[..., None, :], wi[..., None, :],
                   types_present, fourier=lobes.fourier)
    pdf = jnp.where(m, pdf, 0.0)
    n = jnp.sum(m.astype(jnp.int32), axis=-1)
    total = jnp.sum(pdf, axis=-1)
    out = total / jnp.maximum(n.astype(jnp.float32), 1.0)
    return jnp.where(ok_wo & (n > 0), out, 0.0)


def specular_reflect_branch(lobes: LobeStack, si, wo_w, types_present):
    """Deterministic perfect-mirror branch for Whitted/direct-lighting
    (whitted.rs:87-97 via integrator/mod.rs specular_reflection): the
    contribution weight is Σ over active specular-reflective lobes of
    R·Fresnel — exactly f·|cosθ|/pdf for a single matching specular lobe
    with pdf 1. Returns (wi_world, weight (B,3), present (B,))."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)
    cos_i = cos_theta(wi)
    weight = jnp.zeros(wo.shape[:-1] + (3,), jnp.float32)
    present = jnp.zeros(wo.shape[:-1], bool)
    for T in (SPECULAR_REFL, FRESNEL_SPECULAR):
        if T not in types_present:
            continue
        m = lobes.active & (lobes.type == T)
        p = lobes.params
        pa = p[..., 0:3]
        if T == SPECULAR_REFL:
            F = _fresnel(p[..., 13].astype(jnp.int32),
                         cos_i[..., None] * jnp.ones_like(p[..., 9]), p)
        else:
            F = fr_dielectric(cos_i[..., None] * jnp.ones_like(p[..., 9]),
                              jnp.ones_like(p[..., 9]), p[..., 9])[..., None]
        weight = weight + jnp.sum(jnp.where(m[..., None], pa * F, 0.0),
                                  axis=-2)
        present = present | jnp.any(m, axis=-1)
    ok = jnp.abs(wo[..., 2]) > 1e-8
    return wi_w, jnp.where((present & ok)[..., None], weight, 0.0), \
        present & ok


def specular_transmit_branch(lobes: LobeStack, si, wo_w, types_present):
    """Deterministic refraction branch (integrator/mod.rs
    specular_transmission): weight = Σ T·(1−F)·η² over active specular-
    transmissive lobes; total internal reflection zeroes the branch."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    cos_o = cos_theta(wo)
    entering = cos_o > 0.0
    weight = jnp.zeros(wo.shape[:-1] + (3,), jnp.float32)
    present = jnp.zeros(wo.shape[:-1], bool)
    # the lane's eta (one transmissive lobe per lane in practice)
    eta = lobes.eta
    e = jnp.where(entering, 1.0 / eta, eta)
    n = jnp.where(entering[..., None],
                  jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), wo.shape),
                  jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), wo.shape))
    wi, refr_ok = refract(wo, n, e)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)
    F = fr_dielectric(cos_o, jnp.ones_like(eta), eta)
    scale = ((1.0 - F) * e * e)[..., None]
    for T in (SPECULAR_TRANS, FRESNEL_SPECULAR):
        if T not in types_present:
            continue
        m = lobes.active & (lobes.type == T)
        p = lobes.params
        kt = p[..., 0:3] if T == SPECULAR_TRANS else p[..., 3:6]
        weight = weight + jnp.sum(jnp.where(m[..., None], kt, 0.0), axis=-2)
        present = present | jnp.any(m, axis=-1)
    ok = present & refr_ok & (jnp.abs(wo[..., 2]) > 1e-8)
    return wi_w, jnp.where(ok[..., None], weight * scale, 0.0), ok


def bsdf_sample_f(lobes: LobeStack, si, wo_w, u_lobe, u2, types_present,
                  flags=ALL):
    """Sample a direction (bsdf/mod.rs:138-251).

    Returns (wi_w, f (B,3), pdf (B,), sampled_flags (B,) int32, valid (B,)).
    """
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    m = lobes.active & _matches(lobes.type, flags)
    n_match = jnp.sum(m.astype(jnp.int32), axis=-1)
    any_match = n_match > 0

    # pick the k-th matching lobe, k = floor(u_lobe * n_match)
    k = jnp.minimum((u_lobe * n_match.astype(jnp.float32)).astype(jnp.int32),
                    jnp.maximum(n_match - 1, 0))
    cum = jnp.cumsum(m.astype(jnp.int32), axis=-1) - 1   # rank of each lobe
    is_chosen = m & (cum == k[..., None])
    chosen_idx = jnp.argmax(is_chosen, axis=-1)
    ct = jnp.take_along_axis(lobes.type, chosen_idx[..., None], axis=-1)[..., 0]
    cp = jnp.take_along_axis(lobes.params, chosen_idx[..., None, None],
                             axis=-2)[..., 0, :]

    # remap u_lobe to [0,1) within the chosen cell (zerotwosequence reuse trick)
    u_re = u_lobe * n_match.astype(jnp.float32) - k.astype(jnp.float32)
    u = jnp.stack([jnp.where(_is_specular(ct), u2[..., 0],
                             jnp.minimum(u2[..., 0], 0.99999)),
                   u2[..., 1]], axis=-1)

    wi, spec_f, spec_pdf, is_spec = sample_lobe(ct, cp, wo, u, types_present,
                                                fourier=lobes.fourier)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)

    # non-specular: f sums all lobes (with hemisphere test), pdf averages
    f_all = bsdf_f(lobes, si, wo_w, wi_w, types_present, flags)
    pdf_all = bsdf_pdf(lobes, si, wo_w, wi_w, types_present, flags)
    # chosen lobe's own pdf is already included in pdf_all's average

    f = jnp.where(is_spec[..., None], spec_f, f_all)
    pdf = jnp.where(is_spec, spec_pdf / jnp.maximum(n_match.astype(jnp.float32), 1.0),
                    pdf_all)
    ok_wo = jnp.abs(wo[..., 2]) > 1e-8
    valid = any_match & ok_wo & (pdf > 0.0)
    sampled_flags = lobe_flags(ct)
    return wi_w, jnp.where(valid[..., None], f, 0.0), \
        jnp.where(valid, pdf, 0.0), sampled_flags, valid
