"""MIP-mapped image lookups, batched gathers.

Reference: rustracer-core/src/mipmap.rs (pyramid build, trilinear `triangle`
and EWA `lookup_diff`, wrap modes) + blockedarray.rs. Here the pyramid is a
static list of (H, W, C) arrays; lookups are gather-based and differentiable
w.r.t. the texel data. The reference's 8x8 BlockedArray tiling is dropped —
XLA's device layout handles locality.

EWA is approximated by multi-tap anisotropic filtering along the major axis
(fixed tap count, vectorizes; same spirit, bounded cost) — the reference's
variable-extent EWA loop is hostile to fixed-shape SPMD.
"""
from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP = 0, 1, 2


def build_pyramid(img: np.ndarray):
    """Host-side pyramid build (mipmap.rs resampling, simplified to 2x box
    after rounding up to pow2 dimensions with edge-clamp resample)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    h2 = 1 << int(np.ceil(np.log2(max(1, h))))
    w2 = 1 << int(np.ceil(np.log2(max(1, w))))
    if (h2, w2) != (h, w):
        # bilinear resample to pow2
        yi = np.linspace(0, h - 1, h2)
        xi = np.linspace(0, w - 1, w2)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        img = ((1 - fy) * (1 - fx) * img[y0][:, x0]
               + (1 - fy) * fx * img[y0][:, x1]
               + fy * (1 - fx) * img[y1][:, x0]
               + fy * fx * img[y1][:, x1]).astype(np.float32)
        h, w = h2, w2
    levels = [img]
    while h > 1 or w > 1:
        nh, nw = max(1, h // 2), max(1, w // 2)
        cur = levels[-1][: nh * 2, : nw * 2]
        if h == 1:
            nxt = 0.5 * (cur[:, 0::2] + cur[:, 1::2])
        elif w == 1:
            nxt = 0.5 * (cur[0::2] + cur[1::2])
        else:
            nxt = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
        levels.append(nxt.astype(np.float32))
        h, w = nh, nw
    return levels


def _texel(level, s_i, t_i, wrap):
    """Gather texel (s_i, t_i) from one level with wrap handling."""
    h, w = level.shape[0], level.shape[1]
    if wrap == WRAP_REPEAT:
        s_i = jnp.mod(s_i, w)
        t_i = jnp.mod(t_i, h)
        mask = None
    elif wrap == WRAP_CLAMP:
        s_i = jnp.clip(s_i, 0, w - 1)
        t_i = jnp.clip(t_i, 0, h - 1)
        mask = None
    else:  # black
        mask = (s_i >= 0) & (s_i < w) & (t_i >= 0) & (t_i < h)
        s_i = jnp.clip(s_i, 0, w - 1)
        t_i = jnp.clip(t_i, 0, h - 1)
    v = level[t_i, s_i]
    if mask is not None:
        v = jnp.where(mask[..., None], v, 0.0)
    return v


def bilerp_level(level, st, wrap):
    """Bilinear lookup at continuous st in [0,1)^2 on one level."""
    h, w = level.shape[0], level.shape[1]
    s = st[..., 0] * w - 0.5
    t = st[..., 1] * h - 0.5
    s0 = jnp.floor(s).astype(jnp.int32)
    t0 = jnp.floor(t).astype(jnp.int32)
    ds = (s - s0)[..., None]
    dt = (t - t0)[..., None]
    v00 = _texel(level, s0, t0, wrap)
    v10 = _texel(level, s0 + 1, t0, wrap)
    v01 = _texel(level, s0, t0 + 1, wrap)
    v11 = _texel(level, s0 + 1, t0 + 1, wrap)
    return (1 - ds) * (1 - dt) * v00 + ds * (1 - dt) * v10 + \
        (1 - ds) * dt * v01 + ds * dt * v11


def lookup_trilinear(pyramid, st, width, wrap=WRAP_REPEAT, _count=True):
    """Trilinear (isotropic) lookup (mipmap.rs lookup/triangle).

    pyramid: list of (H, W, C) jnp arrays; st (B, 2); width (B,).

    Lookup counters (mipmap.rs:17-19): every SPMD lane executes the lookup,
    so the lane count IS the executed-work count; EWA's internal taps are
    not double-counted (_count=False)."""
    if _count:
        from ..utils import stats as S
        S.device_count("Textures/Trilinear lookups",
                       int(np.prod(st.shape[:-1])))
    n = len(pyramid)
    level = n - 1 + jnp.log2(jnp.maximum(width, 1e-8))
    level = jnp.clip(level, 0.0, n - 1)
    l0 = jnp.floor(level).astype(jnp.int32)
    dl = (level - l0)[..., None]
    # gather both levels for every lane: evaluate all levels masked (static
    # level count; each level's bilerp is cheap relative to the gathers)
    out0 = jnp.zeros(st.shape[:-1] + (pyramid[0].shape[-1],), pyramid[0].dtype)
    out1 = jnp.zeros_like(out0)
    for i, lv in enumerate(pyramid):
        v = bilerp_level(lv, st, wrap)
        out0 = jnp.where((l0 == i)[..., None], v, out0)
        out1 = jnp.where((jnp.minimum(l0 + 1, n - 1) == i)[..., None], v, out1)
    return (1.0 - dl) * out0 + dl * out1


def lookup_ewa(pyramid, st, dst0, dst1, max_anisotropy=8.0, wrap=WRAP_REPEAT,
               n_taps=8):
    """Anisotropic lookup approximating EWA (mipmap.rs lookup_diff):
    pick the level from the MINOR axis (sharper than trilinear), then take
    `n_taps` trilinear taps spread along the MAJOR axis, each weighted by the
    reference's Gaussian ellipse kernel `exp(-2 r^2) - exp(-2)` evaluated at
    its position on the major axis (mipmap.rs ewa() weight table). This is
    the variable-extent EWA loop collapsed to a fixed, SPMD-friendly tap
    count: the minor-axis extent is handled by the per-tap trilinear
    footprint, the major-axis extent and kernel shape by the weighted taps.
    Anisotropy clamping matches the reference: the minor axis is scaled up so
    major/minor <= max_anisotropy (mipmap.rs lookup_diff ellipse clamp).
    """
    from ..utils import stats as S
    S.device_count("Textures/EWA lookups", int(np.prod(st.shape[:-1])))
    len0 = jnp.sqrt(jnp.maximum(jnp.sum(dst0 * dst0, -1), 1e-24))
    len1 = jnp.sqrt(jnp.maximum(jnp.sum(dst1 * dst1, -1), 1e-24))
    major_is_0 = len0 >= len1
    major_len = jnp.where(major_is_0, len0, len1)
    minor_len = jnp.where(major_is_0, len1, len0)
    major = jnp.where(major_is_0[..., None], dst0, dst1)
    # clamp anisotropy (scale the minor axis up, as the reference does)
    minor_len = jnp.maximum(minor_len, major_len / max_anisotropy)
    # NOTE: a tap-axis vectorization (one (n_taps, B)-index gather per
    # level) was measured slower on the previous accelerator via the atlas
    # variant of the same restructure (fusion loss beat the gather-merging
    # win); not yet measured on H100, so the scalar tap loop stays.
    out = jnp.zeros(st.shape[:-1] + (pyramid[0].shape[-1],), pyramid[0].dtype)
    wsum = 0.0
    for i in range(n_taps):
        a = (i + 0.5) / n_taps - 0.5          # position in (-0.5, 0.5)
        r2 = (2.0 * a) ** 2                   # ellipse radius^2 in (0, 1)
        w = float(np.exp(-2.0 * r2) - np.exp(-2.0))
        out = out + w * lookup_trilinear(pyramid, st + a * major, minor_len,
                                         wrap, _count=False)
        wsum += w
    return out / wsum


def lookup_ewa_exact(pyramid, st, dst0, dst1, max_anisotropy=16.0,
                     wrap=WRAP_REPEAT, n_taps=128):
    """True-EWA escape hatch (mipmap.rs:227-410 lookup_diff + ewa): the
    reference's variable-extent texel loop as a MASKED FIXED-TRIP loop of
    `n_taps` texels over the ellipse bounding box, per lane, at the single
    level rounded from the minor-axis lod (the reference lerps two levels;
    the rounded level keeps the tap budget bounded and is within the oracle
    tolerance in tests/test_ewa.py at anisotropy 16+).

    Selected by textures when maxanisotropy > 8 — boxes up to n_taps
    texels are covered exactly; taps beyond the cap are truncated. The
    ellipse bounding box at the minor-chosen level is ~(2*aniso+3) x ~5
    texels, so n_taps=128 covers anisotropy up to ~16:1 fully (the
    anisotropy clamp bounds it there by default). Costs n_taps gathers per
    pyramid level, so it is the opt-in high-quality path, not the default:
    the 8-tap Gaussian approximation (lookup_ewa) stays the fast path at
    maxanisotropy <= 8.
    """
    from ..utils import stats as S
    S.device_count("Textures/EWA lookups", int(np.prod(st.shape[:-1])))
    len0 = jnp.sqrt(jnp.maximum(jnp.sum(dst0 * dst0, -1), 1e-24))
    len1 = jnp.sqrt(jnp.maximum(jnp.sum(dst1 * dst1, -1), 1e-24))
    swap = len1 > len0
    major = jnp.where(swap[..., None], dst1, dst0)
    minor = jnp.where(swap[..., None], dst0, dst1)
    major_len = jnp.maximum(len0, len1)
    minor_len = jnp.minimum(len0, len1)
    # anisotropy clamp: scale the minor axis UP (mipmap.rs lookup_diff)
    scale = jnp.where(minor_len * max_anisotropy < major_len,
                      major_len / (minor_len * max_anisotropy + 1e-24), 1.0)
    minor = minor * scale[..., None]
    minor_len = minor_len * scale

    n = len(pyramid)
    lod = jnp.clip(n - 1 + jnp.log2(jnp.maximum(minor_len, 1e-8)),
                   0.0, n - 1)
    li = jnp.round(lod).astype(jnp.int32)

    C_ = pyramid[0].shape[-1]
    out = jnp.zeros(st.shape[:-1] + (C_,), pyramid[0].dtype)
    wsum = jnp.zeros(st.shape[:-1], jnp.float32)
    e2 = float(np.exp(-2.0))
    for i, lv in enumerate(pyramid):
        h, w = lv.shape[0], lv.shape[1]
        at = li == i
        d0 = major * jnp.asarray([w, h], jnp.float32)
        d1 = minor * jnp.asarray([w, h], jnp.float32)
        px = st[..., 0] * w - 0.5
        py = st[..., 1] * h - 0.5
        # implicit ellipse coefficients (mipmap.rs:330-356)
        A = d0[..., 1] ** 2 + d1[..., 1] ** 2 + 1.0
        Bc = -2.0 * (d0[..., 0] * d0[..., 1] + d1[..., 0] * d1[..., 1])
        Cc = d0[..., 0] ** 2 + d1[..., 0] ** 2 + 1.0
        invF = 1.0 / jnp.maximum(A * Cc - Bc * Bc * 0.25, 1e-12)
        A, Bc, Cc = A * invF, Bc * invF, Cc * invF
        det = jnp.maximum(-Bc * Bc + 4.0 * A * Cc, 1e-12)
        u_r = jnp.sqrt(jnp.maximum(Cc * det, 0.0)) * 2.0 / det
        v_r = jnp.sqrt(jnp.maximum(A * det, 0.0)) * 2.0 / det
        s0 = jnp.ceil(px - u_r).astype(jnp.int32)
        s1 = jnp.floor(px + u_r).astype(jnp.int32)
        t0 = jnp.ceil(py - v_r).astype(jnp.int32)
        t1 = jnp.floor(py + v_r).astype(jnp.int32)
        wu = jnp.maximum(s1 - s0 + 1, 1)
        wv = jnp.maximum(t1 - t0 + 1, 1)

        # fori_loop, not a python unroll: n_taps x n_levels unrolled
        # gathers made the XLA compile explode (minutes on 2 CPUs)
        def tap(k, carry):
            out, wsum = carry
            ss = s0 + k % wu
            tt = t0 + k // wu
            du = ss.astype(jnp.float32) - px
            dv = tt.astype(jnp.float32) - py
            r2 = A * du * du + Bc * du * dv + Cc * dv * dv
            ok = at & (k < wu * wv) & (r2 < 1.0)
            wgt = jnp.where(ok, jnp.exp(-2.0 * r2) - e2, 0.0)
            return (out + wgt[..., None] * _texel(lv, ss, tt, wrap),
                    wsum + wgt)

        out, wsum = jax.lax.fori_loop(0, n_taps, tap, (out, wsum))
    # degenerate footprints (no tap landed inside): fall back to bilerp at
    # the lane's level
    fb = jnp.zeros_like(out)
    for i, lv in enumerate(pyramid):
        fb = jnp.where((li == i)[..., None], bilerp_level(lv, st, wrap), fb)
    good = wsum > 1e-9
    return jnp.where(good[..., None],
                     out / jnp.maximum(wsum, 1e-9)[..., None], fb)
