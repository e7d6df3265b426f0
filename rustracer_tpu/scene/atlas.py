"""Shared mip atlas: every imagemap pyramid in one flat texel array.

Reference: texture/imagemap.rs:21-99 keeps a per-file MIPMap cache, and each
ImageTexture evaluates its own MIPMap. Under static SPMD shapes that design
costs one full-wavefront lookup per DISTINCT imagemap per bounce. The
atlas flips the dispatch:
all pyramids are packed into one (T, 3) texel array with static per-(image,
level) offset metadata, the per-lane image id becomes a gather index, and
the material set evaluates ONE EWA lookup per parameter SLOT (Kd, Ks, ...)
for the whole wavefront — lookup count independent of how many imagemap
materials the scene has. Exactly the pattern already proven on the baked
alpha atlas (scene/tables.py _alpha_at).

Split of responsibilities:
- metadata (offsets, sizes, level counts, per-registration mapping/scale/
  wrap) is host-built numpy, static under jit;
- the texel array itself is CONCATENATED FROM ctx.textures["images"] at
  trace time, so the pyramids stay the single differentiable source of
  truth (gradient tests differentiate w.r.t. level-0 texels) — XLA hoists
  the concat out of the sampling loop.

A "registration" is one ImageTexture instance: (image id, UV scale/offset,
wrap mode, scalar scale). Several registrations may share an image.
"""
from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..ops.mipmap import WRAP_BLACK, WRAP_CLAMP, WRAP_REPEAT


def build_atlas_meta(images: List[list]):
    """Static atlas metadata for a list of pyramids (lists of (H,W,C)
    arrays). → dict(atlas_meta (I, Lmax, 3) int32 [offset, w, h] (pad
    levels repeat the coarsest), atlas_levels (I,) int32, atlas_total)."""
    if not images:
        return None
    I = len(images)
    lmax = max(len(p) for p in images)
    meta = np.zeros((I, lmax, 3), np.int64)
    levels = np.zeros((I,), np.int32)
    off = 0
    for i, pyr in enumerate(images):
        levels[i] = len(pyr)
        for li, lv in enumerate(pyr):
            h, w = np.asarray(lv).shape[:2]
            meta[i, li] = (off, w, h)
            off += h * w
        meta[i, len(pyr):] = meta[i, len(pyr) - 1]
    assert off < (1 << 31), "atlas exceeds int32 addressing"
    return dict(atlas_meta=meta.astype(np.int32), atlas_levels=levels,
                atlas_total=int(off))


def atlas_texels(images: List[list]):
    """Traced flat (T, 3) texel array in build_atlas_meta's offset order.
    1-channel levels are replicated to 3 so every registration gathers
    (B, 3) rows."""
    parts = []
    for pyr in images:
        for lv in pyr:
            lv = jnp.asarray(lv, jnp.float32)
            if lv.ndim == 2:
                lv = lv[..., None]
            if lv.shape[-1] == 1:
                lv = jnp.repeat(lv, 3, axis=-1)
            parts.append(lv.reshape(-1, 3))
    return jnp.concatenate(parts, axis=0)


def atlas_quad_texels(images: List[list]):
    """(T, 12) rows [v00 v10 v01 v11]: each texel row carries its 2x2
    bilerp neighborhood with REPEAT wrapping baked in via jnp.roll, so a
    bilerp costs ONE row gather instead of four texel gathers (an EWA
    lookup drops from 64 to 16 gathers; whether that pays on H100 is ROADMAP
    queue 1 item 6). Valid only when every registration uses WRAP_REPEAT
    (see all_repeat); rows are linear views of the pyramids, so texel
    cotangents sum over the 4 duplicates and gradients stay exact."""
    parts = []
    for pyr in images:
        for lv in pyr:
            lv = jnp.asarray(lv, jnp.float32)
            if lv.ndim == 2:
                lv = lv[..., None]
            if lv.shape[-1] == 1:
                lv = jnp.repeat(lv, 3, axis=-1)
            r = jnp.roll(lv, -1, axis=1)       # (s+1, t), wrapped
            d = jnp.roll(lv, -1, axis=0)       # (s, t+1)
            rd = jnp.roll(r, -1, axis=0)       # (s+1, t+1)
            parts.append(jnp.concatenate([lv, r, d, rd], -1).reshape(-1, 12))
    return jnp.concatenate(parts, axis=0)


def all_repeat(regs):
    """Static check: every registration wraps REPEAT (the PBRT default) —
    the precondition for the quad-texel fast path."""
    return bool(np.all(np.asarray(regs["reg_wrap"]) == WRAP_REPEAT))


def build_registrations(texs):
    """Static per-registration tables for a list of ImageTexture
    instances. → dict(reg_img (K,), reg_map (K,4) [su,sv,du,dv], reg_scale
    (K,), reg_wrap (K,))."""
    K = len(texs)
    if K == 0:
        return None
    reg_img = np.zeros((K,), np.int32)
    reg_map = np.zeros((K, 4), np.float32)
    reg_scale = np.zeros((K,), np.float32)
    reg_wrap = np.zeros((K,), np.int32)
    for k, t in enumerate(texs):
        reg_img[k] = t.image_id
        m = t.mapping
        reg_map[k] = (m.su, m.sv, m.du, m.dv)
        reg_scale[k] = float(t.scale)
        reg_wrap[k] = t.wrap
    return dict(reg_img=reg_img, reg_map=reg_map, reg_scale=reg_scale,
                reg_wrap=reg_wrap)


def _texel_at(texels, off, w, h, wrap, s_i, t_i):
    """Per-lane wrapped texel gather from the flat atlas."""
    s_m = jnp.mod(s_i, w)
    t_m = jnp.mod(t_i, h)
    s_c = jnp.clip(s_i, 0, w - 1)
    t_c = jnp.clip(t_i, 0, h - 1)
    rep = wrap == WRAP_REPEAT
    s_f = jnp.where(rep, s_m, s_c)
    t_f = jnp.where(rep, t_m, t_c)
    v = texels[off + t_f * w + s_f]
    inside = (s_i >= 0) & (s_i < w) & (t_i >= 0) & (t_i < h)
    black = (wrap == WRAP_BLACK) & ~inside
    return jnp.where(black[..., None], 0.0, v)


def _bilerp_at(texels, meta, wrap, img, li, st):
    m = meta[img, li]                                  # (B, 3)
    off, w, h = m[..., 0], m[..., 1], m[..., 2]
    s = st[..., 0] * w.astype(jnp.float32) - 0.5
    t = st[..., 1] * h.astype(jnp.float32) - 0.5
    s0 = jnp.floor(s).astype(jnp.int32)
    t0 = jnp.floor(t).astype(jnp.int32)
    ds = (s - s0)[..., None]
    dt = (t - t0)[..., None]
    v00 = _texel_at(texels, off, w, h, wrap, s0, t0)
    v10 = _texel_at(texels, off, w, h, wrap, s0 + 1, t0)
    v01 = _texel_at(texels, off, w, h, wrap, s0, t0 + 1)
    v11 = _texel_at(texels, off, w, h, wrap, s0 + 1, t0 + 1)
    return (1 - ds) * (1 - dt) * v00 + ds * (1 - dt) * v10 + \
        (1 - ds) * dt * v01 + ds * dt * v11


def _bilerp_at_quad(qtexels, meta, img, li, st):
    """One (B, 12) quad-row gather per bilerp (REPEAT wrap baked into the
    rows by atlas_quad_texels); arithmetic matches _bilerp_at exactly."""
    m = meta[img, li]
    off, w, h = m[..., 0], m[..., 1], m[..., 2]
    s = st[..., 0] * w.astype(jnp.float32) - 0.5
    t = st[..., 1] * h.astype(jnp.float32) - 0.5
    s0 = jnp.floor(s).astype(jnp.int32)
    t0 = jnp.floor(t).astype(jnp.int32)
    ds = (s - s0)[..., None]
    dt = (t - t0)[..., None]
    s_f = jnp.mod(s0, w)
    t_f = jnp.mod(t0, h)
    v = qtexels[off + t_f * w + s_f]                   # (B, 12)
    return (1 - ds) * (1 - dt) * v[..., 0:3] + ds * (1 - dt) * v[..., 3:6] \
        + (1 - ds) * dt * v[..., 6:9] + ds * dt * v[..., 9:12]


def atlas_lookup_ewa(texels, meta, levels, regs, reg, si,
                     max_anisotropy=8.0, n_taps=8, quad=False):
    """Per-lane EWA lookup: reg (B,) int32 registration ids (< 0 lanes get
    zeros — callers mask). Same tap scheme as ops/mipmap.lookup_ewa but
    every mip-chain parameter is a gather."""
    from ..utils import stats as S
    S.device_count("Textures/EWA lookups", int(np.prod(si.uv.shape[:-1])))
    r = jnp.maximum(reg, 0)
    img = jnp.asarray(regs["reg_img"])[r]
    m = jnp.asarray(regs["reg_map"])[r]
    wrap = jnp.asarray(regs["reg_wrap"])[r]
    su, sv = m[..., 0], m[..., 1]
    st = jnp.stack([si.uv[..., 0] * su + m[..., 2],
                    si.uv[..., 1] * sv + m[..., 3]], axis=-1)
    dst0 = jnp.stack([si.dudx * su, si.dvdx * sv], axis=-1)
    dst1 = jnp.stack([si.dudy * su, si.dvdy * sv], axis=-1)

    len0 = jnp.sqrt(jnp.maximum(jnp.sum(dst0 * dst0, -1), 1e-24))
    len1 = jnp.sqrt(jnp.maximum(jnp.sum(dst1 * dst1, -1), 1e-24))
    major_is_0 = len0 >= len1
    major_len = jnp.maximum(len0, len1)
    minor_len = jnp.minimum(len0, len1)
    major = jnp.where(major_is_0[..., None], dst0, dst1)
    minor_len = jnp.maximum(minor_len, major_len / max_anisotropy)

    meta_j = jnp.asarray(meta)
    L = jnp.asarray(levels)[img]
    level = (L - 1).astype(jnp.float32) + \
        jnp.log2(jnp.maximum(minor_len, 1e-8))
    level = jnp.clip(level, 0.0, (L - 1).astype(jnp.float32))
    l0 = jnp.floor(level).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, L - 1)
    dl = (level - l0)[..., None]

    # NOTE: a tap-axis vectorization (stack the 8 taps into one
    # (n_taps, B)-index gather per level/corner) was built and measured
    # slower on the previous accelerator — the (T, B, 3) intermediates
    # defeat XLA's fusion of the small per-tap gathers into the surrounding
    # elementwise code. Not yet measured on H100; the scalar tap loop
    # stays.
    out = jnp.zeros(st.shape[:-1] + (3,), jnp.float32)
    wsum = 0.0
    for i in range(n_taps):
        a = (i + 0.5) / n_taps - 0.5
        r2 = (2.0 * a) ** 2
        wgt = float(np.exp(-2.0 * r2) - np.exp(-2.0))
        st_k = st + a * major
        if quad:   # texels is the (T, 12) quad array (all-REPEAT scenes)
            v = (1.0 - dl) * _bilerp_at_quad(texels, meta_j, img, l0, st_k) \
                + dl * _bilerp_at_quad(texels, meta_j, img, l1, st_k)
        else:
            v = (1.0 - dl) * _bilerp_at(texels, meta_j, wrap, img, l0, st_k) \
                + dl * _bilerp_at(texels, meta_j, wrap, img, l1, st_k)
        out = out + wgt * v
        wsum += wgt
    out = out / wsum * jnp.asarray(regs["reg_scale"])[r][..., None]
    return jnp.where((reg >= 0)[..., None], out, 0.0)
