"""FourierBSDF: measured layered materials in a Spline×Fourier basis.

Reference: rustracer-core/src/bsdf/fourier.rs (FourierBSDFTable::read
:340-420, f :44-110, sample_f :112-212, pdf :214-270). The .bsdf binary
format is Jakob et al. 2014's layerlab output ("SCATFUN\\x01" header).

Wavefront design: the ragged per-(muI,muO)-pair coefficient lists stay in
one flat array (densifying to (N,N,3,m_max) would explode memory for real
tables); evaluation gathers the 4x4 Catmull-Rom neighborhood's coefficient
runs with masked fixed-width (m_pad) gathers and evaluates the cosine series
as one dense (B, m_pad) elementwise op. Multiple tables in a scene are padded to a
common shape and stacked along a leading table axis, indexed per lane.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.interpolation import (catmull_rom_weights, fourier,
                                  integrate_catmull_rom_np,
                                  sample_catmull_rom_2d, sample_fourier)

PI = np.pi
INV_2_PI = 1.0 / (2.0 * np.pi)


class FourierTableSet(NamedTuple):
    """Stacked .bsdf tables (leading axis T = number of tables).

    Layout matches fourier.rs FourierBSDFTable: pair index = oo * n_mu + oi;
    a0/cdf are (T, N_o, N_i); coefficients for pair p live at
    a_flat[a_offset[p] + c * m[p] + k] for channel c, order k < m[p].
    """
    mu: jnp.ndarray        # (T, N) float32, zenith cosine knots
    a_flat: jnp.ndarray    # (T, NC) float32, ragged coefficient storage
    a_offset: jnp.ndarray  # (T, N*N) int32
    m: jnp.ndarray         # (T, N*N) int32 per-pair order
    a0: jnp.ndarray        # (T, N, N) float32 luminance k=0 coefficients
    cdf: jnp.ndarray       # (T, N, N) float32
    eta: jnp.ndarray       # (T,) float32
    n_channels: jnp.ndarray  # (T,) int32 (1 or 3)
    k_pad: jnp.ndarray     # (m_pad,) zeros — carries the static gather width

    @property
    def n_mu(self):
        return self.mu.shape[-1]

    @property
    def m_pad(self):
        """Static max Fourier order across tables (gather width)."""
        return self.k_pad.shape[-1]


def read_bsdf_table(path: str) -> dict:
    """Parse a .bsdf file → numpy dict (fourier.rs:340-420)."""
    with open(path, "rb") as f:
        header = f.read(8)
        if header != b"SCATFUN\x01":
            raise ValueError(f"BSDF file {path!r} has an invalid header")
        ints = struct.unpack("<9I", f.read(36))
        (flags, n_mu, n_coeffs, m_max, n_channels, n_bases,
         _n_meta, _n_params, _n_param_values) = ints
        eta, _a0, _a1, _u0, _u1 = struct.unpack("<5f", f.read(20))
        if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
            raise ValueError(f"Unsupported BSDF file {path!r}")
        mu = np.frombuffer(f.read(4 * n_mu), "<f4")
        cdf = np.frombuffer(f.read(4 * n_mu * n_mu), "<f4")
        off_len = np.frombuffer(f.read(8 * n_mu * n_mu), "<u4")
        a = np.frombuffer(f.read(4 * n_coeffs), "<f4")
    a_offset = off_len[0::2].astype(np.int32)
    m = off_len[1::2].astype(np.int32)
    a0 = np.where(m > 0, a[np.minimum(a_offset, len(a) - 1)], 0.0)
    return dict(mu=mu.copy(), cdf=cdf.reshape(n_mu, n_mu).copy(),
                a=a.copy(), a_offset=a_offset, m=m,
                a0=a0.reshape(n_mu, n_mu).astype(np.float32),
                eta=float(eta), m_max=int(m_max),
                n_channels=int(n_channels))


def write_bsdf_table(path: str, mu, a, a_offset, m, cdf, eta=1.0,
                     n_channels=3):
    """Write a .bsdf file in the reference's format (for tests/tools)."""
    mu = np.asarray(mu, np.float32)
    a = np.asarray(a, np.float32)
    a_offset = np.asarray(a_offset, np.uint32)
    m = np.asarray(m, np.uint32)
    cdf = np.asarray(cdf, np.float32).reshape(-1)
    n_mu = mu.size
    m_max = int(m.max()) if m.size else 0
    off_len = np.empty(2 * n_mu * n_mu, np.uint32)
    off_len[0::2] = a_offset
    off_len[1::2] = m
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9I", 1, n_mu, a.size, m_max, n_channels, 1,
                            0, 0, 0))
        f.write(struct.pack("<5f", eta, 0.0, 0.0, 0.0, 0.0))
        f.write(mu.astype("<f4").tobytes())
        f.write(cdf.astype("<f4").tobytes())
        f.write(off_len.astype("<u4").tobytes())
        f.write(a.astype("<f4").tobytes())


def make_lambertian_table(kd=(0.5, 0.5, 0.5), n_mu=16):
    """Synthesize a table for f = kd/π (analytic test fixture).

    The series is constant in φ, so only k=0 is nonzero, with
    a0_Y(muI, muO) = Y(kd)/π * |muI| (the stored coefficients absorb the
    1/|muI| scale applied at eval; fourier.rs:91).
    """
    kd = np.asarray(kd, np.float32)
    # table Y channel then R then B (fourier.rs:101-106: G is reconstructed)
    y = 0.212671 * kd[0] + 0.715160 * kd[1] + 0.072169 * kd[2]
    # mu spans [-1, 1]; reflection side only has energy for muI*muO<0
    # (wo and -wi on same side of surface ⇒ muI = -wi.z has opposite sign
    #  of wi.z). A lambertian reflector scatters wi into the hemisphere
    #  opposite wo's side... In table terms, pairs with muI*muO < 0 carry
    #  the reflection energy (fourier.rs f: scale has no hemisphere test;
    #  the table itself is zero where there is no transport).
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    n = n_mu
    a = []
    a_offset = np.zeros(n * n, np.int32)
    m = np.zeros(n * n, np.int32)
    vals_y = np.zeros((n, n), np.float32)
    for oo in range(n):
        for oi in range(n):
            pair = oo * n + oi
            mui, muo = mu[oi], mu[oo]
            refl = mui * muo < 0.0  # opposite raw sides ⇒ reflection
            if refl:
                ay = y / PI * abs(mui)
                ar = kd[0] / PI * abs(mui)
                ab = kd[2] / PI * abs(mui)
                a_offset[pair] = len(a)
                m[pair] = 1
                a += [ay, ar, ab]
                vals_y[oo, oi] = ay
            else:
                a_offset[pair] = len(a)
                m[pair] = 0
    # cdf over muI rows for each muO: plain ∫a0 dmu (the 2π azimuth factor
    # is applied by the pdf routine, fourier.rs:258-262)
    cdf, _ = integrate_catmull_rom_np(mu, vals_y)
    return dict(mu=mu, cdf=cdf.astype(np.float32),
                a=np.asarray(a, np.float32),
                a_offset=a_offset, m=m, a0=vals_y, eta=1.0, m_max=1,
                n_channels=3)


def make_table_set(tables) -> FourierTableSet:
    """Pad + stack loaded table dicts into one pytree."""
    if not tables:
        return None
    n = max(t["mu"].size for t in tables)
    nc = max(t["a"].size for t in tables)
    m_pad = max(max(1, t["m_max"]) for t in tables)
    T = len(tables)

    def pad_mu(mu):
        # pad by repeating the last knot (keeps monotone non-decreasing;
        # catmull_rom_weights clamps inside, weights for repeats are 0-width)
        out = np.full(n, mu[-1] + 1e-3, np.float32)
        out[:mu.size] = mu
        for i in range(mu.size, n):
            out[i] = out[i - 1] + 1e-3
        return out

    mu = np.stack([pad_mu(t["mu"]) for t in tables])
    a_flat = np.zeros((T, nc), np.float32)
    a_offset = np.zeros((T, n * n), np.int32)
    m = np.zeros((T, n * n), np.int32)
    a0 = np.zeros((T, n, n), np.float32)
    cdf = np.zeros((T, n, n), np.float32)
    eta = np.ones(T, np.float32)
    nch = np.ones(T, np.int32)
    for ti, t in enumerate(tables):
        sz = t["mu"].size
        a_flat[ti, :t["a"].size] = t["a"]
        ao = t["a_offset"].reshape(sz, sz)
        mm = t["m"].reshape(sz, sz)
        a_offset[ti].reshape(n, n)[:sz, :sz] = ao
        m[ti].reshape(n, n)[:sz, :sz] = mm
        a0[ti, :sz, :sz] = t["a0"]
        cdf[ti, :sz, :sz] = t["cdf"]
        # padded cdf columns must stay at the row maximum so sampling
        # never lands in the pad region; padded ROWS repeat the last real
        # row so clipped Catmull-Rom taps (oo + b beyond the real grid)
        # see the boundary distribution instead of zeros, keeping the pdf
        # consistent with the sampler near the mu boundary
        if sz < n:
            cdf[ti, :sz, sz:] = t["cdf"][:, -1:]
            cdf[ti, sz:, :sz] = t["cdf"][-1:, :]
            cdf[ti, sz:, sz:] = t["cdf"][-1, -1]
        eta[ti] = t["eta"]
        nch[ti] = t["n_channels"]
    ts = FourierTableSet(
        mu=jnp.asarray(mu), a_flat=jnp.asarray(a_flat),
        a_offset=jnp.asarray(a_offset), m=jnp.asarray(m),
        a0=jnp.asarray(a0), cdf=jnp.asarray(cdf), eta=jnp.asarray(eta),
        n_channels=jnp.asarray(nch),
        k_pad=jnp.zeros(int(m_pad), jnp.float32))
    return ts


def _gather_ak(ts: FourierTableSet, tid, oi, oo, wi_w, wo_w):
    """Accumulate the 4x4 weighted coefficient runs → ak (..., 3, m_pad).

    tid/oi/oo: (...,) table id and Catmull-Rom offsets; wi_w/wo_w: (..., 4)
    weights. Channels: [Y, R, B] as stored (fourier.rs:101).
    """
    n = ts.n_mu
    m_pad = ts.m_pad
    k = jnp.arange(m_pad, dtype=jnp.int32)
    ak = jnp.zeros(tid.shape + (3, m_pad), jnp.float32)
    a_off_t = ts.a_offset[tid]     # (..., N*N)
    m_t = ts.m[tid]
    nc_flat = ts.a_flat.shape[-1]
    for b in range(4):
        row = jnp.clip(oo + b, 0, n - 1)
        for a_i in range(4):
            col = jnp.clip(oi + a_i, 0, n - 1)
            w = wi_w[..., a_i] * wo_w[..., b]
            pair = row * n + col
            off = jnp.take_along_axis(a_off_t, pair[..., None], -1)[..., 0]
            mm = jnp.take_along_axis(m_t, pair[..., None], -1)[..., 0]
            # idx (..., 3, m_pad): off + c*m + k, masked to k < m
            c = jnp.arange(3, dtype=jnp.int32)
            idx = (off[..., None, None] + c[:, None] * mm[..., None, None]
                   + k)
            ok = (k < mm[..., None, None]) & (w != 0.0)[..., None, None]
            idx = jnp.clip(idx, 0, nc_flat - 1)
            # one combined gather: tid broadcasts against the (..., 3, m_pad)
            # coefficient indices, so only the needed values are fetched —
            # never a (..., n_coeffs) intermediate (measured .bsdf tables
            # have n_coeffs ~1e5-1e7, which would OOM at render batch sizes)
            vals = ts.a_flat[tid[..., None, None], idx]
            ak = ak + jnp.where(ok, w[..., None, None] * vals, 0.0)
    return ak


def _mu_angles(wo, wi):
    """(muI, muO, cos_phi) per fourier.rs:44-49 (shading space)."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    num = (-wi[..., 0]) * wo[..., 0] + (-wi[..., 1]) * wo[..., 1]
    den = jnp.sqrt((wi[..., 0] ** 2 + wi[..., 1] ** 2) *
                   (wo[..., 0] ** 2 + wo[..., 1] ** 2))
    cos_phi = jnp.clip(num / jnp.maximum(den, 1e-20), -1.0, 1.0)
    cos_phi = jnp.where(den < 1e-20, 1.0, cos_phi)
    return mu_i, mu_o, cos_phi


def _rgb_from_ak(ak, cos_phi, mu_i, mu_o, eta, n_channels):
    """Evaluate the series per channel and reconstruct RGB
    (fourier.rs:88-110)."""
    Y = jnp.maximum(0.0, fourier(ak[..., 0, :], cos_phi))
    scale = jnp.where(jnp.abs(mu_i) > 1e-20, 1.0 / jnp.abs(mu_i), 0.0)
    # radiance transport: account for non-symmetric refraction scaling
    e = jnp.where(mu_i > 0.0, 1.0 / eta, eta)
    scale = scale * jnp.where(mu_i * mu_o > 0.0, e * e, 1.0)
    R = fourier(ak[..., 1, :], cos_phi)
    Bc = fourier(ak[..., 2, :], cos_phi)
    G = 1.39829 * Y - 0.100913 * Bc - 0.297375 * R
    rgb = jnp.clip(jnp.stack([R, G, Bc], axis=-1), 0.0, None) * \
        scale[..., None]
    mono = (Y * scale)[..., None] * jnp.ones(3)
    return jnp.where((n_channels == 1)[..., None], mono, rgb)


def fourier_f(ts: FourierTableSet, tid, wo, wi):
    """FourierBSDF::f (fourier.rs:44-110), batched, shading space."""
    mu_i, mu_o, cos_phi = _mu_angles(wo, wi)
    mu_t = ts.mu[tid]
    oi, wi_w, ok_i = _crw_rows(mu_t, mu_i)
    oo, wo_w, ok_o = _crw_rows(mu_t, mu_o)
    ak = _gather_ak(ts, tid, oi, oo, wi_w, wo_w)
    f = _rgb_from_ak(ak, cos_phi, mu_i, mu_o, ts.eta[tid],
                     ts.n_channels[tid])
    return jnp.where((ok_i & ok_o)[..., None], f, 0.0)


def _crw_rows(nodes_rows, x):
    """catmull_rom_weights with per-lane node rows (..., N)."""
    n = nodes_rows.shape[-1]
    valid = (x >= nodes_rows[..., 0]) & (x <= nodes_rows[..., -1])
    # per-row searchsorted: count nodes <= x
    le = nodes_rows <= x[..., None]
    idx = jnp.clip(jnp.sum(le.astype(jnp.int32), axis=-1) - 1, 0, n - 2)

    def at(i):
        return jnp.take_along_axis(nodes_rows, i[..., None], -1)[..., 0]

    x0 = at(idx)
    x1 = at(idx + 1)
    t = (x - x0) / jnp.maximum(x1 - x0, 1e-20)
    t2, t3 = t * t, t * t * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    xm1 = at(jnp.maximum(idx - 1, 0))
    w0_in = (t3 - 2.0 * t2 + t) * (x1 - x0) / jnp.maximum(x1 - xm1, 1e-20)
    w0_edge = t3 - 2.0 * t2 + t
    hp = idx > 0
    w0 = jnp.where(hp, -w0_in, 0.0)
    w1 = jnp.where(hp, w1, w1 - w0_edge)
    w2 = w2 + jnp.where(hp, w0_in, w0_edge)
    xp2 = at(jnp.minimum(idx + 2, n - 1))
    w3_in = (t3 - t2) * (x1 - x0) / jnp.maximum(xp2 - x0, 1e-20)
    w3_edge = t3 - t2
    hn = idx + 2 < n
    w1 = w1 - jnp.where(hn, w3_in, w3_edge)
    w2 = w2 + jnp.where(hn, 0.0, w3_edge)
    w3 = jnp.where(hn, w3_in, 0.0)
    w = jnp.stack([w0, w1, w2, w3], -1)
    return (idx - 1).astype(jnp.int32), jnp.where(valid[..., None], w, 0.0), \
        valid


def fourier_pdf(ts: FourierTableSet, tid, wo, wi):
    """FourierBSDF::pdf (fourier.rs:214-270), batched."""
    mu_i, mu_o, cos_phi = _mu_angles(wo, wi)
    mu_t = ts.mu[tid]
    oi, wi_w, ok_i = _crw_rows(mu_t, mu_i)
    oo, wo_w, ok_o = _crw_rows(mu_t, mu_o)
    ak = _gather_ak(ts, tid, oi, oo, wi_w, wo_w)
    n = ts.n_mu
    cdf_t = ts.cdf[tid]  # (..., N, N)
    rho = jnp.zeros(mu_o.shape, jnp.float32)
    for b in range(4):
        row = jnp.clip(oo + b, 0, n - 1)
        last = jnp.take_along_axis(
            cdf_t[..., -1], row[..., None], -1)[..., 0]
        rho = rho + wo_w[..., b] * last * (2.0 * PI)
    Y = fourier(ak[..., 0, :], cos_phi)
    pdf = jnp.where((rho > 0) & (Y > 0), Y / jnp.maximum(rho, 1e-20), 0.0)
    return jnp.where(ok_i & ok_o, pdf, 0.0)


def fourier_sample_f(ts: FourierTableSet, tid, wo, u):
    """FourierBSDF::sample_f (fourier.rs:112-212), batched.

    Returns (wi, f (..., 3), pdf)."""
    mu_o = wo[..., 2]
    mu_t = ts.mu[tid]
    mu_i, _, pdf_mu = sample_catmull_rom_2d(
        mu_t, mu_t, ts.a0[tid], ts.cdf[tid], mu_o, u[..., 1])

    oi, wi_w, ok_i = _crw_rows(mu_t, mu_i)
    oo, wo_w, ok_o = _crw_rows(mu_t, mu_o)
    ak = _gather_ak(ts, tid, oi, oo, wi_w, wo_w)
    Y, pdf_phi, phi = sample_fourier(ak[..., 0, :], u[..., 0])
    pdf = jnp.maximum(0.0, pdf_phi * pdf_mu)

    sin2_i = jnp.maximum(0.0, 1.0 - mu_i * mu_i)
    sin2_o = wo[..., 0] ** 2 + wo[..., 1] ** 2
    norm = jnp.sqrt(sin2_i / jnp.maximum(sin2_o, 1e-20))
    norm = jnp.where(jnp.isfinite(norm) & (sin2_o > 1e-20), norm, 0.0)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    wi = -jnp.stack([norm * (cp * wo[..., 0] - sp * wo[..., 1]),
                     norm * (sp * wo[..., 0] + cp * wo[..., 1]),
                     mu_i], axis=-1)
    wi = wi / jnp.maximum(
        jnp.sqrt(jnp.sum(wi * wi, -1, keepdims=True)), 1e-20)

    cos_phi = jnp.clip(cp, -1.0, 1.0)
    f = _rgb_from_ak(ak, cos_phi, mu_i, mu_o, ts.eta[tid],
                     ts.n_channels[tid])
    ok = ok_i & ok_o
    return (jnp.where(ok[..., None], wi, 0.0),
            jnp.where(ok[..., None], f, 0.0),
            jnp.where(ok, pdf, 0.0))
