"""Path integrator: NEE+MIS path tracing over masked wavefronts.

Reference: rustracer-core/src/integrator/path.rs:96-216. Two deliberate
wavefront departures from the reference's per-sample recursion:

1. **lax.scan bounce loop.** The per-sample loop becomes ONE compiled bounce
   body scanned over the interior bounces (a Python unroll compiled the full
   pipeline max_depth times and pushed XLA compiles past 6 minutes on a
   256^2 Cornell). Bounce 0 stays a prologue (it owns the camera-ray
   differentials); the final bounce is an emission-only epilogue.

2. **Merged MIS.** The reference's estimate_direct traces an independent
   BSDF-side sample per NEE (integrator/mod.rs:262-318) — a full extra
   closest-hit traversal per bounce. Here the path's own bounce ray doubles
   as the BSDF-side MIS sample (the standard wavefront formulation): when
   the next bounce hits an emitter (or escapes into an infinite light), its
   contribution is weighted by the power heuristic against the
   light-sampling density pmf·pdf_li. Same estimator family, equally
   unbiased, one traversal per bounce instead of two.

Medium interfaces (material "none") pass straight through without consuming
a bounce (path.rs:143-152) via scene_intersect_passthrough.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.math import absdot, dot
from ..core.ray import Ray
from ..core.sampling import power_heuristic
from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..scene import lights as L
from ..scene.tables import scene_intersect_passthrough
from .common import estimate_direct_light_side


# inter-bounce compaction threshold: wavefronts at least this wide run the
# interior scan on a static B/2 alive-first slab when >= half the lanes are
# dead (see PathIntegrator._run); smaller wavefronts always scan full width
PATH_COMPACT_MIN_B = 1 << 16


# --- gradient-friendly permutation compact/scatter -------------------------
# The alive-first compaction is a permutation slice: sub = x[sel] with
# sel = order[:H]. XLA's generic VJP for the gather is a scatter-ADD (it
# cannot know sel is duplicate-free), and the VJP of full.at[sel].set(sub)
# likewise scatters (an earlier measurement of those scatters forced
# compact_interior off under grad; not yet measured on H100). These
# custom_vjps exploit the permutation structure: the transpose of "take by
# sel" is "gather by the lane's rank, masked to the kept prefix", and the
# transpose of "put at sel" is a mask + a gather — no scatter anywhere.
# rank = argsort(order) (lane -> its position in the alive-first order).

def _f0(a):
    import numpy as _np
    return _np.zeros(a.shape, jax.dtypes.float0)


@jax.custom_vjp
def perm_take(x, sel, rank):
    """x[sel] for a permutation-prefix sel (= order[:H], duplicate-free)."""
    return x[sel]


def _perm_take_fwd(x, sel, rank):
    return x[sel], (sel, rank)


def _perm_take_bwd(res, g):
    sel, rank = res
    H = g.shape[0]
    keep = rank < H
    ct = jnp.where(keep.reshape(keep.shape + (1,) * (g.ndim - 1)),
                   g[jnp.clip(rank, 0, H - 1)], 0.0)
    return ct.astype(g.dtype), _f0(sel), _f0(rank)


perm_take.defvjp(_perm_take_fwd, _perm_take_bwd)


@jax.custom_vjp
def perm_put(full, sub, sel, rank):
    """full.at[sel].set(sub) for a permutation-prefix sel."""
    return full.at[sel].set(sub)


def _perm_put_fwd(full, sub, sel, rank):
    return full.at[sel].set(sub), (sel, rank)


def _perm_put_bwd(res, g):
    sel, rank = res
    H = sel.shape[0]
    kept = (rank < H).reshape(rank.shape + (1,) * (g.ndim - 1))
    ct_full = jnp.where(kept, 0.0, g).astype(g.dtype)
    ct_sub = g[sel]
    return ct_full, ct_sub, _f0(sel), _f0(rank)


perm_put.defvjp(_perm_put_fwd, _perm_put_bwd)


class _PathState(NamedTuple):
    ray_o: jnp.ndarray       # (B, 3)
    ray_d: jnp.ndarray       # (B, 3)
    ray_tmax: jnp.ndarray    # (B,)
    L: jnp.ndarray           # (B, 3) accumulated radiance
    beta: jnp.ndarray        # (B, 3) path throughput
    eta_scale: jnp.ndarray   # (B,)
    alive: jnp.ndarray       # (B,) bool
    prev_pdf: jnp.ndarray    # (B,) BSDF pdf of ray_d (solid angle)
    prev_spec: jnp.ndarray   # (B,) bool — ray_d came from a delta lobe
    prev_p: jnp.ndarray      # (B, 3) scattering point that spawned ray_d
    path_len: jnp.ndarray    # (B,) int32
    obs: jnp.ndarray         # (2,) int32 observed [regular, shadow] ray
    #                          intersect submissions (scene.rs:9-20 counts
    #                          EXECUTED tests; a lane with t_max <= 0 is
    #                          masked dead inside the traversal and is not
    #                          counted)


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    mat_set: object
    max_depth: int = 5
    rr_threshold: float = 1.0
    max_interface_skips: int = 8
    # inter-bounce tiered compaction (see _run): a FORWARD-render
    # optimization (half and quarter tiers). Under value_and_grad the
    # sort/cond/gather-scatter transposes were measured to cost more than
    # the narrowed scan saves (not yet re-measured on H100) —
    # differentiable-rendering callers should
    # dataclasses.replace(integ, compact_interior=False).
    compact_interior: bool = True
    # deepest compaction tier: 1 = B/2 slab only (the round-4 behavior),
    # 2 = add a B/4 slab chosen when <= a quarter of the lanes are alive
    compact_tiers: int = 2

    def li(self, ctx, ray, lanes, sampler, dims):
        return self._run(ctx, ray, lanes, sampler, dims)[0]

    def li_aux(self, ctx, ray, lanes, sampler, dims):
        """li plus per-lane auxiliary stats (path length — the bounce count
        the reference's path.rs:18-19 int-distribution reports)."""
        return self._run(ctx, ray, lanes, sampler, dims)

    def tests_per_lane(self):
        """Static intersection-test call counts per camera-ray lane in the
        wavefront model (every lane executes every test): per bounce one
        closest hit; per NEE one shadow probe (reference counters
        scene.rs:9-20). The merged-MIS formulation has no separate
        BSDF-side closest hit.

        NOTE: unlike the reference, which counts tests actually executed,
        these are UPPER BOUNDS — lanes that die early (miss / Russian
        roulette) still count every bounce's test because the wavefront
        kernel dispatches them all (dead lanes are masked inside the
        traversal, not skipped at this accounting level). The printed
        "Intersections/..." stats are therefore dispatch counts of the
        wavefront model, not observed per-ray work."""
        d = self.max_depth
        return {"regular": d, "shadow": d - 1}

    # -- per-bounce pieces -------------------------------------------------

    def _sel_pmf(self, ctx, p, lid):
        """Selection pmf of light row `lid` for a path scattered at `p` —
        the density the emission-hit MIS weight pairs with (uniform pick or
        the spatial grid, path.rs:86-94)."""
        if getattr(ctx, "light_grid", None) is not None:
            from ..scene import lightdistrib as LD
            return LD.pmf_lookup(ctx.light_grid, p, lid)
        n = ctx.lights.n_lights
        return jnp.full(lid.shape, 1.0 / n, jnp.float32)

    def _pick_light(self, ctx, sampler, lanes, si, d_sel):
        u_sel = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_sel)
        if getattr(ctx, "light_grid", None) is not None:
            from ..scene import lightdistrib as LD
            return LD.sample_light(ctx.light_grid, si.p, u_sel)
        n = ctx.lights.n_lights
        lid = jnp.minimum((u_sel * n).astype(jnp.int32), n - 1)
        return lid, jnp.full(si.t.shape, 1.0 / n, jnp.float32)

    def _hit_and_emit(self, ctx, ray, st: _PathState, first: bool):
        """Closest hit (interface pass-through) + MIS-weighted emission.
        Returns (si, state). Emission weight is 1 on camera hits and delta
        bounces, else the power heuristic against pmf·pdf_li — the merged
        BSDF-side of MIS (pairs with estimate_direct_light_side)."""
        geom, lt = ctx.geom, ctx.lights
        st = st._replace(obs=st.obs + jnp.array([1, 0], jnp.int32)
                         * jnp.sum((ray.t_max > 0.0).astype(jnp.int32)))
        si = scene_intersect_passthrough(geom, ray,
                                         self.max_interface_skips)
        if first and ray.has_differentials:
            from ..core.interaction import compute_differentials
            si = compute_differentials(si, ray)
        si = si._replace(valid=si.valid & st.alive)

        le_hit = L.arealight_le(lt, si.arealight, si.n, si.wo)
        if first:
            w_hit = jnp.ones(st.prev_pdf.shape, jnp.float32)
            le_esc = L.infinite_le(lt, ray.d)
        else:
            pmf_hit = self._sel_pmf(ctx, st.prev_p, si.arealight)
            lpdf = L.pdf_li_hit(lt, geom, si.arealight, st.prev_p, ray.d,
                                si.p, si.n) * pmf_hit
            w_hit = jnp.where(st.prev_spec, 1.0,
                              power_heuristic(1.0, st.prev_pdf, 1.0, lpdf))

            def pmf_fn(row):
                return self._sel_pmf(ctx, st.prev_p,
                                     jnp.broadcast_to(row, st.prev_pdf.shape))
            le_esc = L.infinite_le_mis(lt, ray.d, st.prev_pdf, st.prev_spec,
                                       pmf_fn)
        le_hit = jnp.where((si.valid & (si.arealight >= 0))[..., None],
                           w_hit[..., None] * le_hit, 0.0)
        le_esc = jnp.where((st.alive & ~si.valid)[..., None], le_esc, 0.0)
        Lrad = st.L + st.beta * (le_hit + le_esc)

        alive = st.alive & si.valid & (si.material >= 0)
        path_len = st.path_len + alive.astype(jnp.int32)
        return si, st._replace(L=Lrad, alive=alive, path_len=path_len)

    def _scatter(self, ctx, sampler, lanes, si, st: _PathState,
                 d_sel, d_light, d_lobe, d_u2, d_rr, rr_on):
        """Shade + NEE (light side) + BSDF bounce sample + Russian roulette.
        Dim arguments may be traced (scan body) or static ints (prologue);
        rr_on is a traced/static bool for the bounce>3 RR gate
        (path.rs:199-209)."""
        types = self.mat_set.types_present()
        si_s, lobes = self.mat_set.shade(si, ctx)
        lobes = lobes._replace(active=lobes.active & st.alive[..., None])

        # NEE, light-sampling side only (path.rs:154-169)
        n_nonspec = B.num_matching(lobes, B.ALL & ~B.SPECULAR)
        lid, pmf = self._pick_light(ctx, sampler, lanes, si_s, d_sel)
        u_light = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_light)
        ld, n_shadow = estimate_direct_light_side(ctx, self.mat_set, si_s,
                                                  lobes, lid, u_light, pmf)
        st = st._replace(obs=st.obs + jnp.array([0, 1], jnp.int32) * n_shadow)
        Lrad = st.L + jnp.where((st.alive & (n_nonspec > 0))[..., None],
                                st.beta * ld, 0.0)

        # BSDF sampling for the next bounce (path.rs:172-196)
        u_lobe = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_lobe)
        u2 = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_u2)
        wi, f, pdf, flags, ok = B.bsdf_sample_f(lobes, si_s, si_s.wo,
                                                u_lobe, u2, types)
        contrib = f * (absdot(wi, si_s.ns) /
                       jnp.maximum(pdf, 1e-12))[..., None]
        alive = st.alive & ok & ~is_black(f) & (pdf > 0.0)
        beta = jnp.where(alive[..., None], st.beta * contrib, st.beta)
        spec = (flags & B.SPECULAR) != 0
        is_spec_trans = spec & ((flags & B.TRANSMISSION) != 0)
        eta = lobes.eta
        entering = dot(si_s.wo, si_s.ns) > 0.0
        eta_scale = jnp.where(
            is_spec_trans,
            st.eta_scale * jnp.where(entering, eta * eta,
                                     1.0 / jnp.maximum(eta * eta, 1e-8)),
            st.eta_scale)
        ray = si_s.spawn_ray(wi)
        # dead lanes must not traverse (their wi is garbage and can stretch
        # the lockstep BVH loop arbitrarily)
        t_max = jnp.where(alive, ray.t_max, 0.0)

        # Russian roulette (path.rs:199-209); the sampler dim is consumed
        # on every bounce so sequences stay aligned across depths
        u_rr = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_rr)
        rr_beta_max = jnp.max(beta * eta_scale[..., None], axis=-1)
        q = jnp.maximum(0.05, 1.0 - rr_beta_max)
        do_rr = rr_on & (rr_beta_max < self.rr_threshold)
        alive = alive & ~(do_rr & (u_rr < q))
        beta = jnp.where((do_rr & alive)[..., None],
                         beta / jnp.maximum(1.0 - q, 1e-3)[..., None], beta)

        return _PathState(ray_o=ray.o, ray_d=ray.d, ray_tmax=t_max,
                          L=Lrad, beta=beta, eta_scale=eta_scale,
                          alive=alive, prev_pdf=pdf, prev_spec=spec,
                          prev_p=si_s.p, path_len=st.path_len, obs=st.obs)

    # -- driver -------------------------------------------------------------

    def _run(self, ctx, ray, lanes, sampler, dims):
        bs = ray.t_max.shape
        d = self.max_depth
        zero3 = jnp.zeros(bs + (3,), jnp.float32)
        st = _PathState(
            ray_o=ray.o, ray_d=ray.d, ray_tmax=ray.t_max,
            L=zero3, beta=jnp.ones(bs + (3,), jnp.float32),
            eta_scale=jnp.ones(bs, jnp.float32),
            alive=jnp.ones(bs, bool),
            # prev_spec=True ⇒ weight-1 emission on camera hits
            prev_pdf=jnp.ones(bs, jnp.float32),
            prev_spec=jnp.ones(bs, bool),
            prev_p=ray.o, path_len=jnp.zeros(bs, jnp.int32),
            obs=jnp.zeros(2, jnp.int32))

        from ..utils import stats as S

        def emit_observed(st):
            S.device_count(
                "Intersections/Regular ray intersection tests (observed)",
                st.obs[0])
            S.device_count(
                "Intersections/Shadow ray intersection tests (observed)",
                st.obs[1])

        # bounce 0: prologue owns the ray differentials
        si, st = self._hit_and_emit(ctx, ray, st, first=True)
        if d == 1:
            emit_observed(st)
            return st.L, st.path_len
        st = self._scatter(ctx, sampler, lanes, si, st,
                           dims.next_1d(), dims.next_2d(), dims.next_1d(),
                           dims.next_2d(), dims.next_1d(), rr_on=False)

        # interior bounces 1..d-2: ONE compiled body, scanned
        if d > 2:
            base1, base2 = dims.d1, dims.d2
            dims.d1 += 3 * (d - 2)
            dims.d2 += 2 * (d - 2)
            # tape scope: the scan body is traced ONCE, so tape entries it
            # adds (static python lane counts from texture lookups) are
            # multiplied by the trip count after the scan; traced entries
            # flow through the obs carry instead (never the tape)
            pre_tape = S.device_tape_drain()

            def scan_bounces(st_k, lanes_k):
                def body(carry, b):
                    r = Ray(o=carry.ray_o, d=carry.ray_d,
                            t_max=carry.ray_tmax)
                    si_b, c = self._hit_and_emit(ctx, r, carry, first=False)
                    k = b - jnp.uint32(1)
                    c = self._scatter(
                        ctx, sampler, lanes_k, si_b, c,
                        jnp.uint32(base1) + k * jnp.uint32(3),
                        jnp.uint32(base2) + k * jnp.uint32(2),
                        jnp.uint32(base1) + k * jnp.uint32(3) + jnp.uint32(1),
                        jnp.uint32(base2) + k * jnp.uint32(2) + jnp.uint32(1),
                        jnp.uint32(base1) + k * jnp.uint32(3) + jnp.uint32(2),
                        rr_on=b > jnp.uint32(3))
                    return c, None
                out, _ = jax.lax.scan(body, st_k,
                                      jnp.arange(1, d - 1, dtype=jnp.uint32))
                return out

            B0 = st.alive.shape[0] if st.alive.ndim == 1 else 0
            if self.compact_interior and B0 >= PATH_COMPACT_MIN_B \
                    and B0 % 2 == 0:
                # inter-bounce TIERED compaction: open scenes kill most
                # lanes at bounce 0, yet every scanned bounce pays
                # full-width shading/NEE work (tools/profile_dragon.py;
                # alive fractions on the dragon decay 24.5% -> 3.6% ->
                # 0.3% across bounces). The
                # slab width is chosen ONCE, before the interior scan, by a
                # runtime cond chain on the alive count: <= B/4 lanes
                # alive runs the whole scan in a quarter slab, <= B/2 in a
                # half slab, else full width. Dead lanes skipped this way
                # are never read again (their L/path_len are final and the
                # full-width body only ever updates them under alive
                # masks), so results are identical.
                #
                # Two variants were measured slower on the dragon on the
                # previous accelerator (not yet re-measured on H100):
                #  - re-compacting B/2 -> B/4 mid-scan (between bounces 1
                #    and 2): the extra argsort + gather/scatter round trip
                #    loses more than the narrower tail saves;
                #  - moving the slab boundary BEFORE the bounce-0 scatter
                #    (hit fraction is already ~0.25 there): the cond
                #    boundary forces XLA to materialize the entire camera
                #    SurfaceInteraction that otherwise fuses into the
                #    scatter, and adds ~20 permutation gathers for it.
                H = B0 // 2
                Q = B0 // 4
                order = jnp.argsort(~st.alive)          # alive-first, stable
                rank = jnp.argsort(order)               # lane -> position
                n_alive = jnp.sum(st.alive.astype(jnp.int32))
                obs_pre = st.obs
                st_z = st._replace(obs=jnp.zeros(2, jnp.int32))

                def is_lane(x):
                    return hasattr(x, "ndim") and x.ndim >= 1 \
                        and x.shape[0] == B0

                def take(x, sel_):
                    # custom-vjp take for float state (its transpose is a
                    # masked gather, not a scatter-add); plain gather for
                    # int/bool lanes (no cotangents flow through them)
                    if jnp.issubdtype(x.dtype, jnp.floating):
                        return perm_take(x, sel_, rank)
                    return x[sel_]

                def put(full, s_, sel_):
                    if jnp.issubdtype(full.dtype, jnp.floating):
                        return perm_put(full, s_, sel_, rank)
                    return full.at[sel_].set(s_)

                def slab_branch(w):
                    """Scan the interior bounces in an alive-first w-slab
                    (perm_take/perm_put keep the transpose scatter-free)."""
                    sel_ = order[:w]

                    def branch(st_in):
                        sub = jax.tree.map(
                            lambda x: take(x, sel_) if is_lane(x) else x,
                            st_in)
                        lanes_sub = type(lanes)(
                            pixel_idx=lanes.pixel_idx[sel_],
                            sample_idx=lanes.sample_idx[sel_])
                        sub = scan_bounces(sub, lanes_sub)
                        return jax.tree.map(
                            lambda full, s_: put(full, s_, sel_)
                            if is_lane(full) else s_, st_in, sub)
                    return branch

                def full_branch(st_in):
                    return scan_bounces(st_in, lanes)

                quarter_tier = self.compact_tiers >= 2 and B0 % 4 == 0
                if quarter_tier:
                    st = jax.lax.cond(
                        n_alive <= Q, slab_branch(Q),
                        lambda s: jax.lax.cond(n_alive <= H, slab_branch(H),
                                               full_branch, s), st_z)
                else:
                    st = jax.lax.cond(n_alive <= H, slab_branch(H),
                                      full_branch, st_z)
                st = st._replace(obs=st.obs + obs_pre)
                # EVERY branch was traced, so static python tape counts
                # (texture lookups per branch trace, proportional to lane
                # width) were added at B + B/2 (+ B/4 with the quarter
                # tier); normalize to the full-width dispatch number
                tape_scale = 1.0 / 1.75 if quarter_tier else 1.0 / 1.5
            else:
                st = scan_bounces(st, lanes)
                tape_scale = 1.0
            body_tape = S.device_tape_drain()
            if pre_tape is not None:
                for k, v in pre_tape.items():
                    S.device_count(k, v)
                for k, v in body_tape.items():
                    if isinstance(v, (int, float)):
                        S.device_count(k, int(v * tape_scale) * (d - 2))

        # final bounce: emission only (the reference breaks after adding le
        # at bounces == max_depth)
        r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
        _, st = self._hit_and_emit(ctx, r, st, first=False)
        emit_observed(st)
        return st.L, st.path_len
