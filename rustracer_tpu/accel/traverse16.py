"""Device-side 16-wide BVH traversal: one 128-float row gather per step.

Design point: every step gathers one row per live lane, so a ray's cost
follows the rows it gathers. The binary threaded kernel (accel/traverse.py)
needs ~100-190 rows/ray; this kernel gathers ONE unified record per step —
either 16 child AABBs + links or 8 baked triangles — for ~12-25 rows/ray. It replaces the reference's binary
stack traversal (rustracer-core/src/bvh/mod.rs:366-501) as the hot path.

Per-lane state is {row, visit-mask, short stack, t_best, prim}:
- Children inside a record are pre-sorted near-to-far for the lane's ray
  octant (8 interior-table copies, accel/wide.py), so "nearest unvisited
  child" = lowest set bit of (boxhits & visit_mask) — no per-child t kept.
- The stack holds (node_row, remaining_mask) pairs, depth = wide-tree depth
  (≤ ~7 for 10^6 tris). It lives as D parallel (B,) registers updated by
  where-chains — NOT a (B, D) array, which would need per-lane gathers.
- On pop the node record is re-gathered and its boxes re-tested against the
  tightened t_best (free culling; box tests are elementwise work that overlaps the
  gather).

Instancing (reference primitive.rs:89-118 TransformedPrimitive): instanced
scenes add a third record type — hitting an instance record transforms the
lane's ray into object space (direction left UNNORMALIZED so the t parameter
stays comparable across spaces) and jumps to the object's BLAS root for the
object-ray octant. Popping back below the instance-entry stack height
restores the world-space ray. Scenes without instances keep the original
smaller state (statically specialized on tables.has_instances).

Divergence: same two-phase shape as the binary kernel — a fixed-trip
majority pass, then argsort-compacted quarter-width drains. A fully-dead
wavefront (e.g. fully masked shadow probes) skips everything via lax.cond.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.math import INFINITY
from ..ops.triangle import triangle_intersect_c
from .wide import TAG_INST

# Chosen with tools/sweep_traverse.py (327k-tri mesh, 256k camera rays) on
# the previous accelerator; not yet re-swept on H100. rows/ray is p50 ~2, so
# a short pass-1 + early compaction wastes fewer full-width gathers on
# finished lanes.
MAJORITY_ITERS = 4    # pass-1 fixed trip count
TAIL_FRACTION = 8     # pass-2 compacted width = B / TAIL_FRACTION
FULL_MASK = (1 << 16) - 1

# Ray-regeneration driver (large wavefronts): a fixed active window of A
# lanes walks the tree while the rest of the wavefront waits in a backlog;
# every REGEN_STEPS steps, finished lanes retire their result (scatter by
# ray id) and load the next backlog ray. Paid rows/ray approaches the
# USEFUL mean (~5 on dragon-class meshes) instead of the ~20+ the
# majority+drain scheme pays. The constants come from tools/sweep_regen.py
# on the previous accelerator and are not yet re-swept on H100.
REGEN_MIN_B = 1 << 16    # use regeneration for wavefronts at least this wide
REGEN_ACTIVE = 1 << 13   # active-window lanes (A)
REGEN_STEPS = 8          # traversal steps between refill-trigger checks
REGEN_REFILL_FRAC = 4    # refill when >= A/FRAC lanes are done (adaptive)
REGEN_MAX_STEPS = 64     # hard cap on steps between refills


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _inv_dir(c):
    safe = jnp.where(jnp.abs(c) < 1e-20,
                     jnp.where(c < 0, -1e-20, 1e-20), c)
    return 1.0 / safe


def _interior_hits(recT, rayc, t_best, links, vmask):
    """Interior record interpretation: 16 slab tests (words 17..113) →
    bitmask of unvisited hit children. All shapes (16, B)."""
    ox, oy, oz, _, _, _, ix, iy, iz = rayc
    r1 = lambda v: v[None, :]
    lo_x = recT[17:33]
    lo_y = recT[33:49]
    lo_z = recT[49:65]
    hi_x = recT[65:81]
    hi_y = recT[81:97]
    hi_z = recT[97:113]
    t0x = (lo_x - r1(ox)) * r1(ix)
    t1x = (hi_x - r1(ox)) * r1(ix)
    t0y = (lo_y - r1(oy)) * r1(iy)
    t1y = (hi_y - r1(oy)) * r1(iy)
    t0z = (lo_z - r1(oz)) * r1(iz)
    t1z = (hi_z - r1(oz)) * r1(iz)
    t_near = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
    t_far = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                    jnp.maximum(t0y, t1y)),
                        jnp.maximum(t0z, t1z)) * 1.00000024
    box_hit = (t_near <= t_far) & (t_far > 0.0) & \
        (t_near < r1(t_best)) & (links >= 0)
    bits = jnp.sum(
        jnp.where(box_hit,
                  jnp.int32(1) << jnp.arange(16, dtype=jnp.int32)[:, None],
                  0), axis=0)
    return bits & vmask


def _leaf_hits(recT, rayc, t_best, leaf_active):
    """Leaf record interpretation: 8 watertight triangle tests (words 1..81)
    → (best_tid, t_min, per-lane executed-test count)."""
    ox, oy, oz, dx, dy, dz, _, _, _ = rayc
    r1 = lambda v: v[None, :]
    tid = _bitcast_i32(recT[1:9])                     # (8, B)
    blk = lambda j: recT[9 + j * 8:9 + (j + 1) * 8]
    th = triangle_intersect_c(
        (r1(ox), r1(oy), r1(oz)), (r1(dx), r1(dy), r1(dz)),
        r1(t_best), (blk(0), blk(1), blk(2)),
        (blk(3), blk(4), blk(5)), (blk(6), blk(7), blk(8)))
    tri_ok = leaf_active[None, :] & (tid >= 0) & th.hit
    n_tri = jnp.where(
        leaf_active, jnp.sum((tid >= 0).astype(jnp.int32), axis=0), 0)
    t_cand = jnp.where(tri_ok, th.t, INFINITY)
    # integer argmin, then ONE-HOT selection on the INDEX: comparing
    # floats against a separately-computed min is unsound under XLA
    # (FMA contraction recomputes t_cand bitwise-differently per use);
    # the one-hot sum replaces an 8-iteration where-chain (per-step op
    # count is the regen driver's bottleneck at small active windows)
    j_min = jnp.argmin(t_cand, axis=0)
    eq8 = j_min[None, :] == jnp.arange(8, dtype=jnp.int32)[:, None]
    tid_sel = jnp.sum(jnp.where(eq8, tid, 0), axis=0)
    ok_sel = jnp.any(eq8 & tri_ok, axis=0)
    t_min = jnp.sum(jnp.where(eq8, t_cand, 0.0), axis=0)
    best_tid = jnp.where(ok_sel, tid_sel, -1)
    return best_tid, t_min, n_tri


def _make_body(tables, any_hit: bool, D: int, instanced: bool = False):
    """One traversal step over the lane state (row gather, interior or leaf
    interpretation, descend or pop)."""
    table = tables.bvh16_table            # (R, 128)
    R = table.shape[0]

    def body(s):
        if instanced:
            (row, vmask, sp, t_best, prim, done, stack_row, stack_mask,
             rayc, worldc, inst_cur, inst_sp, inst_best, cnt) = s
        else:
            (row, vmask, sp, t_best, prim, done, stack_row, stack_mask,
             rayc, cnt) = s
        active = ~done
        # observed-work counters (reference scene.rs:9-20 counts executed
        # tests): rows actually gathered for live lanes + non-pad triangle
        # tests — per-lane int32 adds, summed once at the end
        cnt_rows, cnt_tri = cnt
        cnt_rows = cnt_rows + active.astype(jnp.int32)
        rec = table[jnp.clip(row, 0, R - 1)]              # ONE row gather
        # Everything below runs on (k, B) shapes, with the lane batch B as
        # the minor axis: elementwise work is dense over B instead of over
        # the tiny (16 or 8) child axis of the raw (B, 16)/(B, 8) slices.
        recT = rec.T                                      # (128, B)
        tag = _bitcast_i32(recT[0])
        is_leaf = tag < 0
        if instanced:
            is_inst = tag >= TAG_INST
            is_int = ~is_leaf & ~is_inst
        else:
            is_int = ~is_leaf

        # --- interior interpretation: 16 slab tests (words 17..113) ---
        links = _bitcast_i32(recT[1:17])                  # (16, B)
        m = _interior_hits(recT, rayc, t_best, links, vmask)

        best_tid, t_min, n_tri = _leaf_hits(recT, rayc, t_best,
                                            is_leaf & active)
        cnt_tri = cnt_tri + n_tri
        upd = is_leaf & active & (best_tid >= 0) & (t_min < t_best)
        t_best = jnp.where(upd, t_min, t_best)
        prim = jnp.where(upd, best_tid, prim)
        if instanced:
            inst_best = jnp.where(upd, inst_cur, inst_best)

        # --- instance interpretation: transform ray, jump to BLAS root ---
        if instanced:
            wox, woy, woz, wdx, wdy, wdz = worldc[:6]
            mm = [recT[10 + i] for i in range(12)]
            box_ = mm[0] * wox + mm[1] * woy + mm[2] * woz + mm[3]
            boy_ = mm[4] * wox + mm[5] * woy + mm[6] * woz + mm[7]
            boz_ = mm[8] * wox + mm[9] * woy + mm[10] * woz + mm[11]
            bdx = mm[0] * wdx + mm[1] * wdy + mm[2] * wdz
            bdy = mm[4] * wdx + mm[5] * wdy + mm[6] * wdz
            bdz = mm[8] * wdx + mm[9] * wdy + mm[10] * wdz
            # direction stays unnormalized: t is the same parameter in both
            # spaces, so t_best needs no rescaling across the transition
            oct_o = ((bdx < 0).astype(jnp.int32)
                     | ((bdy < 0).astype(jnp.int32) << 1)
                     | ((bdz < 0).astype(jnp.int32) << 2))
            roots8 = _bitcast_i32(recT[1:9])              # (8, B)
            eq_o = oct_o[None, :] == jnp.arange(8, dtype=jnp.int32)[:, None]
            blas_root = jnp.sum(jnp.where(eq_o, roots8, 0), axis=0)
            rec_inst = _bitcast_i32(recT[9])
            enter = active & is_inst
        else:
            enter = jnp.zeros_like(done)

        # --- choose next row: descend nearest unvisited child or pop ---
        descend = active & is_int & (m != 0)
        low = m & -m
        slot = jax.lax.population_count(low - 1)
        eq16 = slot[None, :] == jnp.arange(16, dtype=jnp.int32)[:, None]
        link = jnp.sum(jnp.where(eq16, links, 0), axis=0)
        rest = m & ~low
        push = descend & (rest != 0)
        for d in range(D):
            at = push & (sp == d)
            stack_row = tuple(jnp.where(at, row, sr) if d == e else sr
                              for e, sr in enumerate(stack_row))
            stack_mask = tuple(jnp.where(at, rest, sm) if d == e else sm
                               for e, sm in enumerate(stack_mask))
        sp = sp + push.astype(jnp.int32)

        need_pop = active & ~descend & ~enter
        sp_top = sp - 1
        eq_d = sp_top[None, :] == jnp.arange(D, dtype=jnp.int32)[:, None]
        prow = jnp.sum(jnp.where(eq_d, jnp.stack(stack_row), 0), axis=0)
        pmask = jnp.sum(jnp.where(eq_d, jnp.stack(stack_mask), 0), axis=0)
        can_pop = need_pop & (sp > 0)
        done = done | (need_pop & (sp == 0))
        if any_hit:
            done = done | (prim >= 0)
        row = jnp.where(can_pop, prow,
                        jnp.where(descend, link, row))
        vmask = jnp.where(can_pop, pmask,
                          jnp.where(descend, FULL_MASK, vmask))
        sp = sp - can_pop.astype(jnp.int32)

        if not instanced:
            return (row, vmask, sp, t_best, prim, done, stack_row,
                    stack_mask, rayc, (cnt_rows, cnt_tri))

        # instance entry: jump into the BLAS with the object-space ray
        row = jnp.where(enter, blas_root, row)
        vmask = jnp.where(enter, FULL_MASK, vmask)
        # popping below the entry height exits the instance: restore the
        # world ray (instances cannot nest — BLAS holds no instance records)
        exit_i = can_pop & (inst_cur >= 0) & (sp_top < inst_sp)
        inst_cur = jnp.where(enter, rec_inst,
                             jnp.where(exit_i, -1, inst_cur))
        inst_sp = jnp.where(enter, sp, inst_sp)
        in_obj = inst_cur >= 0
        new_obj = (box_, boy_, boz_, bdx, bdy, bdz,
                   _inv_dir(bdx), _inv_dir(bdy), _inv_dir(bdz))
        rayc = tuple(jnp.where(enter, no,
                               jnp.where(in_obj, rc, wc))
                     for no, rc, wc in zip(new_obj, rayc, worldc))
        return (row, vmask, sp, t_best, prim, done, stack_row, stack_mask,
                rayc, worldc, inst_cur, inst_sp, inst_best,
                (cnt_rows, cnt_tri))

    return body


def _traverse16_regen(tables, ray, any_hit: bool):
    """Ray-regeneration driver: active window + backlog refill.

    Results are bit-identical to the plain driver — each ray's walk is
    deterministic and independent of lane scheduling; only the order in
    which rays occupy lanes changes. Replaces the reference's per-thread
    tile loop (rustracer-core/src/renderer.rs:68-131) as the utilization
    mechanism: instead of threads pulling tiles from a queue, lanes pull
    rays from the wavefront backlog."""
    B = ray.t_max.shape[0]
    A = min(REGEN_ACTIVE, B // 4)
    D = tables.bvh16_depth_pad.shape[0]
    instanced = tables.has_instances
    body = _make_body(tables, any_hit, D, instanced)
    roots = tables.bvh16_roots

    box_, boy_, boz_ = ray.o[..., 0], ray.o[..., 1], ray.o[..., 2]
    bdx, bdy, bdz = ray.d[..., 0], ray.d[..., 1], ray.d[..., 2]
    bt = ray.t_max
    zero_A = jnp.zeros((A,), jnp.int32)

    # queue only the LIVE backlog rays: bounce/NEE wavefronts are often
    # mostly dead lanes (t_max <= 0 after path termination or NEE masks),
    # and loading a dead ray burns a lane slot for a full refill stride.
    # One cumsum + drop-scatter compacts the queue; dead rays keep the
    # no-hit defaults already in the output buffers.
    alive0 = bt > 0.0
    n_q = jnp.sum(alive0.astype(jnp.int32))
    slot = jnp.where(alive0, jnp.cumsum(alive0.astype(jnp.int32)) - 1, B)
    queue = jnp.zeros((B,), jnp.int32).at[slot].set(
        jnp.arange(B, dtype=jnp.int32), mode="drop")

    def load(q):
        """Fresh per-lane state + ray ids for queue slots q ((A,) int32).
        Slots past the queue end load an idle done lane (rid -1)."""
        valid = q < n_q
        j = queue[jnp.clip(q, 0, B - 1)]
        ox, oy, oz = box_[j], boy_[j], boz_[j]
        dx, dy, dz = bdx[j], bdy[j], bdz[j]
        rayc = (ox, oy, oz, dx, dy, dz,
                _inv_dir(dx), _inv_dir(dy), _inv_dir(dz))
        octant = ((dx < 0).astype(jnp.int32)
                  | ((dy < 0).astype(jnp.int32) << 1)
                  | ((dz < 0).astype(jnp.int32) << 2))
        t_max = bt[j]
        st = (roots[octant],
              jnp.full((A,), FULL_MASK, jnp.int32),
              zero_A,
              t_max,
              jnp.full((A,), -1, jnp.int32),
              ~valid | (t_max <= 0.0),
              tuple(zero_A for _ in range(D)),
              tuple(zero_A for _ in range(D)),
              rayc)
        if instanced:
            st = st + (rayc, jnp.full((A,), -1, jnp.int32), zero_A,
                       jnp.full((A,), -1, jnp.int32))
        st = st + ((zero_A, zero_A),)             # observed-work counters
        return st, jnp.where(valid, j, -1)

    def merge(take, new, old):
        return jax.tree.map(
            lambda n, o: jnp.where(take, n, o) if o.ndim == 1
            else jnp.where(take[:, None], n, o), new, old)

    def retire(s, rid, out_t, out_prim, out_inst):
        t_best, prim, done = s[3], s[4], s[5]
        sel = done & (rid >= 0)
        tgt = jnp.where(sel, rid, B)          # B = out of bounds -> dropped
        out_t = out_t.at[tgt].set(
            jnp.where(prim >= 0, t_best, INFINITY), mode="drop")
        out_prim = out_prim.at[tgt].set(prim, mode="drop")
        if instanced:
            inst = jnp.where(prim >= 0, s[12], -1)
            out_inst = out_inst.at[tgt].set(inst, mode="drop")
        return out_t, out_prim, out_inst

    def cond(carry):
        s, rid, qhead, *_ = carry
        return (qhead < n_q) | jnp.any(~s[5])

    def refill(carry):
        s, rid, qhead, out_t, out_prim, out_inst, acc = carry
        done = s[5]
        out_t, out_prim, out_inst = retire(s, rid, out_t, out_prim, out_inst)
        rank = jnp.cumsum(done.astype(jnp.int32)) - 1
        qnew = qhead + rank
        take = done & (qnew < n_q)
        # bank replaced lanes' observed-work counts (load() zeroes them)
        cnt_rows, cnt_tri = s[-1]
        acc = acc + jnp.stack([jnp.sum(jnp.where(take, cnt_rows, 0)),
                               jnp.sum(jnp.where(take, cnt_tri, 0))])
        new_s, new_rid = load(qnew)
        s = merge(take, new_s, s)
        rid = jnp.where(take, new_rid, jnp.where(done, -1, rid))
        qhead = qhead + jnp.sum(take.astype(jnp.int32))
        return (s, rid, qhead, out_t, out_prim, out_inst, acc)

    def outer(carry):
        s, rid, qhead, *rest = carry

        # adaptive stepping: keep walking the ACTIVE window (A-sized state
        # only — a lax.cond over the full carry copies the B-sized output
        # buffers and costs more than it saves) until a refill is worth it:
        # >= A/FRAC lanes retirable, or everything is done. The first
        # REGEN_STEPS steps are unconditional (guaranteed progress even at
        # the drain tail, so the outer loop terminates); the body appears
        # ONCE in the traced loop — an unrolled stride multiplied the HLO
        # ~9x per traversal site and the render-step compile time with it.
        def step_cond(sk):
            s_, k = sk
            n_done = jnp.sum(s_[5].astype(jnp.int32))
            return (k < REGEN_MAX_STEPS) & \
                ((k < REGEN_STEPS) | (n_done * REGEN_REFILL_FRAC < A))

        def step_body(sk):
            s_, k = sk
            return (body(s_), k + 1)

        s, _ = jax.lax.while_loop(step_cond, step_body, (s, jnp.int32(0)))
        return refill((s, rid, qhead, *rest))

    st0, rid0 = load(jnp.arange(A, dtype=jnp.int32))
    init = (st0,
            rid0,
            jnp.int32(A),
            jnp.full((B,), INFINITY),
            jnp.full((B,), -1, jnp.int32),
            jnp.full((B,), -1, jnp.int32),
            jnp.zeros(2, jnp.int32))

    def run(init):
        s, rid, _, out_t, out_prim, out_inst, acc = jax.lax.while_loop(
            cond, outer, init)
        out_t, out_prim, out_inst = retire(s, rid, out_t, out_prim, out_inst)
        cnt_rows, cnt_tri = s[-1]
        acc = acc + jnp.stack([jnp.sum(cnt_rows), jnp.sum(cnt_tri)])
        hit = out_prim >= 0
        return (hit, jnp.where(hit, out_t, INFINITY),
                jnp.maximum(out_prim, 0), jnp.where(hit, out_inst, -1), acc)

    def dead(init):
        return (jnp.zeros((B,), bool), jnp.full((B,), INFINITY),
                jnp.zeros((B,), jnp.int32), jnp.full((B,), -1, jnp.int32),
                jnp.zeros(2, jnp.int32))

    return jax.lax.cond(jnp.any(ray.t_max > 0.0), run, dead, init)


def _traverse16(tables, ray, any_hit: bool):
    """→ (hit, t, prim, inst, counts) where counts = int32 [rows gathered,
    triangle tests] of OBSERVED work (live lanes only). The counts are
    traced values scoped to the caller — they are deliberately NOT pushed
    onto the stats tape here because this function runs inside integrator
    scan/while bodies (that would leak tracers); render-path observed
    stats are counted at the integrator level (path.py _PathState.obs)."""
    bs = ray.t_max.shape
    if len(bs) == 1 and bs[0] >= REGEN_MIN_B:
        return _traverse16_regen(tables, ray, any_hit)
    D = tables.bvh16_depth_pad.shape[0]
    instanced = tables.has_instances
    body = _make_body(tables, any_hit, D, instanced)

    ox, oy, oz = ray.o[..., 0], ray.o[..., 1], ray.o[..., 2]
    dx, dy, dz = ray.d[..., 0], ray.d[..., 1], ray.d[..., 2]
    rayc = (ox, oy, oz, dx, dy, dz, _inv_dir(dx), _inv_dir(dy), _inv_dir(dz))
    octant = ((dx < 0).astype(jnp.int32)
              | ((dy < 0).astype(jnp.int32) << 1)
              | ((dz < 0).astype(jnp.int32) << 2))
    zero_i = jnp.zeros(bs, jnp.int32)
    init = (tables.bvh16_roots[octant],
            jnp.full(bs, FULL_MASK, jnp.int32),
            zero_i,
            ray.t_max,
            jnp.full(bs, -1, jnp.int32),
            ray.t_max <= 0.0,                     # dead lanes start done
            tuple(zero_i for _ in range(D)),
            tuple(zero_i for _ in range(D)),
            rayc)
    if instanced:
        init = init + (rayc,                      # immutable world-space copy
                       jnp.full(bs, -1, jnp.int32),   # inst_cur
                       zero_i,                        # inst_sp
                       jnp.full(bs, -1, jnp.int32))   # inst_best
    init = init + ((zero_i, zero_i),)             # observed-work counters

    def finish(final):
        prim, t_best = final[4], final[3]
        hit = prim >= 0
        inst = final[12] if instanced else jnp.full(bs, -1, jnp.int32)
        cnt_rows, cnt_tri = final[-1]
        return (hit, jnp.where(hit, t_best, INFINITY),
                jnp.maximum(prim, 0), jnp.where(hit, inst, -1),
                jnp.stack([jnp.sum(cnt_rows), jnp.sum(cnt_tri)]))

    def run(init):
        flat = len(bs) == 1 and bs[0] >= 4 * TAIL_FRACTION
        if not flat:
            final = jax.lax.while_loop(lambda s: jnp.any(~s[5]), body, init)
            return finish(final)
        state = jax.lax.fori_loop(0, MAJORITY_ITERS,
                                  lambda i, s: body(s), init)
        B = bs[0]
        Bt = B // TAIL_FRACTION

        def drain_round(s):
            order = jnp.argsort(s[5])            # unfinished lanes first
            sel = order[:Bt]
            sub = jax.tree.map(lambda x: x[sel], s)
            sub = jax.lax.while_loop(lambda s2: jnp.any(~s2[5]), body, sub)
            return jax.tree.map(lambda full, st: full.at[sel].set(st),
                                s, sub)

        final = jax.lax.while_loop(lambda s: jnp.any(~s[5]), drain_round,
                                   state)
        return finish(final)

    # a fully-dead wavefront (masked-out shadow probes, final-bounce NEE)
    # must not pay even the majority pass
    def dead(init):
        return (jnp.zeros(bs, bool), jnp.full(bs, INFINITY),
                jnp.zeros(bs, jnp.int32), jnp.full(bs, -1, jnp.int32),
                jnp.zeros(2, jnp.int32))

    return jax.lax.cond(jnp.any(ray.t_max > 0.0), run, dead, init)


def bvh16_intersect_triangles(tables, ray):
    """Closest hit over the wide BVH: (hit, t, tri_id)."""
    hit, t, tid, _, _ = _traverse16(tables, ray, any_hit=False)
    return hit, t, tid


def bvh16_intersect_triangles_inst(tables, ray):
    """Closest hit with instancing: (hit, t, tri_id, instance_id).
    instance_id is -1 for static-geometry hits."""
    return _traverse16(tables, ray, any_hit=False)[:4]


def bvh16_intersect_p_triangles(tables, ray):
    hit = _traverse16(tables, ray, any_hit=True)[0]
    return hit


def bvh16_intersect_counts(tables, ray, any_hit=False):
    """Observed-work variant for tools and tests: (hit, t, tri_id,
    instance_id, counts[rows_gathered, triangle_tests])."""
    return _traverse16(tables, ray, any_hit=any_hit)
