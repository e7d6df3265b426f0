"""Host-side BVH construction → flattened node arrays.

Reference: rustracer-core/src/bvh/mod.rs — BVHPrimitiveInfo centroids
(88-93), top-down build with Middle / 12-bucket SAH splits (202-287), and
flattening to a LinearBVHNode array with second_child_offset (314-358).

The build runs on host (numpy, iterative with an explicit stack, vectorized
bucket binning per node). The BVH covers TRIANGLES only — quadric counts are
tiny and stay brute-force (scene/tables.py), which keeps the traversal
kernel's per-leaf test homogeneous (pure watertight triangle tests).

Flattened layout (device arrays):
  bvh_lo/bvh_hi: (N, 3) node AABBs
  bvh_meta:      (N, 3) int32 [leaf: prim_offset, n_prims, axis]
                        [interior: second_child_offset, 0, axis]
  bvh_prims:     (P,) int32 triangle ids in leaf order
"""
from __future__ import annotations

import numpy as np

N_BUCKETS = 12
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


def triangle_bounds(tv_p, t_idx):
    p0 = tv_p[t_idx[:, 0]]
    p1 = tv_p[t_idx[:, 1]]
    p2 = tv_p[t_idx[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    return lo, hi


def build_bvh(lo, hi, split_method="sah", max_prims=4):
    """Build over primitive AABBs → (nodes_lo, nodes_hi, meta, prim_order)."""
    n = lo.shape[0]
    centroids = 0.5 * (lo + hi)
    order = np.arange(n)

    # output arrays, grown geometrically
    cap = max(2 * n, 16)
    nodes_lo = np.zeros((cap, 3), np.float32)
    nodes_hi = np.zeros((cap, 3), np.float32)
    meta = np.zeros((cap, 3), np.int32)
    n_nodes = 0
    prim_out = []

    def alloc():
        nonlocal n_nodes, cap, nodes_lo, nodes_hi, meta
        if n_nodes >= cap:
            cap *= 2
            nodes_lo = np.resize(nodes_lo, (cap, 3))
            nodes_hi = np.resize(nodes_hi, (cap, 3))
            meta = np.resize(meta, (cap, 3))
        i = n_nodes
        n_nodes += 1
        return i

    # stack entries: (node_idx, start, end) over `order`; parent linkage is
    # resolved with a second pass storing (parent, is_second) per node
    # Simpler: recursive via explicit stack emitting nodes in DFS order so
    # that child1 = node+1 and child2 offset is patched after child1 subtree.
    def emit(start, end):
        """DFS-emit subtree over order[start:end]; returns node index."""
        idx = alloc()
        sl = order[start:end]
        b_lo = lo[sl].min(0)
        b_hi = hi[sl].max(0)
        nodes_lo[idx] = b_lo
        nodes_hi[idx] = b_hi
        count = end - start

        def make_leaf():
            # hard cap: the traversal kernel statically unrolls max_prims
            # tests per leaf, so degenerate splits chain into a subtree
            if count > max_prims:
                mid = count // 2
                emit(start, start + mid)
                c2 = emit(start + mid, end)
                meta[idx] = (c2, 0, 0)
                return idx
            off = len(prim_out)
            prim_out.extend(sl.tolist())
            meta[idx] = (off, count, 0)
            return idx

        if count <= 1:
            return make_leaf()
        c = centroids[sl]
        c_lo = c.min(0)
        c_hi = c.max(0)
        dim = int(np.argmax(c_hi - c_lo))
        if c_hi[dim] - c_lo[dim] < 1e-12:
            return make_leaf()

        if split_method == "middle":
            pmid = 0.5 * (c_lo[dim] + c_hi[dim])
            mask = c[:, dim] < pmid
            mid = int(mask.sum())
            if mid == 0 or mid == count:
                # fall back to equal-counts (bvh/mod.rs:183-199)
                ordr = np.argsort(c[:, dim], kind="stable")
                order[start:end] = sl[ordr]
                mid = count // 2
            else:
                order[start:end] = np.concatenate([sl[mask], sl[~mask]])
        else:  # sah (bvh/mod.rs:202-287) with equal-counts for tiny nodes
            if count <= max_prims:
                return make_leaf()
            if count <= 2:
                ordr = np.argsort(c[:, dim], kind="stable")
                order[start:end] = sl[ordr]
                mid = count // 2
            else:
                extent = c_hi[dim] - c_lo[dim]
                b = np.minimum((N_BUCKETS * (c[:, dim] - c_lo[dim]) /
                                extent).astype(np.int32), N_BUCKETS - 1)
                # per-bucket bounds + counts (vectorized)
                cnt = np.bincount(b, minlength=N_BUCKETS)
                blo = np.full((N_BUCKETS, 3), np.inf, np.float32)
                bhi = np.full((N_BUCKETS, 3), -np.inf, np.float32)
                np.minimum.at(blo, b, lo[sl])
                np.maximum.at(bhi, b, hi[sl])
                # prefix/suffix areas
                def area(l, h):
                    d = np.maximum(h - l, 0.0)
                    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                                  + d[:, 2] * d[:, 0])
                pre_lo = np.minimum.accumulate(blo, 0)
                pre_hi = np.maximum.accumulate(bhi, 0)
                suf_lo = np.minimum.accumulate(blo[::-1], 0)[::-1]
                suf_hi = np.maximum.accumulate(bhi[::-1], 0)[::-1]
                cnt_pre = np.cumsum(cnt)
                cnt_suf = np.cumsum(cnt[::-1])[::-1]
                cost = np.full(N_BUCKETS - 1, np.inf, np.float32)
                d_node = np.maximum(b_hi - b_lo, 0.0)
                sa_node = max(2.0 * (d_node[0] * d_node[1] + d_node[1] * d_node[2]
                                     + d_node[2] * d_node[0]), 1e-20)
                a0 = area(pre_lo[:-1], pre_hi[:-1])
                a1 = area(suf_lo[1:], suf_hi[1:])
                valid = (cnt_pre[:-1] > 0) & (cnt_suf[1:] > 0)
                cost[valid] = TRAVERSAL_COST + INTERSECT_COST * (
                    cnt_pre[:-1][valid] * a0[valid]
                    + cnt_suf[1:][valid] * a1[valid]) / sa_node
                best = int(np.argmin(cost))
                # Leaf policy differs from the reference (bvh/mod.rs:262-287,
                # which splits whenever SAH beats leaf_cost = count): the
                # traversal kernel statically unrolls max_prims triangle
                # tests per leaf VISIT, so a 1-tri leaf costs the same as a
                # full one — pack leaves full and only split above max_prims.
                if count > max_prims:
                    mask = b <= best
                    mid = int(mask.sum())
                    if mid == 0 or mid == count:
                        return make_leaf()
                    order[start:end] = np.concatenate([sl[mask], sl[~mask]])
                else:
                    return make_leaf()

        # interior node: emit children (DFS — child1 follows immediately)
        emit(start, start + mid)
        c2 = emit(start + mid, end)
        meta[idx] = (c2, 0, dim)
        return idx

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.log2(n + 1)) * 64))
    try:
        emit(0, n)
    finally:
        sys.setrecursionlimit(old_limit)
    return (nodes_lo[:n_nodes].copy(), nodes_hi[:n_nodes].copy(),
            meta[:n_nodes].copy(), np.asarray(prim_out, np.int32))


def thread_bvh(meta, leaf_id):
    """Per-octant stackless threading: (hit, miss) links, both (8, N) int32.

    For each of the 8 ray-direction octants we thread the tree in near-first
    DFS order (the same visit order as the reference's stack traversal,
    bvh/mod.rs:366-433, ordered by dir_is_neg[axis]):
      hit[i]  = near child (interior) / = miss (leaf: test prims, move on)
      miss[i] = DFS successor skipping i's subtree (-1 terminates)
    Stackless traversal then needs only a node pointer per lane — no
    (depth, lanes) stack state in the wavefront loop.

    Vectorized via pointer doubling: a node's miss link is the far sibling
    of its lowest ancestor-or-self that is a NEAR child (or -1 if that
    chain hits the root).
    """
    n = meta.shape[0]
    is_leaf = meta[:, 1] > 0
    axis = meta[:, 2].astype(np.int32)
    c2 = meta[:, 0].astype(np.int32)
    interior = ~is_leaf

    # parent of child1 (= i+1) and child2
    parent = np.full(n, -1, np.int32)
    ii = np.where(interior)[0].astype(np.int32)
    parent[ii + 1] = ii
    parent[c2[ii]] = ii

    idx = np.arange(n, dtype=np.int32)
    hit = np.zeros((8, n), np.int32)
    miss = np.full((8, n), -1, np.int32)
    safe_parent = np.maximum(parent, 0)
    pax = axis[safe_parent]
    pc1 = safe_parent + 1
    pc2 = c2[safe_parent]
    for o in range(8):
        neg_p = ((o >> pax) & 1).astype(bool)        # parent's dir_is_neg
        near_p = np.where(neg_p, pc2, pc1)           # parent's near child
        far_p = np.where(neg_p, pc1, pc2)
        is_near = (idx == near_p) & (parent >= 0)
        # pointer-double to the lowest near-child ancestor-or-self
        anchor = np.where(is_near | (parent < 0), idx, parent)
        for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
            anchor = anchor[anchor]
        m = np.where(is_near[anchor], far_p[anchor], -1).astype(np.int32)
        m[0] = -1
        neg = ((o >> axis) & 1).astype(bool)
        near = np.where(neg, c2, idx + 1)
        miss[o] = m
        hit[o] = np.where(interior, near, m)
    return hit, miss


def pack_threaded(nodes_lo, nodes_hi, meta, leaf_id):
    """(8*N, 8) float32 per-octant threaded node records for the traversal
    kernel: [lo.xyz, hi.xyz, w6, w7] where
      w6 (int32 bits) = leaf: leaf_id | 1<<31 (negative); interior: hit link
      w7 (int32 bits) = miss link
    Links are pre-offset into the octant's own copy (oct*N + target), so the
    kernel's node pointer indexes this array directly with no per-step add;
    -1 stays the terminate sentinel."""
    n = meta.shape[0]
    hit, miss = thread_bvh(meta, leaf_id)
    is_leaf = meta[:, 1] > 0
    out = np.zeros((8, n, 8), np.float32)
    out[:, :, 0:3] = nodes_lo[None]
    out[:, :, 3:6] = nodes_hi[None]
    for o in range(8):
        off = np.int32(o * n)
        h = np.where(hit[o] >= 0, hit[o] + off, -1).astype(np.int32)
        m = np.where(miss[o] >= 0, miss[o] + off, -1).astype(np.int32)
        w6 = np.where(is_leaf,
                      (leaf_id | np.int32(-2**31)).astype(np.int32), h)
        out[o, :, 6] = w6.view(np.float32)
        out[o, :, 7] = m.view(np.float32)
    return out.reshape(8 * n, 8)


def build_bvh_arrays(quad, tris, split_method="sah", max_prims=4):
    """→ dict of bvh_* arrays for make_geometry. Triangle-only BVH;
    returns None-equivalent (no dict) when there are no triangles."""
    if tris is None or len(tris["t_idx"]) == 0:
        return None
    if split_method not in ("sah", "middle"):
        # reference supports sah/middle; hlbvh/equal fall back to sah
        split_method = "sah"
    # the traversal kernel statically unrolls 4 tests per leaf
    max_prims = min(max_prims, 4)
    lo, hi = triangle_bounds(tris["tv_p"], tris["t_idx"])
    # native (C++) builder when available; NumPy fallback otherwise
    from rustracer_tpu.native import build_bvh_native
    built = build_bvh_native(lo, hi, split_method, max_prims)
    if built is None:
        built = build_bvh(lo, hi, split_method, max_prims)
    nodes_lo, nodes_hi, meta, prims = built

    # --- pack for device traversal ---
    # Packed for gathers that cost per *gather op* rather than per byte:
    # each node is one 32-byte record and each leaf is one 160-byte record
    # holding its ≤4 baked triangles; the traversal kernel issues exactly
    # two gathers per step instead of ~50.
    import numpy as np
    n_nodes = meta.shape[0]
    is_leaf = meta[:, 1] > 0
    leaf_idx = np.where(is_leaf)[0]
    L = max(1, len(leaf_idx))
    child = meta[:, 0].astype(np.int32).copy()
    child[leaf_idx] = np.arange(len(leaf_idx), dtype=np.int32)

    packed = np.zeros((n_nodes, 8), np.float32)
    packed[:, 0:3] = nodes_lo
    packed[:, 3:6] = nodes_hi
    packed[:, 6] = child.view(np.float32)
    mp = ((meta[:, 1].astype(np.int32) << 2)
          | meta[:, 2].astype(np.int32)).astype(np.int32)
    packed[:, 7] = mp.view(np.float32)

    # leaf records: 4 x [p0.xyz p1.xyz p2.xyz tid] (tid = -1 pads)
    t_idx_arr = np.asarray(tris["t_idx"])
    tv_p = np.asarray(tris["tv_p"], np.float32)
    counts = meta[leaf_idx, 1].astype(np.int64) if len(leaf_idx) else \
        np.zeros(0, np.int64)
    offs = meta[leaf_idx, 0].astype(np.int64) if len(leaf_idx) else \
        np.zeros(0, np.int64)
    leaf_packed = np.zeros((L, 40), np.float32)
    tids = np.full((L, 4), -1, np.int32)
    for k in range(4):
        valid = counts > k
        tids[:len(leaf_idx)][valid, k] = prims[offs[valid] + k]
    safe = np.maximum(tids, 0)
    verts = tv_p[t_idx_arr[safe]]            # (L, 4, 3, 3)
    verts[tids < 0] = 0.0                    # degenerate → never hits
    for k in range(4):
        leaf_packed[:, k * 10:k * 10 + 9] = verts[:, k].reshape(L, 9)
        leaf_packed[:, k * 10 + 9] = tids[:, k].view(np.float32)

    threaded = pack_threaded(nodes_lo, nodes_hi, meta, child)
    out = dict(bvh_lo=nodes_lo, bvh_hi=nodes_hi, bvh_meta=meta,
               bvh_prims=prims, bvh_nodes_packed=packed,
               bvh_leaf_packed=leaf_packed, bvh_threaded=threaded)
    # 16-wide structure (accel/wide.py) — the device hot path; the binary
    # arrays above remain for tests/fallback
    from .wide import build_wide_arrays
    wide = build_wide_arrays(tris, split_method)
    if wide is not None:
        out.update(wide)
    return out
