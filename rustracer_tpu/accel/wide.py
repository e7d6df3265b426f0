"""Host-side 16-wide BVH build: collapse the binary SAH tree, pack 128-float
node/leaf records, order children per ray octant.

Why 16-wide: the traversal was designed for a machine on which an
incoherent gather costs about one ROW per lane-step whatever the row width,
so its throughput is set by ROWS PER RAY. A binary threaded tree needs
~100-190 rows/ray (accel/traverse.py); a 16-ary tree with 8-triangle leaves
needs ~12-25: one 128-float record carries either 16 child AABBs + links or
8 full triangles. Whether that trade holds on H100, with its caches, is not
yet measured. This replaces the reference's binary stack traversal (rustracer-core/src/bvh/mod.rs:366-433);
the SAH build itself (accel/bvh.py / native builder) is reused and collapsed.

Unified record table, (R, 128) float32, three record types by tag (word 0,
int32 bits):
  interior record (0 <= tag <= 16, tag = n_children):
    [0]       tag
    [1..17)   16 child row links (int32 bits; -1 = empty slot), pre-offset
              into the octant copy for interior children, absolute for
              leaf/instance children
    [17..113) child AABBs, component-major: lo_x[16] lo_y[16] lo_z[16]
              hi_x[16] hi_y[16] hi_z[16]  (empty slots = +inf/-inf never-hit)
  leaf record (tag < 0, -tag = n_tris <= 8):
    [0]       tag
    [1..9)    8 triangle ids (int32 bits; -1 pads)
    [9..81)   vertices component-major: p0x[8] p0y[8] p0z[8] p1x[8] ...
              p2z[8] (pad tris = degenerate zeros, never hit)
  instance record (tag >= TAG_INST, reference primitive.rs:89-118
  TransformedPrimitive — shared sub-BVH entered through a ray transform):
    [0]       tag = TAG_INST
    [1..9)    8 per-octant BLAS root rows (absolute, int32 bits) — the lane
              picks by its OBJECT-space direction octant
    [9]       instance id (int32 bits) into the inst_o2w/inst_w2o tables
    [10..22)  world-to-object transform, rows 0..2 row-major (12 floats)

Row layout (single tree): rows [o*Ni, (o+1)*Ni) hold octant o's interior
copy (children sorted near-to-far along the octant direction); a SHARED
leaf/instance block follows. Octant o's root is row o*Ni. Instanced scenes
(build_wide_scene) append per-object BLAS blocks after the TLAS: each BLAS
is its own 8-octant-copy + shared-leaf unit, entered via instance records.
Memory per object is O(8 x interiors + leaves) regardless of instance count.
"""
from __future__ import annotations

import numpy as np

WIDTH = 16        # children per interior node
LEAF_K = 8        # triangles per leaf record
REC = 128         # floats per record row
TAG_INST = 1 << 20


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def collapse_wide(nodes_lo, nodes_hi, meta):
    """Binary flattened BVH (accel/bvh.py layout) → wide tree.

    Returns (wide_children, wide_is_leaf_child, wide_of_binary, depth):
      wide_children: list of lists of binary-node ids (each a child subtree
        root that is either collapsed into its own wide node or is a binary
        leaf)
    Expansion is hybrid: absorb a small subtree WHOLE when its leaves fit in
    the remaining slots (prefer the smallest such), else split the LARGEST
    subtree (drives the top of the tree toward 16 balanced branches). Pure
    largest-area expansion left the bottom as 2-3-child nodes (mean 6.5
    children); pure smallest-first built depth-15 chains. The hybrid measures
    ~15 mean children at depth ~5.
    """
    is_leaf = meta[:, 1] > 0
    c2 = meta[:, 0]
    n = meta.shape[0]
    # descendant-leaf counts, bottom-up (children follow parents in the DFS
    # flattening, so a reverse sweep sees children first)
    leaf_cnt = np.where(is_leaf, 1, 0).astype(np.int64)
    for i in range(n - 1, -1, -1):
        if not is_leaf[i]:
            leaf_cnt[i] = leaf_cnt[i + 1] + leaf_cnt[c2[i]]

    wide_children = []          # per wide node: list of binary ids
    wide_child_leaf = []        # per wide node: parallel bools
    todo = [0]                  # binary roots that become wide nodes
    wide_of_binary = {}
    depth_of = {0: 0}
    max_depth = 0
    while todo:
        b = todo.pop()
        if b in wide_of_binary:
            continue
        wid = len(wide_children)
        wide_of_binary[b] = wid
        if is_leaf[b]:
            # shouldn't happen for roots (callers wrap leaf roots)
            wide_children.append([b])
            wide_child_leaf.append([True])
            continue
        kids = [int(b) + 1, int(c2[b])]
        while len(kids) < WIDTH:
            room = WIDTH - (len(kids) - 1)
            best, best_c = -1, None
            for i, k in enumerate(kids):
                if is_leaf[k]:
                    continue
                if leaf_cnt[k] <= room and (best_c is None
                                            or leaf_cnt[k] < best_c):
                    best, best_c = i, leaf_cnt[k]
            if best < 0:
                for i, k in enumerate(kids):
                    if not is_leaf[k] and (best_c is None
                                           or leaf_cnt[k] > best_c):
                        best, best_c = i, leaf_cnt[k]
            if best < 0:
                break
            k = kids.pop(best)
            kids.extend([k + 1, int(c2[k])])
        wide_children.append(kids)
        wide_child_leaf.append([bool(is_leaf[k]) for k in kids])
        d = depth_of[b] + 1
        for k, lf in zip(kids, wide_child_leaf[-1]):
            if not lf:
                todo.append(k)
                depth_of[k] = d
                max_depth = max(max_depth, d)
    return wide_children, wide_child_leaf, wide_of_binary, max_depth + 1


def _gather_leaf_tris(meta, prims, binary_leaves):
    """Binary leaf ids → (tids (L, 8) int32 padded -1). Binary leaves hold
    ≤ LEAF_K prims when the binary build uses max_prims=LEAF_K."""
    L = len(binary_leaves)
    tids = np.full((L, LEAF_K), -1, np.int32)
    for j, b in enumerate(binary_leaves):
        off, cnt = int(meta[b, 0]), int(meta[b, 1])
        assert cnt <= LEAF_K, f"binary leaf has {cnt} > {LEAF_K} prims"
        tids[j, :cnt] = prims[off:off + cnt]
    return tids


def _leaf_records(tids, tv_p, t_idx):
    """(L, 8) padded tri ids → (L, REC) leaf records with baked vertices."""
    Nl = tids.shape[0]
    rec = np.zeros((Nl, REC), np.float32)
    if Nl == 0:
        return rec
    ntri = (tids >= 0).sum(1).astype(np.int32)
    rec[:, 0] = (-ntri).view(np.float32)
    rec[:, 1:9] = tids.view(np.float32)
    safe = np.maximum(tids, 0)
    verts = tv_p[t_idx[safe]].astype(np.float32)   # (L, 8, 3, 3)
    verts[tids < 0] = 0.0
    # component-major: p{0,1,2}{x,y,z} blocks of 8
    for v in range(3):
        for c in range(3):
            blk = 9 + (v * 3 + c) * 8
            rec[:, blk:blk + 8] = verts[:, :, v, c]
    return rec


_SIGNS = np.array([[1 - 2 * ((o >> a) & 1) for a in range(3)]
                   for o in range(8)], np.float32)   # (8, 3) octant dirs


def _fill_interiors(table, wide_children, wide_child_leaf, wide_map,
                    nodes_lo, nodes_hi, row_base, leaf_row_of):
    """Write the 8 per-octant interior copies of one collapsed tree into
    `table` at rows [row_base, row_base + 8*Ni). Interior child links are
    pre-offset into the destination octant copy; leaf/instance children
    resolve through `leaf_row_of(binary_id)` (absolute rows). Returns the
    8 octant root rows."""
    Ni = len(wide_children)
    INF = np.float32(np.inf)
    for wid, (kids, lfs) in enumerate(zip(wide_children, wide_child_leaf)):
        k = len(kids)
        klo = nodes_lo[kids]
        khi = nodes_hi[kids]
        cent = 0.5 * (klo + khi)
        links = np.empty(k, np.int32)
        interior = np.empty(k, bool)
        for j, (b, lf) in enumerate(zip(kids, lfs)):
            if lf:
                links[j] = leaf_row_of(b)
                interior[j] = False
            else:
                links[j] = wide_map[b]      # local wide id, offset per octant
                interior[j] = True
        for o in range(8):
            key = cent @ _SIGNS[o]
            perm = np.argsort(key, kind="stable")
            rec = table[row_base + o * Ni + wid]
            rec[0] = np.int32(k).view(np.float32)
            lk = links[perm]
            it = interior[perm]
            lk_off = np.where(it, lk + row_base + o * Ni, lk).astype(np.int32)
            lnk = np.full(WIDTH, -1, np.int32)
            lnk[:k] = lk_off
            rec[1:17] = lnk.view(np.float32)
            box = np.empty((6, WIDTH), np.float32)
            box[0:3, :] = INF          # empty slots: never-hit boxes
            box[3:6, :] = -INF
            box[0:3, :k] = klo[perm].T
            box[3:6, :k] = khi[perm].T
            rec[17:113] = box.reshape(-1)
    return row_base + np.arange(8, dtype=np.int32) * Ni


def _collapse_or_wrap(nodes_lo, nodes_hi, meta):
    """collapse_wide, wrapping a leaf-only binary tree in a 1-child wide
    interior so every tree has an interior root."""
    if meta[0, 1] > 0:
        return [[0]], [[True]], {0: 0}, 2
    return collapse_wide(nodes_lo, nodes_hi, meta)


def pack_wide(nodes_lo, nodes_hi, meta, prims, tv_p, t_idx):
    """Single-tree build → dict(bvh16_table (R,128) f32, bvh16_roots (8,)
    i32, bvh16_depth int, + identity instance tables)."""
    wc, wl, wmap, depth = _collapse_or_wrap(nodes_lo, nodes_hi, meta)
    Ni = len(wc)

    leaf_rows = {}
    binary_leaves = []
    for kids, lfs in zip(wc, wl):
        for b, lf in zip(kids, lfs):
            if lf and b not in leaf_rows:
                leaf_rows[b] = len(binary_leaves)
                binary_leaves.append(b)
    Nl = len(binary_leaves)
    tids = _gather_leaf_tris(meta, prims, binary_leaves)
    leaf_base = 8 * Ni
    table = np.zeros((8 * Ni + max(Nl, 1), REC), np.float32)
    roots = _fill_interiors(table, wc, wl, wmap, nodes_lo, nodes_hi, 0,
                            lambda b: leaf_base + leaf_rows[b])
    table[leaf_base:leaf_base + Nl] = _leaf_records(tids, tv_p, t_idx)
    return dict(bvh16_table=table, bvh16_roots=roots,
                bvh16_depth=np.int32(depth), **_identity_instances())


def _identity_instances():
    return dict(inst_o2w=np.eye(4, dtype=np.float32)[None],
                inst_w2o=np.eye(4, dtype=np.float32)[None],
                inst_flip=np.zeros(1, bool))


def _build_binary(lo, hi, split_method, max_prims):
    from rustracer_tpu.native import build_bvh_native
    built = build_bvh_native(lo, hi, split_method, max_prims)
    if built is None:
        from .bvh import build_bvh
        built = build_bvh(lo, hi, split_method, max_prims=max_prims)
    return built


def build_wide_arrays(tris, split_method="sah"):
    """Full pipeline: binary SAH build (max_prims=LEAF_K) → collapse →
    packed wide arrays. Returns None when there are no triangles."""
    if tris is None or len(tris["t_idx"]) == 0:
        return None
    from .bvh import triangle_bounds
    lo, hi = triangle_bounds(np.asarray(tris["tv_p"]),
                             np.asarray(tris["t_idx"]))
    nodes_lo, nodes_hi, meta, prims = _build_binary(lo, hi, split_method,
                                                    LEAF_K)
    return pack_wide(nodes_lo, nodes_hi, meta, prims,
                     np.asarray(tris["tv_p"], np.float32),
                     np.asarray(tris["t_idx"]))


def _xform_aabb(o2w, lo, hi):
    """World AABB of an object-space AABB under a 4x4 affine transform."""
    cs = np.array([[x, y, z] for x in (lo[0], hi[0])
                   for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                  np.float32)
    w = cs @ o2w[:3, :3].T + o2w[:3, 3]
    return w.min(0), w.max(0)


def build_wide_scene(tris, objects, instances, split_method="sah"):
    """Two-level wide BVH for instanced scenes.

    tris: the FULL global triangle dict — static world-space triangles
      first (rows [0, n_static)), then each object's OBJECT-space triangles.
    objects: list of (tri_lo, tri_hi) global row ranges, one per unique
      instanced object (reference api.rs:1019-1090 named instances).
    instances: list of dicts {obj: int, o2w: (4,4), w2o: (4,4), flip: bool}.

    Returns bvh16_* arrays plus inst_o2w/inst_w2o/inst_flip tables. TLAS
    leaves are static-triangle leaf records and per-instance instance
    records; each object's BLAS (8 octant copies + shared leaves, built
    over object-space bounds) appears once.
    """
    tv_p = np.asarray(tris["tv_p"], np.float32)
    t_idx = np.asarray(tris["t_idx"])
    n_static = objects[0][0] if objects else t_idx.shape[0]

    from .bvh import triangle_bounds

    # --- per-object BLAS collapse (object space) ---
    blas = []
    for (alo, ahi) in objects:
        lo, hi = triangle_bounds(tv_p, t_idx[alo:ahi])
        nl, nh, meta, prims = _build_binary(lo, hi, split_method, LEAF_K)
        prims = prims + alo                     # global tri ids
        wc, wl, wmap, dep = _collapse_or_wrap(nl, nh, meta)
        blas.append(dict(nl=nl, nh=nh, meta=meta, prims=prims, wc=wc,
                         wl=wl, wmap=wmap, depth=dep,
                         obj_lo=nl[0], obj_hi=nh[0]))

    # --- instance tables + world AABBs ---
    I = len(instances)
    inst_o2w = np.stack([np.asarray(r["o2w"], np.float32)
                         for r in instances]) if I else \
        np.eye(4, dtype=np.float32)[None]
    inst_w2o = np.stack([np.asarray(r["w2o"], np.float32)
                         for r in instances]) if I else \
        np.eye(4, dtype=np.float32)[None]
    inst_flip = np.array([bool(r.get("flip", False)) for r in instances],
                         bool) if I else np.zeros(1, bool)
    ilo = np.empty((I, 3), np.float32)
    ihi = np.empty((I, 3), np.float32)
    for i, r in enumerate(instances):
        b = blas[r["obj"]]
        ilo[i], ihi[i] = _xform_aabb(inst_o2w[i], b["obj_lo"], b["obj_hi"])

    # --- instance micro-tree (each binary leaf = ONE instance record) ---
    inl, inh, imeta, iprims = _build_binary(ilo, ihi, split_method, 1)
    iwc, iwl, iwmap, idep = _collapse_or_wrap(inl, inh, imeta)

    # --- static-triangle tree ---
    has_static = n_static > 0
    if has_static:
        slo, shi = triangle_bounds(tv_p, t_idx[:n_static])
        snl, snh, smeta, sprims = _build_binary(slo, shi, split_method,
                                                LEAF_K)
        swc, swl, swmap, sdep = _collapse_or_wrap(snl, snh, smeta)
    else:
        sdep = 0

    # --- row allocation ---
    # [root 8x1][static interiors 8xNs][inst-tree interiors 8xNv]
    # [static leaves][instance records][per-obj: interiors 8xNi + leaves]
    Ns = len(swc) if has_static else 0
    Nv = len(iwc)
    root_base = 0
    static_base = 8 * 1
    itree_base = static_base + 8 * Ns
    cursor = itree_base + 8 * Nv

    def collect_leaves(wc, wl):
        rows, order = {}, []
        for kids, lfs in zip(wc, wl):
            for b, lf in zip(kids, lfs):
                if lf and b not in rows:
                    rows[b] = len(order)
                    order.append(b)
        return rows, order

    if has_static:
        sleaf_rows, sleaves = collect_leaves(swc, swl)
        static_leaf_base = cursor
        cursor += len(sleaves)
    ileaf_rows, ileaves = collect_leaves(iwc, iwl)
    inst_rec_base = cursor
    cursor += len(ileaves)
    blas_bases = []
    blas_leaf_bases = []
    for b in blas:
        b["leaf_rows"], b["leaves"] = collect_leaves(b["wc"], b["wl"])
        blas_bases.append(cursor)
        cursor += 8 * len(b["wc"])
        blas_leaf_bases.append(cursor)
        cursor += len(b["leaves"])

    table = np.zeros((max(cursor, 2), REC), np.float32)

    # --- fill BLAS blocks ---
    for b, base, lbase in zip(blas, blas_bases, blas_leaf_bases):
        _fill_interiors(table, b["wc"], b["wl"], b["wmap"], b["nl"], b["nh"],
                        base, lambda bb, _b=b, _l=lbase:
                        _l + _b["leaf_rows"][bb])
        tids = _gather_leaf_tris(b["meta"], b["prims"], b["leaves"])
        table[lbase:lbase + len(b["leaves"])] = _leaf_records(tids, tv_p,
                                                              t_idx)
        b["roots8"] = base + np.arange(8, dtype=np.int32) * len(b["wc"])

    # --- instance records ---
    for j, b_leaf in enumerate(ileaves):
        off, cnt = int(imeta[b_leaf, 0]), int(imeta[b_leaf, 1])
        assert cnt == 1
        i = int(iprims[off])
        rec = table[inst_rec_base + j]
        rec[0] = np.int32(TAG_INST).view(np.float32)
        rec[1:9] = blas[instances[i]["obj"]]["roots8"].view(np.float32)
        rec[9] = np.int32(i).view(np.float32)
        rec[10:22] = inst_w2o[i][:3, :].reshape(-1)

    # --- TLAS interior copies ---
    iroots = _fill_interiors(table, iwc, iwl, iwmap, inl, inh, itree_base,
                             lambda b: inst_rec_base + ileaf_rows[b])
    if has_static:
        sroots = _fill_interiors(table, swc, swl, swmap, snl, snh,
                                 static_base,
                                 lambda b: static_leaf_base + sleaf_rows[b])
        stids = _gather_leaf_tris(smeta, sprims, sleaves)
        table[static_leaf_base:static_leaf_base + len(sleaves)] = \
            _leaf_records(stids, tv_p, t_idx)

    # --- root: one 1-2 child interior per octant ---
    INF = np.float32(np.inf)
    kids_lo = [inl[0]]
    kids_hi = [inh[0]]
    if has_static:
        kids_lo.append(snl[0])
        kids_hi.append(snh[0])
    for o in range(8):
        rec = table[o]
        links = [int(iroots[o])] + ([int(sroots[o])] if has_static else [])
        k = len(links)
        rec[0] = np.int32(k).view(np.float32)
        lnk = np.full(WIDTH, -1, np.int32)
        lnk[:k] = links
        rec[1:17] = lnk.view(np.float32)
        box = np.empty((6, WIDTH), np.float32)
        box[0:3, :] = INF
        box[3:6, :] = -INF
        box[0:3, :k] = np.stack(kids_lo).T
        box[3:6, :k] = np.stack(kids_hi).T
        rec[17:113] = box.reshape(-1)
    roots = np.arange(8, dtype=np.int32)  # root copies are rows 0..7

    max_blas = max((b["depth"] for b in blas), default=0)
    depth = max(sdep, idep + max_blas) + 2
    if inst_o2w.shape[0] < 2:
        # has_instances is a static SHAPE check (> 1): pad a single-instance
        # table with an unused identity row
        inst_o2w = np.concatenate([inst_o2w,
                                   np.eye(4, dtype=np.float32)[None]])
        inst_w2o = np.concatenate([inst_w2o,
                                   np.eye(4, dtype=np.float32)[None]])
        inst_flip = np.concatenate([inst_flip, np.zeros(1, bool)])
    return dict(bvh16_table=table, bvh16_roots=roots,
                bvh16_depth=np.int32(depth),
                inst_o2w=inst_o2w, inst_w2o=inst_w2o, inst_flip=inst_flip)
