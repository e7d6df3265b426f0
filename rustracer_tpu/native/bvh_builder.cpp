// Native SAH BVH builder — the host-side "native runtime" piece of the
// framework (scene build is host work; traversal runs on the device).
//
// Mirrors the semantics of rustracer_tpu/accel/bvh.py::build_bvh, which in
// turn follows the reference builder (rustracer-core/src/bvh/mod.rs:202-287:
// top-down, 12-bucket binned SAH with Middle/equal-counts fallbacks,
// flattened to a LinearBVHNode-style array in DFS preorder so child1 = idx+1
// and child2 is stored in meta, bvh/mod.rs:314-358).
//
// Exposed via ctypes (see rustracer_tpu/native/__init__.py). The caller
// preallocates the outputs: a binary tree over n primitives with >=1 prim
// per leaf has at most 2n-1 nodes.
//
// Build: g++ -O3 -shared -fPIC -o _bvh_builder.so bvh_builder.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_BUCKETS = 12;
constexpr float TRAVERSAL_COST = 1.0f;
constexpr float INTERSECT_COST = 1.0f;

struct V3 {
    float x, y, z;
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 vmin(V3 a, V3 b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(V3 a, V3 b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_area(V3 lo, V3 hi) {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
}

struct Task {
    int32_t start, end;   // range over `order`
    int32_t parent;       // node whose meta[0] (second_child) we patch
    uint8_t second;       // are we the second child of `parent`?
};

}  // namespace

extern "C" {

// split_method: 0 = sah, 1 = middle.
// Outputs (preallocated by caller):
//   nodes_lo/nodes_hi: (2n, 3) float32
//   meta:              (2n, 3) int32  [leaf: off, count, axis=0]
//                                     [interior: child2, 0, axis]
//   prim_order:        (n,)   int32
// Returns the number of nodes emitted, or -1 on bad input.
int build_bvh_sah(const float* lo_in, const float* hi_in, int32_t n,
                  int32_t split_method, int32_t max_prims,
                  float* nodes_lo, float* nodes_hi, int32_t* meta,
                  int32_t* prim_order) {
    if (n <= 0 || max_prims <= 0) return -1;
    const V3* lo = reinterpret_cast<const V3*>(lo_in);
    const V3* hi = reinterpret_cast<const V3*>(hi_in);

    std::vector<V3> centroid(n);
    for (int i = 0; i < n; ++i) {
        centroid[i] = {0.5f * (lo[i].x + hi[i].x),
                       0.5f * (lo[i].y + hi[i].y),
                       0.5f * (lo[i].z + hi[i].z)};
    }
    std::vector<int32_t> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;

    int32_t n_nodes = 0;
    int32_t n_prims_out = 0;
    std::vector<int32_t> scratch(n);

    std::vector<Task> stack;
    stack.reserve(128);
    stack.push_back({0, n, -1, 0});

    while (!stack.empty()) {
        Task t = stack.back();
        stack.pop_back();
        const int32_t idx = n_nodes++;
        if (t.second) meta[3 * t.parent + 0] = idx;

        int32_t* sl = order.data() + t.start;
        const int32_t count = t.end - t.start;

        V3 b_lo = lo[sl[0]], b_hi = hi[sl[0]];
        V3 c_lo = centroid[sl[0]], c_hi = centroid[sl[0]];
        for (int32_t i = 1; i < count; ++i) {
            b_lo = vmin(b_lo, lo[sl[i]]);
            b_hi = vmax(b_hi, hi[sl[i]]);
            c_lo = vmin(c_lo, centroid[sl[i]]);
            c_hi = vmax(c_hi, centroid[sl[i]]);
        }
        nodes_lo[3 * idx + 0] = b_lo.x;
        nodes_lo[3 * idx + 1] = b_lo.y;
        nodes_lo[3 * idx + 2] = b_lo.z;
        nodes_hi[3 * idx + 0] = b_hi.x;
        nodes_hi[3 * idx + 1] = b_hi.y;
        nodes_hi[3 * idx + 2] = b_hi.z;

        // leaf emission, chaining oversized leaves into axis-0 interior
        // splits so the traversal kernel's static <=max_prims unroll holds
        auto make_leaf = [&]() {
            if (count > max_prims) {
                int32_t mid = count / 2;
                meta[3 * idx + 0] = 0;  // patched by child2
                meta[3 * idx + 1] = 0;
                meta[3 * idx + 2] = 0;
                stack.push_back({t.start + mid, t.end, idx, 1});
                stack.push_back({t.start, t.start + mid, idx, 0});
                return;
            }
            meta[3 * idx + 0] = n_prims_out;
            meta[3 * idx + 1] = count;
            meta[3 * idx + 2] = 0;
            std::memcpy(prim_order + n_prims_out, sl,
                        count * sizeof(int32_t));
            n_prims_out += count;
        };

        if (count <= 1) {
            make_leaf();
            continue;
        }
        int dim = 0;
        float ext = c_hi.x - c_lo.x;
        if (c_hi.y - c_lo.y > ext) { dim = 1; ext = c_hi.y - c_lo.y; }
        if (c_hi.z - c_lo.z > ext) { dim = 2; ext = c_hi.z - c_lo.z; }
        if (ext < 1e-12f) {
            make_leaf();
            continue;
        }

        int32_t mid = -1;
        if (split_method == 1) {  // middle (bvh/mod.rs:183-199)
            const float pmid = 0.5f * (c_lo[dim] + c_hi[dim]);
            int32_t* split = std::stable_partition(
                sl, sl + count,
                [&](int32_t p) { return centroid[p][dim] < pmid; });
            mid = static_cast<int32_t>(split - sl);
            if (mid == 0 || mid == count) {
                std::stable_sort(sl, sl + count, [&](int32_t a, int32_t b) {
                    return centroid[a][dim] < centroid[b][dim];
                });
                mid = count / 2;
            }
        } else {  // sah (bvh/mod.rs:202-287), equal-counts for tiny nodes
            // leaf policy parity with accel/bvh.py: the traversal kernel
            // pays a full max_prims-wide test per leaf visit, so pack
            // leaves full instead of splitting below max_prims
            if (count <= max_prims) {
                make_leaf();
                continue;
            }
            if (count <= 2) {
                std::stable_sort(sl, sl + count, [&](int32_t a, int32_t b) {
                    return centroid[a][dim] < centroid[b][dim];
                });
                mid = count / 2;
            } else {
                int32_t cnt[N_BUCKETS] = {0};
                V3 blo[N_BUCKETS], bhi[N_BUCKETS];
                for (int b = 0; b < N_BUCKETS; ++b) {
                    blo[b] = {INFINITY, INFINITY, INFINITY};
                    bhi[b] = {-INFINITY, -INFINITY, -INFINITY};
                }
                // exact arithmetic parity with the NumPy builder
                // (accel/bvh.py): N_BUCKETS * diff, THEN divide by ext,
                // truncate — a reciprocal-multiply can round a centroid
                // into a different bucket at the boundary
                auto bucket_of = [&](int32_t p) {
                    int b = static_cast<int>(
                        (static_cast<float>(N_BUCKETS) *
                         (centroid[p][dim] - c_lo[dim])) / ext);
                    return std::min(b, N_BUCKETS - 1);
                };
                for (int32_t i = 0; i < count; ++i) {
                    const int b = bucket_of(sl[i]);
                    ++cnt[b];
                    blo[b] = vmin(blo[b], lo[sl[i]]);
                    bhi[b] = vmax(bhi[b], hi[sl[i]]);
                }
                // prefix/suffix sweep over the N_BUCKETS-1 candidate splits
                float a0[N_BUCKETS - 1], a1[N_BUCKETS - 1];
                int32_t c0[N_BUCKETS - 1], c1[N_BUCKETS - 1];
                {
                    V3 run_lo = blo[0], run_hi = bhi[0];
                    int32_t run_c = cnt[0];
                    for (int b = 0; b < N_BUCKETS - 1; ++b) {
                        if (b > 0) {
                            run_lo = vmin(run_lo, blo[b]);
                            run_hi = vmax(run_hi, bhi[b]);
                            run_c += cnt[b];
                        }
                        a0[b] = 2.0f * half_area(run_lo, run_hi);
                        c0[b] = run_c;
                    }
                    run_lo = blo[N_BUCKETS - 1];
                    run_hi = bhi[N_BUCKETS - 1];
                    run_c = cnt[N_BUCKETS - 1];
                    for (int b = N_BUCKETS - 2; b >= 0; --b) {
                        if (b < N_BUCKETS - 2) {
                            run_lo = vmin(run_lo, blo[b + 1]);
                            run_hi = vmax(run_hi, bhi[b + 1]);
                            run_c += cnt[b + 1];
                        }
                        a1[b] = 2.0f * half_area(run_lo, run_hi);
                        c1[b] = run_c;
                    }
                }
                const float sa_node =
                    std::max(2.0f * half_area(b_lo, b_hi), 1e-20f);
                int best = -1;
                float best_cost = INFINITY;
                for (int b = 0; b < N_BUCKETS - 1; ++b) {
                    if (c0[b] == 0 || c1[b] == 0) continue;
                    const float cost =
                        TRAVERSAL_COST +
                        INTERSECT_COST * (c0[b] * a0[b] + c1[b] * a1[b]) /
                            sa_node;
                    if (cost < best_cost) { best_cost = cost; best = b; }
                }
                if (best >= 0) {  // count > max_prims here: must split
                    int32_t* split = std::stable_partition(
                        sl, sl + count,
                        [&](int32_t p) { return bucket_of(p) <= best; });
                    mid = static_cast<int32_t>(split - sl);
                    if (mid == 0 || mid == count) {
                        make_leaf();
                        continue;
                    }
                } else {
                    make_leaf();
                    continue;
                }
            }
        }

        meta[3 * idx + 0] = 0;  // second child, patched when it's emitted
        meta[3 * idx + 1] = 0;
        meta[3 * idx + 2] = dim;
        stack.push_back({t.start + mid, t.end, idx, 1});
        stack.push_back({t.start, t.start + mid, idx, 0});
    }
    return n_nodes;
}

}  // extern "C"
