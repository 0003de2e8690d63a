// Triangle-mesh RGB-D + equirectangular raycaster - C++ core.
//
// Role parity: habitat-sim's C++ renderer in the reference (SURVEY.md C5/2.8
// - pinhole RGB-D and ERP RGB-distance from scene meshes, agent pose as
// camera-to-world). This implementation raycasts a BVH instead of
// rasterizing with OpenGL; per-vertex colors are barycentrically
// interpolated. OpenMP parallel over pixels.
//
// Round-5 hot-path design (the host render was the wall-clock bottleneck of
// every protocol run — VERDICT r4 weak #2):
//   * binned-SAH BVH (16 bins, largest centroid axis) instead of median
//     split — fewer node/triangle visits on architectural scenes;
//   * ordered traversal: near child first, children pruned against the
//     running closest-hit t (exact: closest hit is traversal-order
//     invariant);
//   * leaves are 8-wide SoA triangle blocks (v0/e1/e2 pre-expanded) tested
//     with one vectorized Moller-Trumbore over the lanes (#pragma omp simd;
//     plain IEEE mul/add/div only, so lane arithmetic matches the scalar
//     reference bit-for-bit — RC_FORCE_SCALAR path kept for the parity
//     unit test);
//   * rc_probe_erp: distance-only ERP render for the planner's collision
//     probes (no pinhole render, no shading, no color writes — exact same
//     distances as rc_render_erp).
//
// Conventions: poses arrive as RDF (OpenCV) camera-to-world, row-major 4x4.
// Pinhole depth output is z-depth (habitat depth sensor convention); ERP
// output is radial distance with misses set to `invalid_value`
// (habitat_simulator.py:142 semantics).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline V3 vmin(V3 a, V3 b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(V3 a, V3 b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

constexpr int LANE = 8;        // SoA block width (AVX2 float lanes)
constexpr int MAX_LEAF = 8;    // one block per leaf
constexpr int SAH_BINS = 16;

// Pre-expanded Moller-Trumbore operands for up to 8 triangles. Padding
// lanes carry e1=e2=0 -> det=0 -> rejected by the |det| cutoff.
struct TriBlock {
    float v0x[LANE], v0y[LANE], v0z[LANE];
    float e1x[LANE], e1y[LANE], e1z[LANE];
    float e2x[LANE], e2y[LANE], e2z[LANE];
    int idx[LANE];             // original triangle index, -1 padding
};

// 32-byte node. right >= 0: internal (left/right are child node ids).
// right < 0: leaf; left = block id, -right = triangle count.
struct BVHNode {
    V3 bmin;
    int left;
    V3 bmax;
    int right;
};

struct Hit {
    float t = 1e30f;
    int tri = -1;
    float u = 0, v = 0;
};

struct Mesh {
    std::vector<V3> verts;
    std::vector<V3> colors;       // empty if none
    std::vector<int> tris;        // 3*n, kept for shading
    std::vector<BVHNode> nodes;
    std::vector<TriBlock> blocks;
    bool force_scalar = false;    // parity-test path (RC_FORCE_SCALAR)

    // ------------------------------------------------------------- build
    void build() {
        int n = (int)tris.size() / 3;
        std::vector<V3> cmin(n), cmax(n), cent(n);
        for (int t = 0; t < n; t++) {
            V3 a = verts[tris[3 * t]], b = verts[tris[3 * t + 1]],
               c = verts[tris[3 * t + 2]];
            cmin[t] = vmin(a, vmin(b, c));
            cmax[t] = vmax(a, vmax(b, c));
            cent[t] = (cmin[t] + cmax[t]) * 0.5f;
        }
        std::vector<int> order(n);
        for (int i = 0; i < n; i++) order[i] = i;
        nodes.reserve(n / 3 + 4);
        blocks.reserve(n / 6 + 1);
        build_node(order.data(), 0, n, cmin, cmax, cent);
    }

    void emit_leaf(int node, const int* order, int lo, int hi) {
        int count = hi - lo;
        int bid = (int)blocks.size();
        blocks.push_back({});
        TriBlock& B = blocks.back();
        for (int i = 0; i < LANE; i++) {
            if (i < count) {
                int t = order[lo + i];
                V3 a = verts[tris[3 * t]];
                V3 e1 = verts[tris[3 * t + 1]] - a;
                V3 e2 = verts[tris[3 * t + 2]] - a;
                B.v0x[i] = a.x; B.v0y[i] = a.y; B.v0z[i] = a.z;
                B.e1x[i] = e1.x; B.e1y[i] = e1.y; B.e1z[i] = e1.z;
                B.e2x[i] = e2.x; B.e2y[i] = e2.y; B.e2z[i] = e2.z;
                B.idx[i] = t;
            } else {
                B.v0x[i] = B.v0y[i] = B.v0z[i] = 0.0f;
                B.e1x[i] = B.e1y[i] = B.e1z[i] = 0.0f;
                B.e2x[i] = B.e2y[i] = B.e2z[i] = 0.0f;
                B.idx[i] = -1;
            }
        }
        nodes[node].left = bid;
        nodes[node].right = -count;
    }

    int build_node(int* order, int lo, int hi, const std::vector<V3>& cmin,
                   const std::vector<V3>& cmax,
                   const std::vector<V3>& cent) {
        int idx = (int)nodes.size();
        nodes.push_back({});
        V3 bmin = {1e30f, 1e30f, 1e30f}, bmax = {-1e30f, -1e30f, -1e30f};
        V3 gmin = bmin, gmax = bmax;  // centroid bounds
        for (int i = lo; i < hi; i++) {
            int t = order[i];
            bmin = vmin(bmin, cmin[t]);
            bmax = vmax(bmax, cmax[t]);
            gmin = vmin(gmin, cent[t]);
            gmax = vmax(gmax, cent[t]);
        }
        nodes[idx].bmin = bmin;
        nodes[idx].bmax = bmax;
        int count = hi - lo;
        if (count <= MAX_LEAF) {
            emit_leaf(idx, order, lo, hi);
            return idx;
        }

        // binned SAH on the largest centroid-extent axis
        V3 ext = gmax - gmin;
        int axis = 0;
        float emax = ext.x;
        if (ext.y > emax) { axis = 1; emax = ext.y; }
        if (ext.z > emax) { axis = 2; emax = ext.z; }
        int mid = lo + count / 2;
        bool partitioned = false;
        if (emax > 1e-12f) {
            auto caxis = [&](int t) {
                V3 c = cent[t];
                return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
            };
            float lo_c = axis == 0 ? gmin.x : (axis == 1 ? gmin.y : gmin.z);
            float inv = SAH_BINS / emax;
            int bc[SAH_BINS] = {0};
            V3 blo[SAH_BINS], bhi[SAH_BINS];
            for (int b = 0; b < SAH_BINS; b++) {
                blo[b] = {1e30f, 1e30f, 1e30f};
                bhi[b] = {-1e30f, -1e30f, -1e30f};
            }
            auto bin_of = [&](int t) {
                int b = (int)((caxis(t) - lo_c) * inv);
                return std::min(std::max(b, 0), SAH_BINS - 1);
            };
            for (int i = lo; i < hi; i++) {
                int t = order[i], b = bin_of(t);
                bc[b]++;
                blo[b] = vmin(blo[b], cmin[t]);
                bhi[b] = vmax(bhi[b], cmax[t]);
            }
            auto harea = [](V3 a, V3 b) {
                V3 d = b - a;
                if (d.x < 0) return 0.0f;
                return d.x * d.y + d.y * d.z + d.z * d.x;
            };
            // sweep: prefix/suffix areas and counts
            float rarea[SAH_BINS + 1];
            int rcount[SAH_BINS + 1];
            V3 acc_lo = {1e30f, 1e30f, 1e30f},
               acc_hi = {-1e30f, -1e30f, -1e30f};
            rarea[SAH_BINS] = 0;
            rcount[SAH_BINS] = 0;
            for (int b = SAH_BINS - 1; b >= 0; b--) {
                if (bc[b]) {
                    acc_lo = vmin(acc_lo, blo[b]);
                    acc_hi = vmax(acc_hi, bhi[b]);
                }
                rcount[b] = rcount[b + 1] + bc[b];
                rarea[b] = rcount[b] ? harea(acc_lo, acc_hi) : 0.0f;
            }
            float best = 1e30f;
            int best_split = -1;
            acc_lo = {1e30f, 1e30f, 1e30f};
            acc_hi = {-1e30f, -1e30f, -1e30f};
            int lcount = 0;
            for (int b = 0; b < SAH_BINS - 1; b++) {
                if (bc[b]) {
                    acc_lo = vmin(acc_lo, blo[b]);
                    acc_hi = vmax(acc_hi, bhi[b]);
                }
                lcount += bc[b];
                if (!lcount || lcount == count) continue;
                float cost = lcount * harea(acc_lo, acc_hi)
                             + rcount[b + 1] * rarea[b + 1];
                if (cost < best) {
                    best = cost;
                    best_split = b;
                }
            }
            if (best_split >= 0) {
                int* it = std::partition(
                    order + lo, order + hi,
                    [&](int t) { return bin_of(t) <= best_split; });
                mid = (int)(it - order);
                if (mid == lo || mid == hi) mid = lo + count / 2;
                else partitioned = true;
            }
        }
        if (!partitioned) {
            // degenerate centroids / failed split: median fallback keeps
            // the tree balanced
            std::nth_element(order + lo, order + mid, order + hi,
                             [&](int a, int b) {
                                 float va = axis == 0 ? cent[a].x
                                            : (axis == 1 ? cent[a].y
                                                         : cent[a].z);
                                 float vb = axis == 0 ? cent[b].x
                                            : (axis == 1 ? cent[b].y
                                                         : cent[b].z);
                                 return va < vb;
                             });
        }
        int l = build_node(order, lo, mid, cmin, cmax, cent);
        int r = build_node(order, mid, hi, cmin, cmax, cent);
        nodes[idx].left = l;
        nodes[idx].right = r;
        return idx;
    }

    // --------------------------------------------------------- intersect
    // slab test; on hit writes the entry distance (clamped at 0)
    static inline bool aabb_enter(const BVHNode& n, V3 o, V3 inv_d,
                                  float tmax, float& tnear) {
        float t1 = (n.bmin.x - o.x) * inv_d.x,
              t2 = (n.bmax.x - o.x) * inv_d.x;
        float tlo = std::min(t1, t2), thi = std::max(t1, t2);
        t1 = (n.bmin.y - o.y) * inv_d.y;
        t2 = (n.bmax.y - o.y) * inv_d.y;
        tlo = std::max(tlo, std::min(t1, t2));
        thi = std::min(thi, std::max(t1, t2));
        t1 = (n.bmin.z - o.z) * inv_d.z;
        t2 = (n.bmax.z - o.z) * inv_d.z;
        tlo = std::max(tlo, std::min(t1, t2));
        thi = std::min(thi, std::max(t1, t2));
        tnear = std::max(tlo, 0.0f);
        return thi >= tnear && tlo < tmax;
    }

    // scalar reference (also exercises padding-lane rejection): identical
    // arithmetic to the vectorized lane body below
    void intersect_block_scalar(const TriBlock& B, V3 o, V3 d,
                                Hit& h) const {
        const float EPS = 1e-6f;
        for (int i = 0; i < LANE; i++) {
            float px = d.y * B.e2z[i] - d.z * B.e2y[i];
            float py = d.z * B.e2x[i] - d.x * B.e2z[i];
            float pz = d.x * B.e2y[i] - d.y * B.e2x[i];
            float det = B.e1x[i] * px + B.e1y[i] * py + B.e1z[i] * pz;
            if (std::fabs(det) < 1e-12f) continue;
            float inv = 1.0f / det;
            float sx = o.x - B.v0x[i], sy = o.y - B.v0y[i],
                  sz = o.z - B.v0z[i];
            float u = (sx * px + sy * py + sz * pz) * inv;
            if (u < -EPS || u > 1.0f + EPS) continue;
            float qx = sy * B.e1z[i] - sz * B.e1y[i];
            float qy = sz * B.e1x[i] - sx * B.e1z[i];
            float qz = sx * B.e1y[i] - sy * B.e1x[i];
            float v = (d.x * qx + d.y * qy + d.z * qz) * inv;
            if (v < -EPS || u + v > 1.0f + EPS) continue;
            float t = (B.e2x[i] * qx + B.e2y[i] * qy + B.e2z[i] * qz) * inv;
            if (t > 1e-5f && t < h.t) {
                h.t = t;
                h.tri = B.idx[i];
                h.u = u;
                h.v = v;
            }
        }
    }

    void intersect_block(const TriBlock& B, V3 o, V3 d, Hit& h) const {
        // small barycentric tolerance: rays crossing exactly on a shared
        // edge/diagonal must not fall through the crack between the two
        // adjacent triangles (watertightness)
        const float EPS = 1e-6f;
        float tv[LANE], uv[LANE], vv[LANE];
        int ok[LANE];
#pragma omp simd
        for (int i = 0; i < LANE; i++) {
            float px = d.y * B.e2z[i] - d.z * B.e2y[i];
            float py = d.z * B.e2x[i] - d.x * B.e2z[i];
            float pz = d.x * B.e2y[i] - d.y * B.e2x[i];
            float det = B.e1x[i] * px + B.e1y[i] * py + B.e1z[i] * pz;
            float inv = 1.0f / det;  // det=0 -> inf/NaN, rejected below
            float sx = o.x - B.v0x[i], sy = o.y - B.v0y[i],
                  sz = o.z - B.v0z[i];
            float u = (sx * px + sy * py + sz * pz) * inv;
            float qx = sy * B.e1z[i] - sz * B.e1y[i];
            float qy = sz * B.e1x[i] - sx * B.e1z[i];
            float qz = sx * B.e1y[i] - sy * B.e1x[i];
            float v = (d.x * qx + d.y * qy + d.z * qz) * inv;
            float t = (B.e2x[i] * qx + B.e2y[i] * qy + B.e2z[i] * qz) * inv;
            ok[i] = (std::fabs(det) >= 1e-12f) & (u >= -EPS)
                    & (u <= 1.0f + EPS) & (v >= -EPS)
                    & (u + v <= 1.0f + EPS) & (t > 1e-5f);
            tv[i] = t;
            uv[i] = u;
            vv[i] = v;
        }
        for (int i = 0; i < LANE; i++) {
            if (ok[i] && tv[i] < h.t) {
                h.t = tv[i];
                h.tri = B.idx[i];
                h.u = uv[i];
                h.v = vv[i];
            }
        }
    }

    Hit trace(V3 o, V3 d) const {
        Hit h;
        if (nodes.empty()) return h;
        V3 inv_d = {1.0f / (std::fabs(d.x) > 1e-12f ? d.x : 1e-12f),
                    1.0f / (std::fabs(d.y) > 1e-12f ? d.y : 1e-12f),
                    1.0f / (std::fabs(d.z) > 1e-12f ? d.z : 1e-12f)};
        struct SE {
            int node;
            float tnear;
        };
        SE stack[128];
        int sp = 0;
        float tn;
        if (!aabb_enter(nodes[0], o, inv_d, h.t, tn)) return h;
        stack[sp++] = {0, tn};
        while (sp) {
            SE e = stack[--sp];
            if (e.tnear >= h.t) continue;   // closest hit already nearer
            const BVHNode& n = nodes[e.node];
            if (n.right < 0) {
                if (force_scalar)
                    intersect_block_scalar(blocks[n.left], o, d, h);
                else
                    intersect_block(blocks[n.left], o, d, h);
                continue;
            }
            float tl, tr;
            bool hl = aabb_enter(nodes[n.left], o, inv_d, h.t, tl);
            bool hr = aabb_enter(nodes[n.right], o, inv_d, h.t, tr);
            if (hl && hr && sp < 126) {
                // near child on top of the stack
                if (tl <= tr) {
                    stack[sp++] = {n.right, tr};
                    stack[sp++] = {n.left, tl};
                } else {
                    stack[sp++] = {n.left, tl};
                    stack[sp++] = {n.right, tr};
                }
            } else if (hl && sp < 127) {
                stack[sp++] = {n.left, tl};
            } else if (hr && sp < 127) {
                stack[sp++] = {n.right, tr};
            }
        }
        return h;
    }

    // ------------------------------------------------- packet traversal
    // 8 rays share one BVH walk (coherent primary rays: pinhole rows, ERP
    // rows). Node visitation is the union of the lanes' single-ray
    // traversals (slab test per lane, descend if ANY lane passes), and the
    // leaf Moller-Trumbore runs the SAME expression sequence per lane as
    // the scalar reference — per-lane results are bit-identical to
    // single-ray tracing; only the visit ORDER differs, which closest-hit
    // selection is invariant to.
    void trace_packet(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      float* ht, int* htri, float* hu, float* hv) const {
        if (nodes.empty()) return;
        const float EPS = 1e-6f;
        float ix[LANE], iy[LANE], iz[LANE];
        for (int i = 0; i < LANE; i++) {
            ix[i] = 1.0f / (std::fabs(dx[i]) > 1e-12f ? dx[i] : 1e-12f);
            iy[i] = 1.0f / (std::fabs(dy[i]) > 1e-12f ? dy[i] : 1e-12f);
            iz[i] = 1.0f / (std::fabs(dz[i]) > 1e-12f ? dz[i] : 1e-12f);
        }
        // per-lane slab test of one node against the packet: any-lane pass
        // + min entry distance over passing lanes (for near-first ordering
        // and conservative pruning)
        auto slab8 = [&](const BVHNode& n, float& tn_min) -> int {
            int any = 0;
            float tmin = 1e30f;
#pragma omp simd reduction(|: any) reduction(min: tmin)
            for (int i = 0; i < LANE; i++) {
                float t1 = (n.bmin.x - ox[i]) * ix[i],
                      t2 = (n.bmax.x - ox[i]) * ix[i];
                float tlo = std::min(t1, t2), thi = std::max(t1, t2);
                t1 = (n.bmin.y - oy[i]) * iy[i];
                t2 = (n.bmax.y - oy[i]) * iy[i];
                tlo = std::max(tlo, std::min(t1, t2));
                thi = std::min(thi, std::max(t1, t2));
                t1 = (n.bmin.z - oz[i]) * iz[i];
                t2 = (n.bmax.z - oz[i]) * iz[i];
                tlo = std::max(tlo, std::min(t1, t2));
                thi = std::min(thi, std::max(t1, t2));
                float tn = std::max(tlo, 0.0f);
                int pass = (thi >= tn) & (tlo < ht[i]);
                any |= pass;
                tmin = pass ? std::min(tmin, tn) : tmin;
            }
            tn_min = tmin;
            return any;
        };
        struct SE {
            int node;
            float tnear;   // min over passing lanes (conservative prune)
        };
        SE stack[128];
        int sp = 0;
        float tn_root;
        if (!slab8(nodes[0], tn_root)) return;
        stack[sp++] = {0, tn_root};
        while (sp) {
            SE e = stack[--sp];
            // conservative packet prune: skip only if every lane's current
            // closest hit is nearer than the node's best entry distance
            float tmax = ht[0];
            for (int i = 1; i < LANE; i++) tmax = std::max(tmax, ht[i]);
            if (e.tnear >= tmax) continue;
            const BVHNode& n = nodes[e.node];
            if (n.right < 0) {
                const TriBlock& B = blocks[n.left];
                int count = -n.right;
                for (int j = 0; j < count; j++) {
                    // broadcast triangle j, SIMD over the 8 rays; identical
                    // per-lane arithmetic to intersect_block_scalar
                    float e2x = B.e2x[j], e2y = B.e2y[j], e2z = B.e2z[j];
                    float e1x = B.e1x[j], e1y = B.e1y[j], e1z = B.e1z[j];
                    float v0x = B.v0x[j], v0y = B.v0y[j], v0z = B.v0z[j];
                    float tv[LANE], uv[LANE], vv[LANE];
                    int ok[LANE];
#pragma omp simd
                    for (int i = 0; i < LANE; i++) {
                        float px = dy[i] * e2z - dz[i] * e2y;
                        float py = dz[i] * e2x - dx[i] * e2z;
                        float pz = dx[i] * e2y - dy[i] * e2x;
                        float det = e1x * px + e1y * py + e1z * pz;
                        float inv = 1.0f / det;
                        float sx = ox[i] - v0x, sy = oy[i] - v0y,
                              sz = oz[i] - v0z;
                        float u = (sx * px + sy * py + sz * pz) * inv;
                        float qx = sy * e1z - sz * e1y;
                        float qy = sz * e1x - sx * e1z;
                        float qz = sx * e1y - sy * e1x;
                        float v = (dx[i] * qx + dy[i] * qy + dz[i] * qz)
                                  * inv;
                        float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
                        ok[i] = (std::fabs(det) >= 1e-12f) & (u >= -EPS)
                                & (u <= 1.0f + EPS) & (v >= -EPS)
                                & (u + v <= 1.0f + EPS) & (t > 1e-5f)
                                & (t < ht[i]);
                        tv[i] = t;
                        uv[i] = u;
                        vv[i] = v;
                    }
                    int tj = B.idx[j];
                    for (int i = 0; i < LANE; i++) {
                        if (ok[i]) {
                            ht[i] = tv[i];
                            htri[i] = tj;
                            hu[i] = uv[i];
                            hv[i] = vv[i];
                        }
                    }
                }
                continue;
            }
            float tl, tr;
            int hl = slab8(nodes[n.left], tl);
            int hr = slab8(nodes[n.right], tr);
            if (hl && hr && sp < 126) {
                // near child on top of the stack
                if (tl <= tr) {
                    stack[sp++] = {n.right, tr};
                    stack[sp++] = {n.left, tl};
                } else {
                    stack[sp++] = {n.left, tl};
                    stack[sp++] = {n.right, tr};
                }
            } else if (hl && sp < 127) {
                stack[sp++] = {n.left, tl};
            } else if (hr && sp < 127) {
                stack[sp++] = {n.right, tr};
            }
        }
    }

    V3 shade(const Hit& h) const {
        if (h.tri < 0) return {0, 0, 0};
        int i0 = tris[3 * h.tri], i1 = tris[3 * h.tri + 1],
            i2 = tris[3 * h.tri + 2];
        if (!colors.empty()) {
            V3 c = colors[i0] * (1 - h.u - h.v) + colors[i1] * h.u
                   + colors[i2] * h.v;
            return c;
        }
        // no vertex colors: shade by |normal| as a stable gray-ish albedo
        V3 n = cross(verts[i1] - verts[i0], verts[i2] - verts[i0]);
        float len = std::sqrt(dot(n, n));
        if (len > 0) n = n * (1.0f / len);
        return {0.5f + 0.5f * std::fabs(n.x), 0.5f + 0.5f * std::fabs(n.y),
                0.5f + 0.5f * std::fabs(n.z)};
    }
};

// Dynamic rigid object: mesh in object-local coordinates + a rigid world
// pose. Rays are transformed into object space (two-level BVH without
// refitting) - parity with the reference's habitat rigid-object manager
// (habitat_utils.py:342-426; poses advanced host-side by the Python layer's
// step_physics, matching habitat's step_physics call sites).
struct Object {
    Mesh mesh;
    // world->object rigid transform, row-major 3x4
    float w2o[12] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0};

    V3 to_obj_point(V3 p) const {
        return {w2o[0] * p.x + w2o[1] * p.y + w2o[2] * p.z + w2o[3],
                w2o[4] * p.x + w2o[5] * p.y + w2o[6] * p.z + w2o[7],
                w2o[8] * p.x + w2o[9] * p.y + w2o[10] * p.z + w2o[11]};
    }
    V3 to_obj_dir(V3 d) const {
        return {w2o[0] * d.x + w2o[1] * d.y + w2o[2] * d.z,
                w2o[4] * d.x + w2o[5] * d.y + w2o[6] * d.z,
                w2o[8] * d.x + w2o[9] * d.y + w2o[10] * d.z};
    }
};

struct Scene {
    Mesh base;
    std::vector<Object*> objs;
    ~Scene() {
        for (Object* o : objs) delete o;
    }

    void set_force_scalar(bool v) {
        base.force_scalar = v;
        for (Object* o : objs) o->mesh.force_scalar = v;
    }

    // trace static mesh + all objects; returns the winning mesh for shading
    const Mesh* trace_all(V3 o, V3 d, Hit& best) const {
        best = base.trace(o, d);
        const Mesh* mesh = &base;
        for (const Object* obj : objs) {
            Hit h = obj->mesh.trace(obj->to_obj_point(o), obj->to_obj_dir(d));
            if (h.tri >= 0 && h.t < best.t) {
                best = h;
                mesh = &obj->mesh;
            }
        }
        if (best.tri < 0) mesh = nullptr;
        return mesh;
    }

    const Mesh* mesh_by_id(int id) const {
        return id < 0 ? nullptr : (id == 0 ? &base : &objs[id - 1]->mesh);
    }

    // packet trace over scene + objects; hmesh[i]: -1 miss, 0 base,
    // 1+k object k (rigid object transforms preserve ray-parameter t, so
    // per-lane closest-hit comparison across spaces is exact)
    void trace_all_packet(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          float* ht, int* htri, float* hu, float* hv,
                          int* hmesh) const {
        base.trace_packet(ox, oy, oz, dx, dy, dz, ht, htri, hu, hv);
        for (int i = 0; i < LANE; i++) hmesh[i] = htri[i] >= 0 ? 0 : -1;
        float tox[LANE], toy[LANE], toz[LANE];
        float tdx[LANE], tdy[LANE], tdz[LANE];
        float prev_t[LANE];
        for (size_t k = 0; k < objs.size(); k++) {
            const Object* obj = objs[k];
            for (int i = 0; i < LANE; i++) {
                V3 to = obj->to_obj_point({ox[i], oy[i], oz[i]});
                V3 td = obj->to_obj_dir({dx[i], dy[i], dz[i]});
                tox[i] = to.x; toy[i] = to.y; toz[i] = to.z;
                tdx[i] = td.x; tdy[i] = td.y; tdz[i] = td.z;
                prev_t[i] = ht[i];
            }
            obj->mesh.trace_packet(tox, toy, toz, tdx, tdy, tdz,
                                   ht, htri, hu, hv);
            for (int i = 0; i < LANE; i++)
                if (ht[i] < prev_t[i]) hmesh[i] = (int)k + 1;
        }
    }
};

}  // namespace

extern "C" {

void* rc_create(const float* verts, int n_verts, const float* colors,
                const int* tris, int n_tris) {
    Scene* s = new Scene();
    Mesh* m = &s->base;
    m->verts.resize(n_verts);
    memcpy(m->verts.data(), verts, sizeof(float) * 3 * n_verts);
    if (colors) {
        m->colors.resize(n_verts);
        memcpy(m->colors.data(), colors, sizeof(float) * 3 * n_verts);
    }
    m->tris.assign(tris, tris + 3 * n_tris);
    m->build();
    if (getenv("RC_FORCE_SCALAR")) s->set_force_scalar(true);
    return s;
}

void rc_destroy(void* h) { delete (Scene*)h; }

// parity-test hook: 1 = scalar reference leaf intersection, 0 = SIMD
void rc_set_force_scalar(void* h, int flag) {
    ((Scene*)h)->set_force_scalar(flag != 0);
}

// add a rigid object (object-local vertices); returns its id
int rc_add_object(void* h, const float* verts, int n_verts,
                  const float* colors, const int* tris, int n_tris) {
    Scene* s = (Scene*)h;
    Object* obj = new Object();
    obj->mesh.verts.resize(n_verts);
    memcpy(obj->mesh.verts.data(), verts, sizeof(float) * 3 * n_verts);
    if (colors) {
        obj->mesh.colors.resize(n_verts);
        memcpy(obj->mesh.colors.data(), colors, sizeof(float) * 3 * n_verts);
    }
    obj->mesh.tris.assign(tris, tris + 3 * n_tris);
    obj->mesh.build();
    obj->mesh.force_scalar = s->base.force_scalar;
    s->objs.push_back(obj);
    return (int)s->objs.size() - 1;
}

// set an object's rigid object->world pose (row-major 4x4); the inverse is
// stored for ray transformation
void rc_set_object_pose(void* h, int obj_id, const float* o2w) {
    Scene* s = (Scene*)h;
    if (obj_id < 0 || obj_id >= (int)s->objs.size()) return;
    Object* obj = s->objs[obj_id];
    // inverse of rigid [R|t]: [R^T | -R^T t]
    float r[9] = {o2w[0], o2w[1], o2w[2], o2w[4], o2w[5],
                  o2w[6], o2w[8], o2w[9], o2w[10]};
    float t[3] = {o2w[3], o2w[7], o2w[11]};
    // R^T rows
    obj->w2o[0] = r[0];
    obj->w2o[1] = r[3];
    obj->w2o[2] = r[6];
    obj->w2o[4] = r[1];
    obj->w2o[5] = r[4];
    obj->w2o[6] = r[7];
    obj->w2o[8] = r[2];
    obj->w2o[9] = r[5];
    obj->w2o[10] = r[8];
    obj->w2o[3] = -(obj->w2o[0] * t[0] + obj->w2o[1] * t[1]
                    + obj->w2o[2] * t[2]);
    obj->w2o[7] = -(obj->w2o[4] * t[0] + obj->w2o[5] * t[1]
                    + obj->w2o[6] * t[2]);
    obj->w2o[11] = -(obj->w2o[8] * t[0] + obj->w2o[9] * t[1]
                     + obj->w2o[10] * t[2]);
}

// c2w: row-major 4x4, RDF camera-to-world
void rc_render_pinhole(void* h, const float* c2w, int H, int W, float fx,
                       float fy, float cx, float cy, float* out_color,
                       float* out_depth) {
    const Scene* m = (const Scene*)h;
    V3 o = {c2w[3], c2w[7], c2w[11]};
    V3 r0 = {c2w[0], c2w[4], c2w[8]};
    V3 r1 = {c2w[1], c2w[5], c2w[9]};
    V3 r2 = {c2w[2], c2w[6], c2w[10]};
    if (m->base.force_scalar) {
        // scalar reference path (parity tests): one ray at a time
#pragma omp parallel for schedule(dynamic, 8)
        for (int v = 0; v < H; v++) {
            for (int u = 0; u < W; u++) {
                float dx = (u - cx) / fx, dy = (v - cy) / fy;
                V3 d_cam = {dx, dy, 1.0f};
                float nrm = std::sqrt(dot(d_cam, d_cam));
                V3 d = r0 * (dx / nrm) + r1 * (dy / nrm)
                       + r2 * (1.0f / nrm);
                Hit hit;
                const Mesh* hm = m->trace_all(o, d, hit);
                int idx = v * W + u;
                if (hm) {
                    V3 c = hm->shade(hit);
                    out_color[3 * idx] = c.x;
                    out_color[3 * idx + 1] = c.y;
                    out_color[3 * idx + 2] = c.z;
                    out_depth[idx] = hit.t / nrm;  // radial -> z-depth
                } else {
                    out_color[3 * idx] = out_color[3 * idx + 1] =
                        out_color[3 * idx + 2] = 0.0f;
                    out_depth[idx] = 0.0f;
                }
            }
        }
        return;
    }
#pragma omp parallel for schedule(dynamic, 4)
    for (int v = 0; v < H; v++) {
        float ox[LANE], oy[LANE], oz[LANE];
        float dxs[LANE], dys[LANE], dzs[LANE], nrms[LANE];
        float ht[LANE], hu[LANE], hv[LANE];
        int htri[LANE], hmesh[LANE];
        for (int i = 0; i < LANE; i++) {
            ox[i] = o.x;
            oy[i] = o.y;
            oz[i] = o.z;
        }
        for (int u0 = 0; u0 < W; u0 += LANE) {
            int nl = std::min(LANE, W - u0);
            for (int i = 0; i < LANE; i++) {
                int u = u0 + std::min(i, nl - 1);  // tail lanes duplicate
                float dx = (u - cx) / fx, dy = (v - cy) / fy;
                V3 d_cam = {dx, dy, 1.0f};
                float nrm = std::sqrt(dot(d_cam, d_cam));
                V3 d = r0 * (dx / nrm) + r1 * (dy / nrm)
                       + r2 * (1.0f / nrm);
                dxs[i] = d.x;
                dys[i] = d.y;
                dzs[i] = d.z;
                nrms[i] = nrm;
                ht[i] = 1e30f;
                htri[i] = -1;
                hu[i] = hv[i] = 0.0f;
            }
            m->trace_all_packet(ox, oy, oz, dxs, dys, dzs, ht, htri, hu, hv,
                                hmesh);
            for (int i = 0; i < nl; i++) {
                int idx = v * W + u0 + i;
                const Mesh* hm = m->mesh_by_id(hmesh[i]);
                if (hm) {
                    Hit hit = {ht[i], htri[i], hu[i], hv[i]};
                    V3 c = hm->shade(hit);
                    out_color[3 * idx] = c.x;
                    out_color[3 * idx + 1] = c.y;
                    out_color[3 * idx + 2] = c.z;
                    out_depth[idx] = ht[i] / nrms[i];  // radial -> z-depth
                } else {
                    out_color[3 * idx] = out_color[3 * idx + 1] =
                        out_color[3 * idx + 2] = 0.0f;
                    out_depth[idx] = 0.0f;
                }
            }
        }
    }
}

// Shared ERP tracing core: packet path unless the scene is in scalar
// parity mode. out_color may be null (distance-only probes).
static void erp_render_impl(const Scene* m, const float* c2w, int H, int W,
                            float invalid_value, float* out_color,
                            float* out_dist) {
    V3 o = {c2w[3], c2w[7], c2w[11]};
    V3 r0 = {c2w[0], c2w[4], c2w[8]};
    V3 r1 = {c2w[1], c2w[5], c2w[9]};
    V3 r2 = {c2w[2], c2w[6], c2w[10]};
    const float PI = 3.14159265358979f;
    if (m->base.force_scalar) {
#pragma omp parallel for schedule(dynamic, 4)
        for (int v = 0; v < H; v++) {
            float theta = PI * (0.5f - (v + 0.5f) / H);
            float ct = std::cos(theta), st = std::sin(theta);
            for (int u = 0; u < W; u++) {
                float phi = 2 * PI * ((u + 0.5f) / W - 0.5f);
                // RDF: x right, y down, z forward
                V3 d_cam = {ct * std::sin(phi), -st, ct * std::cos(phi)};
                V3 d = r0 * d_cam.x + r1 * d_cam.y + r2 * d_cam.z;
                Hit hit;
                const Mesh* hm = m->trace_all(o, d, hit);
                int idx = v * W + u;
                if (hm) {
                    if (out_color) {
                        V3 c = hm->shade(hit);
                        out_color[3 * idx] = c.x;
                        out_color[3 * idx + 1] = c.y;
                        out_color[3 * idx + 2] = c.z;
                    }
                    out_dist[idx] = hit.t;
                } else {
                    if (out_color)
                        out_color[3 * idx] = out_color[3 * idx + 1] =
                            out_color[3 * idx + 2] = 0.0f;
                    out_dist[idx] = invalid_value;
                }
            }
        }
        return;
    }
#pragma omp parallel for schedule(dynamic, 2)
    for (int v = 0; v < H; v++) {
        float theta = PI * (0.5f - (v + 0.5f) / H);
        float ct = std::cos(theta), st = std::sin(theta);
        float ox[LANE], oy[LANE], oz[LANE];
        float dxs[LANE], dys[LANE], dzs[LANE];
        float ht[LANE], hu[LANE], hv[LANE];
        int htri[LANE], hmesh[LANE];
        for (int i = 0; i < LANE; i++) {
            ox[i] = o.x;
            oy[i] = o.y;
            oz[i] = o.z;
        }
        for (int u0 = 0; u0 < W; u0 += LANE) {
            int nl = std::min(LANE, W - u0);
            for (int i = 0; i < LANE; i++) {
                int u = u0 + std::min(i, nl - 1);  // tail lanes duplicate
                float phi = 2 * PI * ((u + 0.5f) / W - 0.5f);
                V3 d_cam = {ct * std::sin(phi), -st, ct * std::cos(phi)};
                V3 d = r0 * d_cam.x + r1 * d_cam.y + r2 * d_cam.z;
                dxs[i] = d.x;
                dys[i] = d.y;
                dzs[i] = d.z;
                ht[i] = 1e30f;
                htri[i] = -1;
                hu[i] = hv[i] = 0.0f;
            }
            m->trace_all_packet(ox, oy, oz, dxs, dys, dzs, ht, htri, hu, hv,
                                hmesh);
            for (int i = 0; i < nl; i++) {
                int idx = v * W + u0 + i;
                const Mesh* hm = m->mesh_by_id(hmesh[i]);
                if (hm) {
                    if (out_color) {
                        Hit hit = {ht[i], htri[i], hu[i], hv[i]};
                        V3 c = hm->shade(hit);
                        out_color[3 * idx] = c.x;
                        out_color[3 * idx + 1] = c.y;
                        out_color[3 * idx + 2] = c.z;
                    }
                    out_dist[idx] = ht[i];
                } else {
                    if (out_color)
                        out_color[3 * idx] = out_color[3 * idx + 1] =
                            out_color[3 * idx + 2] = 0.0f;
                    out_dist[idx] = invalid_value;
                }
            }
        }
    }
}

void rc_render_erp(void* h, const float* c2w, int H, int W,
                   float invalid_value, float* out_color, float* out_dist) {
    erp_render_impl((const Scene*)h, c2w, H, W, invalid_value, out_color,
                    out_dist);
}

// Distance-only ERP render for collision probes: exactly rc_render_erp's
// distances with no shading and no color writes. The planner only consumes
// erp_dist.min() and the invalid ratio (naruto_planner.detect_collision,
// ref detect_collision_v2 naruto_planner.py:512-594), so probes skip the
// pinhole render + shading entirely.
void rc_probe_erp(void* h, const float* c2w, int H, int W,
                  float invalid_value, float* out_dist) {
    erp_render_impl((const Scene*)h, c2w, H, W, invalid_value, nullptr,
                    out_dist);
}

}  // extern "C"
