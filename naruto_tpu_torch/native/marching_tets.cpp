// The port's own copy of naruto_tpu/native/marching_tets.cpp.
//
// Isosurface extraction with truncation masking - C++ core.
//
// Role parity: the reference links NumpyMarchingCubes (neuralRGBD's C++
// marching_cubes(sdf, isolevel, truncation) extension) to turn dense SDF
// volumes into meshes while skipping untrusted cubes (SURVEY.md C13/2.8).
// This implementation extracts the isosurface by marching tetrahedra (each
// cube split into the 6 tetrahedra around the 0-7 diagonal), which is
// table-free and watertight by construction; cubes with any |value| >
// truncation are skipped, reproducing the truncation semantics.
//
// C ABI for ctypes:
//   int marching_tets(const float* sdf, int nx, int ny, int nz,
//                     float isolevel, float truncation,
//                     float** out_verts, int** out_tris,
//                     int* n_verts, int* n_tris);
//   void mt_free(void* p);
// Vertices are in voxel coordinates; the caller rescales to metric.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

// cube corner c (0..7) offset: ((c>>0)&1, (c>>1)&1, (c>>2)&1)
const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct MeshAcc {
    std::vector<float> verts;
    std::vector<int> tris;
    std::unordered_map<uint64_t, int> edge_cache;
};

inline uint64_t edge_key(uint64_t a, uint64_t b) {
    if (a > b) std::swap(a, b);
    return (a << 32) | b;
}

// interpolated vertex on the segment between global corner ids ga, gb
inline int get_vertex(MeshAcc& m, uint64_t ga, uint64_t gb,
                      const float* pa, const float* pb,
                      float va, float vb, float iso) {
    uint64_t key = edge_key(ga, gb);
    auto it = m.edge_cache.find(key);
    if (it != m.edge_cache.end()) return it->second;
    float denom = vb - va;
    float t = (std::fabs(denom) < 1e-12f) ? 0.5f : (iso - va) / denom;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    int idx = (int)(m.verts.size() / 3);
    m.verts.push_back(pa[0] + t * (pb[0] - pa[0]));
    m.verts.push_back(pa[1] + t * (pb[1] - pa[1]));
    m.verts.push_back(pa[2] + t * (pb[2] - pa[2]));
    m.edge_cache.emplace(key, idx);
    return idx;
}

inline void emit_tri(MeshAcc& m, int a, int b, int c) {
    if (a == b || b == c || a == c) return;  // degenerate
    m.tris.push_back(a);
    m.tris.push_back(b);
    m.tris.push_back(c);
}

// march one tetrahedron; corners: global ids g[], positions p[][3], values v[]
void do_tet(MeshAcc& m, const uint64_t g[4], const float p[4][3],
            const float v[4], float iso) {
    int mask = 0;
    for (int i = 0; i < 4; i++)
        if (v[i] < iso) mask |= (1 << i);
    if (mask == 0 || mask == 15) return;

    // indices of inside / outside corners
    int in[4], out[4], ni = 0, no = 0;
    for (int i = 0; i < 4; i++) {
        if (mask & (1 << i)) in[ni++] = i; else out[no++] = i;
    }
    if (ni == 1) {
        int a = in[0];
        int e0 = get_vertex(m, g[a], g[out[0]], p[a], p[out[0]], v[a], v[out[0]], iso);
        int e1 = get_vertex(m, g[a], g[out[1]], p[a], p[out[1]], v[a], v[out[1]], iso);
        int e2 = get_vertex(m, g[a], g[out[2]], p[a], p[out[2]], v[a], v[out[2]], iso);
        emit_tri(m, e0, e1, e2);
    } else if (ni == 3) {
        int a = out[0];
        int e0 = get_vertex(m, g[a], g[in[0]], p[a], p[in[0]], v[a], v[in[0]], iso);
        int e1 = get_vertex(m, g[a], g[in[1]], p[a], p[in[1]], v[a], v[in[1]], iso);
        int e2 = get_vertex(m, g[a], g[in[2]], p[a], p[in[2]], v[a], v[in[2]], iso);
        emit_tri(m, e0, e2, e1);
    } else {  // ni == 2: quad between the two inside and two outside corners
        int a = in[0], b = in[1], c = out[0], d = out[1];
        int e0 = get_vertex(m, g[a], g[c], p[a], p[c], v[a], v[c], iso);
        int e1 = get_vertex(m, g[a], g[d], p[a], p[d], v[a], v[d], iso);
        int e2 = get_vertex(m, g[b], g[d], p[b], p[d], v[b], v[d], iso);
        int e3 = get_vertex(m, g[b], g[c], p[b], p[c], v[b], v[c], iso);
        emit_tri(m, e0, e1, e2);
        emit_tri(m, e0, e2, e3);
    }
}

}  // namespace

extern "C" {

int marching_tets(const float* sdf, int nx, int ny, int nz,
                  float isolevel, float truncation,
                  float** out_verts, int** out_tris,
                  int* n_verts, int* n_tris) {
    MeshAcc m;
    const int64_t sy = nz;          // stride for y in flat [x][y][z]
    const int64_t sx = (int64_t)ny * nz;

    for (int x = 0; x + 1 < nx; x++) {
        for (int y = 0; y + 1 < ny; y++) {
            for (int z = 0; z + 1 < nz; z++) {
                float cv[8];
                uint64_t cg[8];
                float cp[8][3];
                bool skip = false;
                for (int c = 0; c < 8; c++) {
                    int cx = x + ((c >> 0) & 1);
                    int cy = y + ((c >> 1) & 1);
                    int cz = z + ((c >> 2) & 1);
                    float v = sdf[(int64_t)cx * sx + (int64_t)cy * sy + cz];
                    if (std::fabs(v) > truncation || !std::isfinite(v)) {
                        skip = true;
                        break;
                    }
                    cv[c] = v;
                    cg[c] = (uint64_t)((int64_t)cx * sx + (int64_t)cy * sy + cz);
                    cp[c][0] = (float)cx;
                    cp[c][1] = (float)cy;
                    cp[c][2] = (float)cz;
                }
                if (skip) continue;
                for (int t = 0; t < 6; t++) {
                    uint64_t g[4];
                    float p[4][3], v[4];
                    for (int k = 0; k < 4; k++) {
                        int c = TETS[t][k];
                        g[k] = cg[c];
                        v[k] = cv[c];
                        memcpy(p[k], cp[c], sizeof(float) * 3);
                    }
                    do_tet(m, g, p, v, isolevel);
                }
            }
        }
    }

    *n_verts = (int)(m.verts.size() / 3);
    *n_tris = (int)(m.tris.size() / 3);
    *out_verts = (float*)malloc(m.verts.size() * sizeof(float));
    *out_tris = (int*)malloc(m.tris.size() * sizeof(int));
    if ((m.verts.size() && !*out_verts) || (m.tris.size() && !*out_tris))
        return -1;
    memcpy(*out_verts, m.verts.data(), m.verts.size() * sizeof(float));
    memcpy(*out_tris, m.tris.data(), m.tris.size() * sizeof(int));
    return 0;
}

void mt_free(void* p) { free(p); }

}  // extern "C"
