// Host-side scene ingestion of heatray_tpu_torch: Morton order of triangle
// centroids, area-weighted vertex normals, the OBJ tokenizer with fan
// triangulation, and the binned-SAH BVH builder whose flattened skip-pointer
// tree every traversal kernel of csrc/ walks.
//
// The port's own copy of the JAX package's native/heatray_native.cpp, with
// the same plain C interface and the same outputs bit for bit: the same
// split choices, preorder, skip pointers and leaf slots.  It runs on the
// host, never on the card.  ops/cuda_build.py builds it with g++ at first use
// (`build_host("native")`), with -ffp-contract=off: a fused multiply-add in
// the normals' cross products or the SAH costs would round otherwise than
// the numpy twins (scene/geometry.py, ops/bvh.py) and, on a near tie, pick
// another split.
// native.py binds it with ctypes.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Morton ordering of triangle centroids (30-bit, 10 per axis).
// positions: (V, 3) f32; indices: (T, 3) i32; out_order: (T,) i64.
// ---------------------------------------------------------------------------
static inline uint64_t spread10(uint64_t x) {
    x = (x | (x << 16)) & 0x030000FFULL;
    x = (x | (x << 8)) & 0x0300F00FULL;
    x = (x | (x << 4)) & 0x030C30C3ULL;
    x = (x | (x << 2)) & 0x09249249ULL;
    return x;
}

void morton_order(const float* positions, int64_t num_vertices,
                  const int32_t* indices, int64_t num_triangles,
                  int64_t* out_order) {
    (void)num_vertices;
    std::vector<float> cx(num_triangles), cy(num_triangles), cz(num_triangles);
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t t = 0; t < num_triangles; ++t) {
        float c[3] = {0.f, 0.f, 0.f};
        for (int k = 0; k < 3; ++k) {
            const float* v = positions + 3 * (int64_t)indices[3 * t + k];
            c[0] += v[0]; c[1] += v[1]; c[2] += v[2];
        }
        cx[t] = c[0] / 3.f; cy[t] = c[1] / 3.f; cz[t] = c[2] / 3.f;
        lo[0] = std::min(lo[0], cx[t]); hi[0] = std::max(hi[0], cx[t]);
        lo[1] = std::min(lo[1], cy[t]); hi[1] = std::max(hi[1], cy[t]);
        lo[2] = std::min(lo[2], cz[t]); hi[2] = std::max(hi[2], cz[t]);
    }
    float ext[3];
    for (int a = 0; a < 3; ++a) ext[a] = std::max(hi[a] - lo[a], 1e-12f);
    std::vector<uint64_t> code(num_triangles);
    for (int64_t t = 0; t < num_triangles; ++t) {
        auto q = [&](float c, int a) -> uint64_t {
            float f = (c - lo[a]) / ext[a] * 1023.0f;
            f = std::min(std::max(f, 0.0f), 1023.0f);
            return (uint64_t)f;
        };
        code[t] = (spread10(q(cx[t], 0)) << 2) | (spread10(q(cy[t], 1)) << 1) |
                  spread10(q(cz[t], 2));
    }
    std::iota(out_order, out_order + num_triangles, (int64_t)0);
    std::stable_sort(out_order, out_order + num_triangles,
                     [&](int64_t a, int64_t b) { return code[a] < code[b]; });
}

// ---------------------------------------------------------------------------
// Area-weighted smooth vertex normals.
// positions: (V, 3) f32; indices: (T, 3) i32; out_normals: (V, 3) f32.
// ---------------------------------------------------------------------------
void vertex_normals(const float* positions, int64_t num_vertices,
                    const int32_t* indices, int64_t num_triangles,
                    float* out_normals) {
    std::memset(out_normals, 0, sizeof(float) * 3 * num_vertices);
    for (int64_t t = 0; t < num_triangles; ++t) {
        const int32_t i0 = indices[3 * t], i1 = indices[3 * t + 1],
                      i2 = indices[3 * t + 2];
        const float* a = positions + 3 * (int64_t)i0;
        const float* b = positions + 3 * (int64_t)i1;
        const float* c = positions + 3 * (int64_t)i2;
        float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
        float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
        float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                      e1[2] * e2[0] - e1[0] * e2[2],
                      e1[0] * e2[1] - e1[1] * e2[0]};
        for (int32_t idx : {i0, i1, i2}) {
            out_normals[3 * (int64_t)idx + 0] += n[0];
            out_normals[3 * (int64_t)idx + 1] += n[1];
            out_normals[3 * (int64_t)idx + 2] += n[2];
        }
    }
    for (int64_t v = 0; v < num_vertices; ++v) {
        float* n = out_normals + 3 * v;
        float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        float inv = len > 1e-20f ? 1.0f / len : 0.0f;
        n[0] *= inv; n[1] *= inv; n[2] *= inv;
    }
}

// ---------------------------------------------------------------------------
// OBJ parsing: tokenizes v/vt/vn/f lines, fan-triangulates polygons, and
// resolves per-corner v/vt/vn index triplets into flat corner streams
// (the same dereference AssimpMeshProvider performs).  Two-phase API:
//   obj_parse() -> handle with counts; obj_read() copies out; obj_free().
// ---------------------------------------------------------------------------
struct ObjData {
    std::vector<float> v, vt, vn;     // raw streams (3/2/3 per entry)
    std::vector<int32_t> fv, ft, fn;  // per corner (3 per triangle); -1 = none
};

static const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

void* obj_parse(const char* text, int64_t length, int64_t* out_counts) {
    ObjData* d = new ObjData();
    const char* p = text;
    const char* end = text + length;
    std::vector<int32_t> face_v, face_t, face_n;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q + 1 < line_end && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            char* r = nullptr;
            double a = strtod(q + 1, &r), b = strtod(r, &r), c = strtod(r, &r);
            d->v.push_back((float)a); d->v.push_back((float)b); d->v.push_back((float)c);
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't') {
            char* r = nullptr;
            double a = strtod(q + 2, &r), b = strtod(r, &r);
            d->vt.push_back((float)a); d->vt.push_back((float)b);
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n') {
            char* r = nullptr;
            double a = strtod(q + 2, &r), b = strtod(r, &r), c = strtod(r, &r);
            d->vn.push_back((float)a); d->vn.push_back((float)b); d->vn.push_back((float)c);
        } else if (q < line_end && q[0] == 'f' &&
                   (q + 1 == line_end || q[1] == ' ' || q[1] == '\t')) {
            face_v.clear(); face_t.clear(); face_n.clear();
            const char* r = q + 1;
            int64_t nv = (int64_t)d->v.size() / 3;
            int64_t nt = (int64_t)d->vt.size() / 2;
            int64_t nn = (int64_t)d->vn.size() / 3;
            while (r < line_end) {
                r = skip_ws(r, line_end);
                if (r >= line_end) break;
                char* s = nullptr;
                long vi = strtol(r, &s, 10);
                if (s == r) break;
                long ti = 0, ni = 0; bool has_t = false, has_n = false;
                if (s < line_end && *s == '/') {
                    ++s;
                    if (s < line_end && *s != '/') { ti = strtol(s, &s, 10); has_t = true; }
                    if (s < line_end && *s == '/') { ++s; ni = strtol(s, &s, 10); has_n = true; }
                }
                auto fix = [](long i, int64_t n) -> int32_t {
                    if (i > 0) return (int32_t)(i - 1);
                    if (i < 0) return (int32_t)(n + i);
                    return -1;
                };
                face_v.push_back(fix(vi, nv));
                face_t.push_back(has_t ? fix(ti, nt) : -1);
                face_n.push_back(has_n ? fix(ni, nn) : -1);
                r = s;
            }
            for (size_t k = 2; k < face_v.size(); ++k) {  // fan triangulation
                int idxs[3] = {0, (int)k - 1, (int)k};
                for (int j : idxs) {
                    d->fv.push_back(face_v[(size_t)j]);
                    d->ft.push_back(face_t[(size_t)j]);
                    d->fn.push_back(face_n[(size_t)j]);
                }
            }
        }
        p = line_end + 1;
    }
    out_counts[0] = (int64_t)d->v.size() / 3;
    out_counts[1] = (int64_t)d->vt.size() / 2;
    out_counts[2] = (int64_t)d->vn.size() / 3;
    out_counts[3] = (int64_t)d->fv.size() / 3;  // triangles
    return d;
}

void obj_read(void* handle, float* v, float* vt, float* vn,
              int32_t* fv, int32_t* ft, int32_t* fn) {
    ObjData* d = (ObjData*)handle;
    std::memcpy(v, d->v.data(), d->v.size() * sizeof(float));
    std::memcpy(vt, d->vt.data(), d->vt.size() * sizeof(float));
    std::memcpy(vn, d->vn.data(), d->vn.size() * sizeof(float));
    std::memcpy(fv, d->fv.data(), d->fv.size() * sizeof(int32_t));
    std::memcpy(ft, d->ft.data(), d->ft.size() * sizeof(int32_t));
    std::memcpy(fn, d->fn.data(), d->fn.size() * sizeof(int32_t));
}

void obj_free(void* handle) { delete (ObjData*)handle; }

// ---------------------------------------------------------------------------
// Binned-SAH BVH builder (ops/bvh.py: build_topology; the numpy twin is
// build_topology_plain).  Widest centroid axis, n_bins bins, near-side-first
// preorder emission, a median split where no bin split separates the
// centroids or past depth 48, fixed-size leaf chunks padded with -1.
// ---------------------------------------------------------------------------

namespace {

struct BvhData {
    std::vector<float> nbox;        // (N, 6)
    std::vector<int32_t> leaf_chunk;  // (N,)
    std::vector<int32_t> skip;      // (N,)
    std::vector<int32_t> slot_tri;  // (C * leaf_size,)
    int64_t leaf_size = 0;
};

struct BvhBuilder {
    const float* bmin;  // (T', 3) gathered
    const float* bmax;
    const float* cent;
    const int32_t* ids;  // original triangle ids
    int32_t* order;
    int32_t* scratch;
    int64_t leaf_size;
    int n_bins;
    BvhData* out;

    void emit(int64_t lo, int64_t hi, int depth = 0) {
        size_t my = out->leaf_chunk.size();
        float node_min[3] = {3e38f, 3e38f, 3e38f};
        float node_max[3] = {-3e38f, -3e38f, -3e38f};
        for (int64_t t = lo; t < hi; ++t) {
            const float* mn = bmin + 3 * (int64_t)order[t];
            const float* mx = bmax + 3 * (int64_t)order[t];
            for (int k = 0; k < 3; ++k) {
                node_min[k] = std::min(node_min[k], mn[k]);
                node_max[k] = std::max(node_max[k], mx[k]);
            }
        }
        for (int k = 0; k < 3; ++k) out->nbox.push_back(node_min[k]);
        for (int k = 0; k < 3; ++k) out->nbox.push_back(node_max[k]);
        out->leaf_chunk.push_back(-1);
        out->skip.push_back(-1);

        if (hi - lo <= leaf_size) {
            int32_t chunk =
                (int32_t)(out->slot_tri.size() / (size_t)leaf_size);
            out->leaf_chunk[my] = chunk;
            for (int64_t t = lo; t < hi; ++t)
                out->slot_tri.push_back(ids[order[t]]);
            for (int64_t t = hi - lo; t < leaf_size; ++t)
                out->slot_tri.push_back(-1);
            out->skip[my] = (int32_t)out->leaf_chunk.size();
            return;
        }

        float c_lo[3] = {3e38f, 3e38f, 3e38f};
        float c_hi[3] = {-3e38f, -3e38f, -3e38f};
        for (int64_t t = lo; t < hi; ++t) {
            const float* c = cent + 3 * (int64_t)order[t];
            for (int k = 0; k < 3; ++k) {
                c_lo[k] = std::min(c_lo[k], c[k]);
                c_hi[k] = std::max(c_hi[k], c[k]);
            }
        }
        int axis = 0;
        float ext = c_hi[0] - c_lo[0];
        for (int k = 1; k < 3; ++k)
            if (c_hi[k] - c_lo[k] > ext) { ext = c_hi[k] - c_lo[k]; axis = k; }

        int64_t mid = -1;
        // Past depth 48 force median splits so tree depth (and the
        // traversal stack) stays bounded (ops/bvh.py: MAX_SAH_DEPTH).
        if (ext > 1e-12f && depth < 48) {
            std::vector<int64_t> counts(n_bins, 0);
            std::vector<float> bn(6 * n_bins);
            for (int b = 0; b < n_bins; ++b) {
                bn[6 * b + 0] = bn[6 * b + 1] = bn[6 * b + 2] = 3e38f;
                bn[6 * b + 3] = bn[6 * b + 4] = bn[6 * b + 5] = -3e38f;
            }
            const float scale = (float)n_bins / ext;
            for (int64_t t = lo; t < hi; ++t) {
                int32_t tri = order[t];
                int b = (int)((cent[3 * (int64_t)tri + axis] - c_lo[axis]) * scale);
                b = std::min(b, n_bins - 1);
                counts[b]++;
                const float* mn = bmin + 3 * (int64_t)tri;
                const float* mx = bmax + 3 * (int64_t)tri;
                for (int k = 0; k < 3; ++k) {
                    bn[6 * b + k] = std::min(bn[6 * b + k], mn[k]);
                    bn[6 * b + 3 + k] = std::max(bn[6 * b + 3 + k], mx[k]);
                }
            }
            // Prefix/suffix areas -> SAH costs at each of n_bins-1 splits.
            auto area = [](const float* mn, const float* mx) {
                float d0 = std::max(mx[0] - mn[0], 0.0f);
                float d1 = std::max(mx[1] - mn[1], 0.0f);
                float d2 = std::max(mx[2] - mn[2], 0.0f);
                return (double)d0 * d1 + (double)d1 * d2 + (double)d2 * d0;
            };
            std::vector<double> pre_area(n_bins), suf_area(n_bins);
            std::vector<int64_t> pre_cnt(n_bins);
            float acc_mn[3], acc_mx[3];
            for (int k = 0; k < 3; ++k) { acc_mn[k] = 3e38f; acc_mx[k] = -3e38f; }
            int64_t cnt = 0;
            for (int b = 0; b < n_bins; ++b) {
                for (int k = 0; k < 3; ++k) {
                    acc_mn[k] = std::min(acc_mn[k], bn[6 * b + k]);
                    acc_mx[k] = std::max(acc_mx[k], bn[6 * b + 3 + k]);
                }
                cnt += counts[b];
                pre_area[b] = area(acc_mn, acc_mx);
                pre_cnt[b] = cnt;
            }
            for (int k = 0; k < 3; ++k) { acc_mn[k] = 3e38f; acc_mx[k] = -3e38f; }
            for (int b = n_bins - 1; b >= 0; --b) {
                for (int k = 0; k < 3; ++k) {
                    acc_mn[k] = std::min(acc_mn[k], bn[6 * b + k]);
                    acc_mx[k] = std::max(acc_mx[k], bn[6 * b + 3 + k]);
                }
                suf_area[b] = area(acc_mn, acc_mx);
            }
            int best = -1;
            double best_cost = 1e300;
            const int64_t total = hi - lo;
            for (int b = 0; b < n_bins - 1; ++b) {
                int64_t nl = pre_cnt[b], nr = total - nl;
                if (nl == 0 || nr == 0) continue;
                double cost = pre_area[b] * nl + suf_area[b + 1] * nr;
                if (cost < best_cost) { best_cost = cost; best = b; }
            }
            if (best >= 0) {
                // Stable near-side-first partition via scratch buffer.
                int64_t w0 = lo, w1 = 0;
                for (int64_t t = lo; t < hi; ++t) {
                    int32_t tri = order[t];
                    int b = (int)((cent[3 * (int64_t)tri + axis] - c_lo[axis]) * scale);
                    b = std::min(b, n_bins - 1);
                    if (b <= best) order[w0++] = tri;
                    else scratch[w1++] = tri;
                }
                std::memcpy(order + w0, scratch, (size_t)w1 * sizeof(int32_t));
                mid = w0;
            }
        }
        if (mid < 0) {
            std::stable_sort(order + lo, order + hi,
                             [&](int32_t a, int32_t b) {
                                 return cent[3 * (int64_t)a + axis] <
                                        cent[3 * (int64_t)b + axis];
                             });
            mid = lo + (hi - lo) / 2;
        }
        out->leaf_chunk[my] = -1 - axis;  // internal: encode the split axis
        emit(lo, mid, depth + 1);
        emit(mid, hi, depth + 1);
        out->skip[my] = (int32_t)out->leaf_chunk.size();
    }
};

}  // namespace

// tri_min/tri_max: (3, T) planar f32 (the WoopAccel layout); include: (T,)
// u8 mask or NULL.  Returns a handle; out_counts = {n_nodes, n_chunks}.
void* bvh_build(const float* tri_min, const float* tri_max, int64_t t_count,
                const uint8_t* include, int64_t leaf_size, int64_t n_bins,
                int64_t* out_counts) {
    std::vector<int32_t> ids;
    ids.reserve((size_t)t_count);
    for (int64_t t = 0; t < t_count; ++t)
        if (!include || include[t]) ids.push_back((int32_t)t);

    BvhData* d = new BvhData();
    d->leaf_size = leaf_size;
    const int64_t n = (int64_t)ids.size();
    if (n == 0) {
        const float big = 3e38f;
        d->nbox = {big, big, big, -big, -big, -big};
        d->leaf_chunk = {0};
        d->skip = {1};
        d->slot_tri.assign((size_t)leaf_size, -1);
        out_counts[0] = 1;
        out_counts[1] = 1;
        return d;
    }
    // Gather compact (T', 3) row-major boxes/centroids from planar input.
    std::vector<float> bmin(3 * n), bmax(3 * n), cent(3 * n);
    for (int64_t t = 0; t < n; ++t) {
        const int64_t tri = ids[(size_t)t];
        for (int k = 0; k < 3; ++k) {
            bmin[3 * t + k] = tri_min[k * t_count + tri];
            bmax[3 * t + k] = tri_max[k * t_count + tri];
            cent[3 * t + k] = 0.5f * (bmin[3 * t + k] + bmax[3 * t + k]);
        }
    }
    std::vector<int32_t> order(n), scratch(n);
    std::iota(order.begin(), order.end(), 0);
    // Builder indexes boxes by compact position; map back through ids.
    BvhBuilder builder{bmin.data(), bmax.data(),  cent.data(), ids.data(),
                       order.data(), scratch.data(), leaf_size,
                       (int)n_bins, d};
    builder.emit(0, n);
    out_counts[0] = (int64_t)d->leaf_chunk.size();
    out_counts[1] = (int64_t)(d->slot_tri.size() / (size_t)leaf_size);
    return d;
}

void bvh_read(void* handle, float* nbox, int32_t* leaf_chunk, int32_t* skip,
              int32_t* slot_tri) {
    BvhData* d = (BvhData*)handle;
    std::memcpy(nbox, d->nbox.data(), d->nbox.size() * sizeof(float));
    std::memcpy(leaf_chunk, d->leaf_chunk.data(),
                d->leaf_chunk.size() * sizeof(int32_t));
    std::memcpy(skip, d->skip.data(), d->skip.size() * sizeof(int32_t));
    std::memcpy(slot_tri, d->slot_tri.data(),
                d->slot_tri.size() * sizeof(int32_t));
}

void bvh_free(void* handle) { delete (BvhData*)handle; }

}  // extern "C"
