// nrnative: native host-side runtime components for nrenderer_tpu.
//
// The reference framework is ~11k LoC of C++ end to end (SURVEY.md §2); the
// rebuild keeps the COMPUTE path in XLA/Pallas, and provides native
// implementations of the host-side runtime hot paths, loaded via ctypes with
// a pure-python fallback (nrenderer_tpu/native/__init__.py):
//
//   - nr_parse_obj:   Wavefront OBJ scan (v/vn/vt/f, triangulated) — the
//                     data-loader path (reference ObjImporter.cpp)
//   - nr_build_bvh:   median-split BVH build, preorder + escape indices —
//                     the accelerator-structure builder (reference BVH.hpp),
//                     iterative (explicit stack), stable sort
//   - nr_film_to_rgba8: clamp + sqrt-gamma + float->uint8 film conversion —
//                     the Screen handoff (reference Screen.cpp clamps,
//                     RGB2RGBi converts)
//
// Build: g++ -O3 -march=native -shared -fPIC nrnative.cpp -o libnrnative.so
// ABI: plain C, int64/float/double buffers owned by the caller (numpy).

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
// OBJ parsing
// ---------------------------------------------------------------------------

// First pass: count v/vt/vn/f records so the caller can allocate numpy
// buffers.  Returns 0 on success.
int nr_obj_count(const char* path, int64_t* n_v, int64_t* n_vt, int64_t* n_vn,
                 int64_t* n_f) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    *n_v = *n_vt = *n_vn = *n_f = 0;
    char line[4096];
    while (fgets(line, sizeof line, f)) {
        if (line[0] == 'v') {
            if (line[1] == ' ') ++*n_v;
            else if (line[1] == 't') ++*n_vt;
            else if (line[1] == 'n') ++*n_vn;
        } else if (line[0] == 'f' && line[1] == ' ') {
            ++*n_f;
        }
    }
    fclose(f);
    return 0;
}

static const char* parse_floats(const char* p, float* out, int n) {
    for (int i = 0; i < n; i++) {
        char* end;
        out[i] = strtof(p, &end);
        if (end == p) return nullptr;
        p = end;
    }
    return p;
}

// Second pass: fill the buffers.  Face indices are 1-based as in the file
// (negative = relative, resolved by the caller); missing t/n slots get 0.
// Returns the number of faces written, or -1 on error (e.g. a face with
// more than 3 vertices — the reference requires triangulated meshes).
int64_t nr_obj_parse(const char* path, float* v, float* vt, float* vn,
                     int64_t* f_v, int64_t* f_t, int64_t* f_n) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[4096];
    int64_t iv = 0, it = 0, in_ = 0, iface = 0;
    while (fgets(line, sizeof line, f)) {
        if (line[0] == 'v' && line[1] == ' ') {
            if (!parse_floats(line + 2, v + iv * 3, 3)) { fclose(f); return -1; }
            iv++;
        } else if (line[0] == 'v' && line[1] == 't') {
            if (!parse_floats(line + 3, vt + it * 2, 2)) { fclose(f); return -1; }
            it++;
        } else if (line[0] == 'v' && line[1] == 'n') {
            if (!parse_floats(line + 3, vn + in_ * 3, 3)) { fclose(f); return -1; }
            in_++;
        } else if (line[0] == 'f' && line[1] == ' ') {
            const char* p = line + 2;
            int corner = 0;
            while (*p) {
                while (*p == ' ' || *p == '\t') p++;
                if (*p == '\n' || *p == '\r' || *p == '\0') break;
                if (corner >= 3) { fclose(f); return -1; }  // not triangulated
                char* end;
                long vi = strtol(p, &end, 10);
                if (end == p) { fclose(f); return -1; }
                p = end;
                long ti = 0, ni = 0;
                if (*p == '/') {
                    p++;
                    if (*p != '/') { ti = strtol(p, &end, 10); p = end; }
                    if (*p == '/') { p++; ni = strtol(p, &end, 10); p = end; }
                }
                f_v[iface * 3 + corner] = vi;
                f_t[iface * 3 + corner] = ti;
                f_n[iface * 3 + corner] = ni;
                corner++;
            }
            if (corner != 3) { fclose(f); return -1; }
            iface++;
        }
    }
    fclose(f);
    return iface;
}

// ---------------------------------------------------------------------------
// BVH build (median object split, preorder, escape indices)
// ---------------------------------------------------------------------------

// bb_min/bb_max: (n, 3) float32.  Outputs sized 2n-1 rows (binary tree with
// 1-prim leaves): out_min/out_max (2n-1, 3), out_skip/out_prim (2n-1,).
// Returns node count, or -1 on error.
int64_t nr_build_bvh(const float* bb_min, const float* bb_max, int64_t n,
                     float* out_min, float* out_max, int32_t* out_skip,
                     int32_t* out_prim) {
    if (n <= 0) return -1;
    std::vector<int64_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    std::vector<float> cx(n), cy(n), cz(n);
    for (int64_t i = 0; i < n; i++) {
        cx[i] = 0.5f * (bb_min[i * 3 + 0] + bb_max[i * 3 + 0]);
        cy[i] = 0.5f * (bb_min[i * 3 + 1] + bb_max[i * 3 + 1]);
        cz[i] = 0.5f * (bb_min[i * 3 + 2] + bb_max[i * 3 + 2]);
    }

    struct Item { int64_t lo, hi; };  // range into idx
    std::vector<Item> stack;
    stack.push_back({0, n});
    int64_t node = 0;
    // explicit preorder emission: each popped range emits one node; internal
    // ranges are split with the right half pushed first (LIFO -> left first)
    while (!stack.empty()) {
        Item it = stack.back();
        stack.pop_back();
        int64_t count = it.hi - it.lo;
        float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = it.lo; i < it.hi; i++) {
            const float* a = bb_min + idx[i] * 3;
            const float* b = bb_max + idx[i] * 3;
            for (int k = 0; k < 3; k++) {
                mn[k] = std::min(mn[k], a[k]);
                mx[k] = std::max(mx[k], b[k]);
            }
        }
        int64_t me = node++;
        memcpy(out_min + me * 3, mn, sizeof mn);
        memcpy(out_max + me * 3, mx, sizeof mx);
        if (count == 1) {
            out_prim[me] = (int32_t)idx[it.lo];
            out_skip[me] = (int32_t)(me + 1);
            continue;
        }
        out_prim[me] = -1;
        // subtree size for a 1-prim-leaf binary tree is 2*count - 1
        out_skip[me] = (int32_t)(me + 2 * count - 1);
        float ext[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;
        const float* c = axis == 0 ? cx.data() : axis == 1 ? cy.data()
                                                           : cz.data();
        std::stable_sort(idx.begin() + it.lo, idx.begin() + it.hi,
                         [c](int64_t a, int64_t b) { return c[a] < c[b]; });
        int64_t half = count / 2;
        stack.push_back({it.lo + half, it.hi});  // right second (LIFO)
        stack.push_back({it.lo, it.lo + half});  // left first
    }
    return node;
}

// ---------------------------------------------------------------------------
// Film conversion: clamp + sqrt gamma + uint8 quantize (Screen.cpp semantics)
// ---------------------------------------------------------------------------

void nr_film_to_rgba8(const float* film, int64_t n_pix, int apply_gamma,
                      uint8_t* out) {
    for (int64_t i = 0; i < n_pix; i++) {
        for (int c = 0; c < 3; c++) {
            float v = film[i * 3 + c];
            if (apply_gamma) v = sqrtf(v > 0 ? v : 0);
            v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
            out[i * 4 + c] = (uint8_t)(v * 255.0f + 0.5f);
        }
        out[i * 4 + 3] = 255;
    }
}

}  // extern "C"
