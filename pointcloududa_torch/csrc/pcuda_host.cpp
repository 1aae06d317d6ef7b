// Native host kernels for the data pipeline.
//
// The reference's point-cloud ground-truth chain (mask -> marching cubes ->
// farthest-point sampling, src/utils/npy2point.py) runs per-sample per-step
// in Python when MM-WHS augmentation is on — the documented host bottleneck
// (SURVEY.md §3.2). These kernels make that chain native:
//
//   - fps:            greedy farthest-point sampling, O(k*n), cache-friendly
//                     single pass per selected point (the reference's
//                     `graipher` allocates a full distance array per step in
//                     numpy; here the running min-distance stays in one
//                     buffer).
//   - boundary_voxels: 6-connected surface voxels of a binary 3-D slab
//                     (replaces the marching-cubes triangulation — vertices
//                     collapse onto the voxel grid after the reference's own
//                     int cast; see data/pointcloud.py).
//   - largest_component_2d / 3d: union-find connected components keeping
//                     the largest blob per label (skimage.measure.label +
//                     regionprops equivalent used by the evaluators).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// pts: n x d float64, out: k x d float64. Returns number written (== k).
int pcuda_fps(const double* pts, int64_t n, int64_t d, int64_t k,
              int64_t start, double* out) {
    if (n <= 0 || k <= 0) return 0;
    std::vector<double> dist(static_cast<size_t>(n));
    const double* p0 = pts + start * d;
    for (int64_t j = 0; j < d; ++j) out[j] = p0[j];
    for (int64_t i = 0; i < n; ++i) {
        double acc = 0.0;
        const double* pi = pts + i * d;
        for (int64_t j = 0; j < d; ++j) {
            double t = pi[j] - p0[j];
            acc += t * t;
        }
        dist[i] = acc;
    }
    for (int64_t sel = 1; sel < k; ++sel) {
        // argmax of running min-distance
        int64_t best = 0;
        double best_d = dist[0];
        for (int64_t i = 1; i < n; ++i) {
            if (dist[i] > best_d) { best_d = dist[i]; best = i; }
        }
        const double* pb = pts + best * d;
        double* ob = out + sel * d;
        for (int64_t j = 0; j < d; ++j) ob[j] = pb[j];
        // fold new distances into the running min
        for (int64_t i = 0; i < n; ++i) {
            double acc = 0.0;
            const double* pi = pts + i * d;
            for (int64_t j = 0; j < d; ++j) {
                double t = pi[j] - pb[j];
                acc += t * t;
            }
            if (acc < dist[i]) dist[i] = acc;
        }
    }
    return static_cast<int>(k);
}

// slab: nz*ny*nx uint8 (0/1). out: int64 triples (z,y,x), capacity max_out.
// Returns the number of boundary voxels found (may exceed max_out; only
// max_out triples are written).
int64_t pcuda_boundary_voxels(const uint8_t* slab, int64_t nz, int64_t ny,
                              int64_t nx, int64_t* out, int64_t max_out) {
    int64_t count = 0;
    const int64_t sy = nx, sz = ny * nx;
    for (int64_t z = 0; z < nz; ++z) {
        for (int64_t y = 0; y < ny; ++y) {
            const uint8_t* row = slab + z * sz + y * sy;
            for (int64_t x = 0; x < nx; ++x) {
                if (!row[x]) continue;
                bool boundary =
                    z == 0 || z == nz - 1 || y == 0 || y == ny - 1 ||
                    x == 0 || x == nx - 1 ||
                    !slab[(z - 1) * sz + y * sy + x] ||
                    !slab[(z + 1) * sz + y * sy + x] ||
                    !row[x - sy] || !row[x + sy] ||  // y-1, y+1 within plane
                    !row[x - 1] || !row[x + 1];
                if (boundary) {
                    if (count < max_out) {
                        int64_t* o = out + count * 3;
                        o[0] = z; o[1] = y; o[2] = x;
                    }
                    ++count;
                }
            }
        }
    }
    return count;
}

namespace {
struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }
    int32_t find(int32_t a) {
        while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
        return a;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a != b) parent[b] = a;
    }
};
}  // namespace

// Keep the largest 6-connected component of mask==label in a 3-D volume.
// mask: nz*ny*nx int32 labels; out: same shape uint8, set to 1 where kept.
void pcuda_largest_component(const int32_t* mask, int64_t nz, int64_t ny,
                             int64_t nx, int32_t label, uint8_t* out) {
    const int64_t n = nz * ny * nx;
    const int64_t sy = nx, sz = ny * nx;
    UnionFind uf(static_cast<size_t>(n));
    for (int64_t z = 0; z < nz; ++z)
        for (int64_t y = 0; y < ny; ++y)
            for (int64_t x = 0; x < nx; ++x) {
                int64_t i = z * sz + y * sy + x;
                if (mask[i] != label) continue;
                if (x + 1 < nx && mask[i + 1] == label) uf.unite((int32_t)i, (int32_t)(i + 1));
                if (y + 1 < ny && mask[i + sy] == label) uf.unite((int32_t)i, (int32_t)(i + sy));
                if (z + 1 < nz && mask[i + sz] == label) uf.unite((int32_t)i, (int32_t)(i + sz));
            }
    std::vector<int64_t> area(static_cast<size_t>(n), 0);
    int64_t best_root = -1, best_area = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (mask[i] != label) continue;
        int32_t r = uf.find((int32_t)i);
        if (++area[r] > best_area) { best_area = area[r]; best_root = r; }
    }
    std::memset(out, 0, static_cast<size_t>(n));
    if (best_root < 0) return;
    for (int64_t i = 0; i < n; ++i)
        if (mask[i] == label && uf.find((int32_t)i) == best_root) out[i] = 1;
}

}  // extern "C"
