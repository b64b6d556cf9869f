// segger_tpu_torch native spatial core: the port's copy of the JAX
// package's csrc/spatial.cpp, with the same C ABI and version.
//
// Host-side replacements for the reference's cuSpatial/cuML hot paths
// (reference: src/segger/geometry/query.py quadtree join,
// src/segger/data/utils/neighbors.py KDTree kNN), as plain C++ with
// OpenMP: a uniform-grid spatial hash drives both the
// point-in-(buffered)-polygon join and fixed-radius kNN.  Exposed with a
// C ABI for ctypes (segger_tpu_torch/native.py builds and binds it).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC spatial.cpp -o spatial.so

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>
#include <atomic>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Grid {
    double x0, y0, cell;
    int64_t nx, ny;
    // CSR of point ids per cell
    std::vector<int64_t> starts;  // nx*ny + 1
    std::vector<int64_t> ids;

    void build(const double* pts, int64_t n, double cell_size) {
        double x1 = -1e300, y1 = -1e300;
        x0 = 1e300; y0 = 1e300;
        for (int64_t i = 0; i < n; ++i) {
            x0 = std::min(x0, pts[2 * i]);
            y0 = std::min(y0, pts[2 * i + 1]);
            x1 = std::max(x1, pts[2 * i]);
            y1 = std::max(y1, pts[2 * i + 1]);
        }
        cell = std::max(cell_size, 1e-9);
        nx = std::max<int64_t>(1, (int64_t)((x1 - x0) / cell) + 1);
        ny = std::max<int64_t>(1, (int64_t)((y1 - y0) / cell) + 1);
        // cap memory: grow cell if too many cells
        while (nx * ny > 4 * n + 1024) {
            cell *= 1.5;
            nx = std::max<int64_t>(1, (int64_t)((x1 - x0) / cell) + 1);
            ny = std::max<int64_t>(1, (int64_t)((y1 - y0) / cell) + 1);
        }
        std::vector<int64_t> counts(nx * ny + 1, 0);
        std::vector<int64_t> cidx(n);
        for (int64_t i = 0; i < n; ++i) {
            int64_t cx = std::min<int64_t>((int64_t)((pts[2*i] - x0) / cell), nx - 1);
            int64_t cy = std::min<int64_t>((int64_t)((pts[2*i+1] - y0) / cell), ny - 1);
            cidx[i] = cy * nx + cx;
            counts[cidx[i] + 1]++;
        }
        starts.resize(nx * ny + 1);
        starts[0] = 0;
        for (int64_t c = 0; c < nx * ny; ++c)
            starts[c + 1] = starts[c] + counts[c + 1];
        ids.resize(n);
        std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
        for (int64_t i = 0; i < n; ++i) ids[cursor[cidx[i]]++] = i;
    }

    inline int64_t cx_of(double x) const {
        int64_t c = (int64_t)((x - x0) / cell);
        return std::max<int64_t>(0, std::min(c, nx - 1));
    }
    inline int64_t cy_of(double y) const {
        int64_t c = (int64_t)((y - y0) / cell);
        return std::max<int64_t>(0, std::min(c, ny - 1));
    }
};

inline bool ray_cast_inside(double px, double py, const double* v,
                            int64_t nv) {
    bool inside = false;
    for (int64_t i = 0, j = nv - 1; i < nv; j = i++) {
        double xi = v[2 * i], yi = v[2 * i + 1];
        double xj = v[2 * j], yj = v[2 * j + 1];
        if (((yi > py) != (yj > py)) &&
            (px < xi + (py - yi) / (yj - yi) * (xj - xi)))
            inside = !inside;
    }
    return inside;
}

inline double dist2_to_edges(double px, double py, const double* v,
                             int64_t nv) {
    double best = 1e300;
    for (int64_t i = 0, j = nv - 1; i < nv; j = i++) {
        double ax = v[2 * j], ay = v[2 * j + 1];
        double bx = v[2 * i], by = v[2 * i + 1];
        double dx = bx - ax, dy = by - ay;
        double denom = dx * dx + dy * dy;
        double t = denom > 1e-30
                       ? ((px - ax) * dx + (py - ay) * dy) / denom
                       : 0.0;
        t = std::max(0.0, std::min(1.0, t));
        double qx = ax + t * dx - px, qy = ay + t * dy - py;
        best = std::min(best, qx * qx + qy * qy);
    }
    return best;
}

}  // namespace

extern "C" {

// Point-in-(buffered)-polygon spatial join.
// pts: (n_pts, 2) row-major; verts: flattened polygon vertices;
// offsets: (n_polys+1) vertex offsets; dists: per-polygon buffer.
// Fills out_pt/out_poly up to capacity; returns total pair count
// (callers re-invoke with larger buffers when count > capacity).
int64_t sgt_points_in_polygons(
    const double* pts, int64_t n_pts,
    const double* verts, const int64_t* offsets, int64_t n_polys,
    const double* dists,
    int64_t* out_pt, int64_t* out_poly, int64_t capacity) {
    if (n_pts == 0 || n_polys == 0) return 0;
    // grid cell ~ median polygon bbox size
    std::vector<double> widths(n_polys);
    for (int64_t p = 0; p < n_polys; ++p) {
        const double* v = verts + 2 * offsets[p];
        int64_t nv = offsets[p + 1] - offsets[p];
        double x0 = 1e300, x1 = -1e300, y0 = 1e300, y1 = -1e300;
        for (int64_t i = 0; i < nv; ++i) {
            x0 = std::min(x0, v[2 * i]); x1 = std::max(x1, v[2 * i]);
            y0 = std::min(y0, v[2 * i + 1]); y1 = std::max(y1, v[2 * i + 1]);
        }
        widths[p] = std::max(x1 - x0, y1 - y0);
    }
    std::vector<double> wsort(widths);
    std::nth_element(wsort.begin(), wsort.begin() + n_polys / 2,
                     wsort.end());
    double cell = std::max(wsort[n_polys / 2], 1e-6);

    Grid grid;
    grid.build(pts, n_pts, cell);

    std::atomic<int64_t> total(0);

#pragma omp parallel
    {
        std::vector<int64_t> loc_pt, loc_poly;
#pragma omp for schedule(dynamic, 16)
        for (int64_t p = 0; p < n_polys; ++p) {
            const double* v = verts + 2 * offsets[p];
            int64_t nv = offsets[p + 1] - offsets[p];
            if (nv < 3) continue;
            double d = dists ? dists[p] : 0.0;
            double d2 = d * d;
            double x0 = 1e300, x1 = -1e300, y0 = 1e300, y1 = -1e300;
            for (int64_t i = 0; i < nv; ++i) {
                x0 = std::min(x0, v[2 * i]); x1 = std::max(x1, v[2 * i]);
                y0 = std::min(y0, v[2 * i + 1]);
                y1 = std::max(y1, v[2 * i + 1]);
            }
            int64_t cx0 = grid.cx_of(x0 - d), cx1 = grid.cx_of(x1 + d);
            int64_t cy0 = grid.cy_of(y0 - d), cy1 = grid.cy_of(y1 + d);
            for (int64_t cy = cy0; cy <= cy1; ++cy)
                for (int64_t cx = cx0; cx <= cx1; ++cx) {
                    int64_t c = cy * grid.nx + cx;
                    for (int64_t s = grid.starts[c];
                         s < grid.starts[c + 1]; ++s) {
                        int64_t i = grid.ids[s];
                        double px = pts[2 * i], py = pts[2 * i + 1];
                        if (px < x0 - d || px > x1 + d || py < y0 - d ||
                            py > y1 + d)
                            continue;
                        bool hit = ray_cast_inside(px, py, v, nv);
                        if (!hit && d > 0)
                            hit = dist2_to_edges(px, py, v, nv) <= d2;
                        if (hit) {
                            loc_pt.push_back(i);
                            loc_poly.push_back(p);
                        }
                    }
                }
        }
        int64_t base = total.fetch_add((int64_t)loc_pt.size());
        int64_t writable = std::max<int64_t>(
            0, std::min<int64_t>((int64_t)loc_pt.size(),
                                 capacity - base));
        for (int64_t i = 0; i < writable; ++i) {
            out_pt[base + i] = loc_pt[i];
            out_poly[base + i] = loc_poly[i];
        }
    }
    return total.load();
}

// Fixed-radius kNN via the uniform grid: for each query, the k nearest
// points within max_dist.  out_idx is (nq, k), padded with -1.
void sgt_grid_knn(
    const double* pts, int64_t n,
    const double* qpts, int64_t nq,
    int32_t k, double max_dist,
    int64_t* out_idx, double* out_dist) {
    if (n == 0 || nq == 0 || k <= 0) return;
    Grid grid;
    grid.build(pts, n, max_dist > 0 && std::isfinite(max_dist)
                           ? max_dist
                           : 1.0);
    double r2 = max_dist * max_dist;

#pragma omp parallel for schedule(static)
    for (int64_t q = 0; q < nq; ++q) {
        double px = qpts[2 * q], py = qpts[2 * q + 1];
        // expanding ring search until k found or radius exceeded
        std::vector<std::pair<double, int64_t>> best;
        best.reserve(k * 2);
        int64_t cx = grid.cx_of(px), cy = grid.cy_of(py);
        int64_t max_ring =
            std::isfinite(max_dist)
                ? (int64_t)(max_dist / grid.cell) + 1
                : std::max(grid.nx, grid.ny);
        for (int64_t ring = 0; ring <= max_ring; ++ring) {
            // once we have k candidates, stop if the ring cannot beat
            // the current kth distance
            if ((int64_t)best.size() >= k) {
                double kth = best.front().first;  // max-heap root
                double ring_min = (double)(ring - 1) * grid.cell;
                if (ring_min > 0 && ring_min * ring_min > kth) break;
            }
            int64_t lo_x = cx - ring, hi_x = cx + ring;
            int64_t lo_y = cy - ring, hi_y = cy + ring;
            for (int64_t gy = lo_y; gy <= hi_y; ++gy) {
                if (gy < 0 || gy >= grid.ny) continue;
                for (int64_t gx = lo_x; gx <= hi_x; ++gx) {
                    if (gx < 0 || gx >= grid.nx) continue;
                    // only the ring boundary (interior done earlier)
                    if (ring > 0 && gx != lo_x && gx != hi_x &&
                        gy != lo_y && gy != hi_y)
                        continue;
                    int64_t c = gy * grid.nx + gx;
                    for (int64_t s = grid.starts[c];
                         s < grid.starts[c + 1]; ++s) {
                        int64_t i = grid.ids[s];
                        double dx = pts[2 * i] - px,
                               dy = pts[2 * i + 1] - py;
                        double d2 = dx * dx + dy * dy;
                        if (std::isfinite(max_dist) && d2 > r2)
                            continue;
                        if ((int64_t)best.size() < k) {
                            best.emplace_back(d2, i);
                            std::push_heap(best.begin(), best.end());
                        } else if (d2 < best.front().first) {
                            std::pop_heap(best.begin(), best.end());
                            best.back() = {d2, i};
                            std::push_heap(best.begin(), best.end());
                        }
                    }
                }
            }
        }
        std::sort_heap(best.begin(), best.end());
        for (int32_t j = 0; j < k; ++j) {
            if (j < (int64_t)best.size()) {
                out_idx[q * k + j] = best[j].second;
                if (out_dist)
                    out_dist[q * k + j] = std::sqrt(best[j].first);
            } else {
                out_idx[q * k + j] = -1;
                if (out_dist) out_dist[q * k + j] = -1.0;
            }
        }
    }
}

// Morton (Z-order) codes for spatial-locality sorting.
void sgt_morton_codes(const double* pts, int64_t n, uint64_t* out) {
    double x0 = 1e300, y0 = 1e300, x1 = -1e300, y1 = -1e300;
    for (int64_t i = 0; i < n; ++i) {
        x0 = std::min(x0, pts[2 * i]); x1 = std::max(x1, pts[2 * i]);
        y0 = std::min(y0, pts[2 * i + 1]);
        y1 = std::max(y1, pts[2 * i + 1]);
    }
    double sx = x1 > x0 ? (double)((1u << 31) - 1) / (x1 - x0) : 0.0;
    double sy = y1 > y0 ? (double)((1u << 31) - 1) / (y1 - y0) : 0.0;
    auto spread = [](uint64_t v) {
        v &= 0xffffffffull;
        v = (v | (v << 16)) & 0x0000ffff0000ffffull;
        v = (v | (v << 8)) & 0x00ff00ff00ff00ffull;
        v = (v | (v << 4)) & 0x0f0f0f0f0f0f0f0full;
        v = (v | (v << 2)) & 0x3333333333333333ull;
        v = (v | (v << 1)) & 0x5555555555555555ull;
        return v;
    };
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint64_t gx = (uint64_t)((pts[2 * i] - x0) * sx);
        uint64_t gy = (uint64_t)((pts[2 * i + 1] - y0) * sy);
        out[i] = spread(gx) | (spread(gy) << 1);
    }
}

// Expanded-box membership: which points fall in each leaf box expanded
// by `margin` (multi-membership; the prediction-halo labeling).
// boxes: (n_boxes, 4) row-major x0,y0,x1,y1 half-open.
// Fills out_pt/out_box up to capacity; returns the total pair count.
int64_t sgt_points_in_boxes(
    const double* pts, int64_t n_pts,
    const double* boxes, int64_t n_boxes,
    double margin,
    int64_t* out_pt, int64_t* out_box, int64_t capacity) {
    if (n_pts == 0 || n_boxes == 0) return 0;
    double wsum = 0;
    for (int64_t b = 0; b < n_boxes; ++b)
        wsum += std::max(boxes[4 * b + 2] - boxes[4 * b],
                         boxes[4 * b + 3] - boxes[4 * b + 1]);
    Grid grid;
    grid.build(pts, n_pts, std::max(wsum / n_boxes, 1e-6));

    std::atomic<int64_t> total(0);
#pragma omp parallel
    {
        std::vector<int64_t> loc_pt, loc_box;
#pragma omp for schedule(dynamic, 8)
        for (int64_t b = 0; b < n_boxes; ++b) {
            double x0 = boxes[4 * b] - margin;
            double y0 = boxes[4 * b + 1] - margin;
            double x1 = boxes[4 * b + 2] + margin;
            double y1 = boxes[4 * b + 3] + margin;
            int64_t cx0 = grid.cx_of(x0), cx1 = grid.cx_of(x1);
            int64_t cy0 = grid.cy_of(y0), cy1 = grid.cy_of(y1);
            for (int64_t cy = cy0; cy <= cy1; ++cy)
                for (int64_t cx = cx0; cx <= cx1; ++cx) {
                    int64_t c = cy * grid.nx + cx;
                    for (int64_t s = grid.starts[c];
                         s < grid.starts[c + 1]; ++s) {
                        int64_t i = grid.ids[s];
                        double px = pts[2 * i], py = pts[2 * i + 1];
                        if (px >= x0 && px < x1 && py >= y0 && py < y1) {
                            loc_pt.push_back(i);
                            loc_box.push_back(b);
                        }
                    }
                }
        }
        int64_t base = total.fetch_add((int64_t)loc_pt.size());
        int64_t writable = std::max<int64_t>(
            0, std::min<int64_t>((int64_t)loc_pt.size(),
                                 capacity - base));
        for (int64_t i = 0; i < writable; ++i) {
            out_pt[base + i] = loc_pt[i];
            out_box[base + i] = loc_box[i];
        }
    }
    return total.load();
}

// Common-neighbor counts for edges of an undirected simple graph in CSR
// form (indices sorted within each row).  out[e] = |N(eu[e]) & N(ev[e])|.
// This replaces the Jaccard stage's (A @ A).multiply(A) SpGEMM, which
// materializes the FULL n*k^2 product (57 GB / single-threaded hours at
// 4M cells); the edge-wise sorted merge is O(E*k) and parallel.
int64_t sgt_common_neighbor_counts(
    const int64_t* indptr, const int64_t* indices,
    const int64_t* eu, const int64_t* ev, int64_t n_edges,
    int64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t a = indptr[eu[e]], a_end = indptr[eu[e] + 1];
        int64_t b = indptr[ev[e]], b_end = indptr[ev[e] + 1];
        int64_t c = 0;
        while (a < a_end && b < b_end) {
            int64_t va = indices[a], vb = indices[b];
            if (va == vb) { ++c; ++a; ++b; }
            else if (va < vb) ++a;
            else ++b;
        }
        out[e] = c;
    }
    return n_edges;
}

int sgt_version() { return 3; }

}  // extern "C"
