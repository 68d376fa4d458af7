// Native PLOC BVH builder — the framework's host-side native hot loop.
//
// Plays the role of the reference's `obvhs` Rust crate (Parallel Locally-Ordered
// Clustering, search radius 24, U64 morton precision — src/raytracing/extract.rs:316-321).
// Algorithm: sort leaves by 63-bit morton code of their AABB centroid, then
// repeatedly merge mutually-nearest clusters (surface-area metric) within a sliding
// search window until one cluster remains.
//
// Exported C ABI (consumed via ctypes from ../native.py):
//   int ploc_build(n, bmin[n*3], bmax[n*3], radius,
//                  out node_min[(2n-1)*3], node_max, left, right, prim)
// Returns the root node id, or -1 on error. Leaves are nodes [0, n) with
// prim[i] = i; internal nodes are appended in merge order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t expand_bits_21(uint64_t v) {
  v &= 0x1FFFFFULL;
  v = (v | (v << 32)) & 0x1F00000000FFFFULL;
  v = (v | (v << 16)) & 0x1F0000FF0000FFULL;
  v = (v | (v << 8)) & 0x100F00F00F00F00FULL;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ULL;
  v = (v | (v << 2)) & 0x1249249249249249ULL;
  return v;
}

inline double surface_area(const float* mn, const float* mx) {
  double dx = std::max(0.0, (double)mx[0] - mn[0]);
  double dy = std::max(0.0, (double)mx[1] - mn[1]);
  double dz = std::max(0.0, (double)mx[2] - mn[2]);
  return 2.0 * (dx * dy + dy * dz + dz * dx);
}

inline double merged_sa(const float* amn, const float* amx, const float* bmn,
                        const float* bmx) {
  float mn[3], mx[3];
  for (int k = 0; k < 3; ++k) {
    mn[k] = std::min(amn[k], bmn[k]);
    mx[k] = std::max(amx[k], bmx[k]);
  }
  return surface_area(mn, mx);
}

}  // namespace

extern "C" int ploc_build(int n, const float* bmin, const float* bmax,
                          int search_radius, float* node_min, float* node_max,
                          int* left, int* right, int* prim) {
  if (n <= 0) return -1;
  const int m_total = 2 * n - 1;

  // Leaves.
  std::memcpy(node_min, bmin, sizeof(float) * 3 * n);
  std::memcpy(node_max, bmax, sizeof(float) * 3 * n);
  for (int i = 0; i < m_total; ++i) {
    left[i] = -1;
    right[i] = -1;
    prim[i] = i < n ? i : -1;
  }
  if (n == 1) return 0;

  // Morton order of centroids (U64 precision, extract.rs:319).
  float lo[3] = {bmin[0], bmin[1], bmin[2]};
  float hi[3] = {bmax[0], bmax[1], bmax[2]};
  std::vector<float> cent(3 * n);
  for (int i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      float c = 0.5f * (bmin[3 * i + k] + bmax[3 * i + k]);
      cent[3 * i + k] = c;
      lo[k] = std::min(lo[k], c);
      hi[k] = std::max(hi[k], c);
    }
  }
  std::vector<uint64_t> codes(n);
  for (int i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int k = 0; k < 3; ++k) {
      double extent = std::max((double)hi[k] - lo[k], 1e-12);
      double t = (cent[3 * i + k] - lo[k]) / extent * 2097151.0;
      q[k] = (uint64_t)std::min(std::max(t, 0.0), 2097151.0);
    }
    codes[i] = expand_bits_21(q[0]) | (expand_bits_21(q[1]) << 1) |
               (expand_bits_21(q[2]) << 2);
  }
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return codes[a] < codes[b]; });

  // Cluster arrays in morton order.
  std::vector<int> cl_id(order.begin(), order.end());
  std::vector<float> cl_min(3 * n), cl_max(3 * n);
  for (int i = 0; i < n; ++i) {
    std::memcpy(&cl_min[3 * i], &bmin[3 * order[i]], 12);
    std::memcpy(&cl_max[3 * i], &bmax[3 * order[i]], 12);
  }

  int next_node = n;
  int k = n;
  std::vector<int> best_j(n);
  std::vector<double> best_cost(n);
  std::vector<char> dead(n);

  while (k > 1) {
    const int r = std::min(search_radius, k - 1);
    for (int i = 0; i < k; ++i) {
      best_cost[i] = 1e300;
      best_j[i] = -1;
    }
    for (int d = 1; d <= r; ++d) {
      for (int i = 0; i + d < k; ++i) {
        const int j = i + d;
        double sa = merged_sa(&cl_min[3 * i], &cl_max[3 * i], &cl_min[3 * j],
                              &cl_max[3 * j]);
        if (sa < best_cost[i]) { best_cost[i] = sa; best_j[i] = j; }
        if (sa < best_cost[j]) { best_cost[j] = sa; best_j[j] = i; }
      }
    }
    std::fill(dead.begin(), dead.begin() + k, 0);
    int merged = 0;
    for (int i = 0; i < k; ++i) {
      const int j = best_j[i];
      if (j > i && best_j[j] == i) {
        // Mutual pair: emit internal node into the left slot.
        const int id = next_node++;
        left[id] = cl_id[i];
        right[id] = cl_id[j];
        for (int c = 0; c < 3; ++c) {
          node_min[3 * id + c] = std::min(cl_min[3 * i + c], cl_min[3 * j + c]);
          node_max[3 * id + c] = std::max(cl_max[3 * i + c], cl_max[3 * j + c]);
        }
        cl_id[i] = id;
        std::memcpy(&cl_min[3 * i], &node_min[3 * id], 12);
        std::memcpy(&cl_max[3 * i], &node_max[3 * id], 12);
        dead[j] = 1;
        ++merged;
      }
    }
    if (merged == 0) return -1;  // cannot happen: global min pair is mutual
    int w = 0;
    for (int i = 0; i < k; ++i) {
      if (dead[i]) continue;
      if (w != i) {
        cl_id[w] = cl_id[i];
        std::memcpy(&cl_min[3 * w], &cl_min[3 * i], 12);
        std::memcpy(&cl_max[3 * w], &cl_max[3 * i], 12);
      }
      ++w;
    }
    k = w;
  }
  return cl_id[0];
}
