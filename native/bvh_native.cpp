// Native binned-SAH BVH builder.
//
// The framework's host-side native component: the scene/BVH build is
// host work (the reference builds its acceleration structures in C++ too —
// OptixWrapper::BuildGeometryAccelerationStructure, OptixWrapper.cpp:46-78);
// the pure-numpy builder in accel/sah.py is the reference implementation and
// fallback, this C++ path makes million-triangle builds interactive.
//
// Semantics match accel/sah.py build_sah_arrays exactly:
//  - 16-bin SAH on the largest centroid-extent axis, object-median fallback
//  - leaves of <= leaf_size triangles, DFS emission order (left = node+1)
//  - child0 < 0 encodes leaf index -(i+1); order[] holds original tri ids
//    per fixed-size leaf slot (-1 padding).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dx * dz;
  }
};

struct Task {
  int32_t begin, end;   // range in the index array
  int32_t parent;       // parent node slot (-1 = root)
  int32_t which;        // 0 = left, 1 = right
  int32_t depth;
};

}  // namespace

extern "C" int lumen_build_sah(
    const float* tris,     // (n, 3, 3) row-major
    int32_t n,
    int32_t leaf_size,
    float* node_lo,        // (max_nodes, 3)
    float* node_hi,        // (max_nodes, 3)
    int32_t* child0,       // (max_nodes,)
    int32_t* child1,       // (max_nodes,)
    int32_t* order,        // (max_slots,) filled with tri ids / -1
    int32_t max_nodes,
    int32_t max_slots,
    int32_t* n_nodes_out,
    int32_t* n_leaves_out,
    int32_t* max_depth_out) {
  if (n <= 0) return -1;

  std::vector<Box> tri_box(n);
  std::vector<Vec3> cent(n);
  for (int i = 0; i < n; ++i) {
    const float* t = tris + i * 9;
    Box b;
    for (int v = 0; v < 3; ++v) {
      Vec3 p{t[v * 3], t[v * 3 + 1], t[v * 3 + 2]};
      b.lo = vmin(b.lo, p);
      b.hi = vmax(b.hi, p);
    }
    tri_box[i] = b;
    cent[i] = {(b.lo.x + b.hi.x) * 0.5f, (b.lo.y + b.hi.y) * 0.5f,
               (b.lo.z + b.hi.z) * 0.5f};
  }

  std::vector<int32_t> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;

  int32_t n_nodes = 0, n_leaves = 0, max_depth = 1;
  std::vector<Task> stack;
  stack.push_back({0, n, -1, 0, 1});

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    if (n_nodes >= max_nodes) return -2;
    int32_t ni = n_nodes++;
    if (task.parent >= 0) {
      (task.which == 0 ? child0 : child1)[task.parent] = ni;
    }
    max_depth = std::max(max_depth, task.depth);

    Box bounds;
    for (int32_t i = task.begin; i < task.end; ++i) bounds.grow(tri_box[idx[i]]);
    node_lo[ni * 3 + 0] = bounds.lo.x;
    node_lo[ni * 3 + 1] = bounds.lo.y;
    node_lo[ni * 3 + 2] = bounds.lo.z;
    node_hi[ni * 3 + 0] = bounds.hi.x;
    node_hi[ni * 3 + 1] = bounds.hi.y;
    node_hi[ni * 3 + 2] = bounds.hi.z;
    child0[ni] = 0;
    child1[ni] = 0;

    int32_t count = task.end - task.begin;
    if (count <= leaf_size) {
      if ((n_leaves + 1) * leaf_size > max_slots) return -3;
      int32_t base = n_leaves * leaf_size;
      for (int32_t k = 0; k < leaf_size; ++k)
        order[base + k] = (k < count) ? idx[task.begin + k] : -1;
      child0[ni] = -(n_leaves + 1);
      ++n_leaves;
      continue;
    }

    // centroid bounds
    Vec3 clo{1e30f, 1e30f, 1e30f}, chi{-1e30f, -1e30f, -1e30f};
    for (int32_t i = task.begin; i < task.end; ++i) {
      clo = vmin(clo, cent[idx[i]]);
      chi = vmax(chi, cent[idx[i]]);
    }
    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int32_t mid = -1;
    if (ext[axis] > 1e-12f) {
      float clo_a = (axis == 0) ? clo.x : (axis == 1) ? clo.y : clo.z;
      float scale = kBins * (1.0f - 1e-6f) / ext[axis];
      Box bin_box[kBins];
      int32_t bin_cnt[kBins] = {0};
      auto bin_of = [&](int32_t tri) {
        float c = (axis == 0) ? cent[tri].x : (axis == 1) ? cent[tri].y : cent[tri].z;
        int b = static_cast<int>((c - clo_a) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int32_t i = task.begin; i < task.end; ++i) {
        int b = bin_of(idx[i]);
        bin_box[b].grow(tri_box[idx[i]]);
        ++bin_cnt[b];
      }
      // sweep costs
      Box suffix[kBins];
      Box acc;
      for (int b = kBins - 1; b >= 0; --b) {
        if (bin_cnt[b]) acc.grow(bin_box[b]);
        suffix[b] = acc;
      }
      float best_cost = 1e30f;
      int best_b = -1;
      Box pre;
      int32_t cl = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        if (bin_cnt[b]) pre.grow(bin_box[b]);
        cl += bin_cnt[b];
        int32_t cr = count - cl;
        if (cl == 0 || cr == 0) continue;
        float cost = pre.half_area() * cl + suffix[b + 1].half_area() * cr;
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
      if (best_b >= 0) {
        auto it = std::partition(
            idx.begin() + task.begin, idx.begin() + task.end,
            [&](int32_t tri) { return bin_of(tri) <= best_b; });
        mid = static_cast<int32_t>(it - idx.begin());
        if (mid == task.begin || mid == task.end) mid = -1;
      }
    }
    if (mid < 0) {
      // object median fallback on the chosen axis
      mid = task.begin + count / 2;
      std::nth_element(
          idx.begin() + task.begin, idx.begin() + mid, idx.begin() + task.end,
          [&](int32_t a, int32_t b) {
            float ca = (axis == 0) ? cent[a].x : (axis == 1) ? cent[a].y : cent[a].z;
            float cb = (axis == 0) ? cent[b].x : (axis == 1) ? cent[b].y : cent[b].z;
            return ca < cb;
          });
    }
    // push right first so left pops next (DFS order: left = ni+1)
    stack.push_back({mid, task.end, ni, 1, task.depth + 1});
    stack.push_back({task.begin, mid, ni, 0, task.depth + 1});
  }

  *n_nodes_out = n_nodes;
  *n_leaves_out = n_leaves;
  *max_depth_out = max_depth;
  return 0;
}
