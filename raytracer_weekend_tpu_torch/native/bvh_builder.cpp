// Native BVH builder: flattened, stackless-traversal-ready layout.
//
// TPU-native rebuild of the reference's recursive pointer-based BVH
// (raytracer_weekend_lib/src/bvh.rs:18-74). Differences by design:
//   * deterministic split axis: largest centroid extent (the reference picks
//     a random axis per node, bvh.rs:25 — fine for CPU pointer chasing, but
//     determinism is required for reproducible sharded renders);
//   * median split over centroid order (reference sorts by AABB min and
//     splits at median, bvh.rs:44-52 — same O(n log^2 n) shape);
//   * output is a flat DFS array with skip links instead of child pointers,
//     the layout a vectorized / Pallas traversal consumes:
//       node i: bbox [min,max], prim = primitive id (leaf) or -1 (inner),
//               skip = next node index when the ray misses bbox i
//     Traversal: idx=0; while idx<n: hit(bbox)? (leaf? test prim) idx+1
//                : idx=skip[idx].
//
// The port's copy of the JAX package's native/bvh_builder.cpp, byte for
// byte in its code. Built by the host C++ compiler at first use and bound
// through ctypes (native/__init__.py); `_build_bvh_numpy` there is its plain
// version, with the identical layout, for the tests.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct BuildEntry {
  float bmin[3];
  float bmax[3];
  float centroid[3];
  int32_t prim;
};

struct Node {
  float bmin[3];
  float bmax[3];
  int32_t prim;   // leaf: primitive id; inner: -1
  int32_t skip;   // filled in a second pass
};

void build_recursive(std::vector<BuildEntry>& entries, int lo, int hi,
                     std::vector<Node>& nodes, int leaf_size) {
  Node node;
  for (int a = 0; a < 3; ++a) {
    node.bmin[a] = 1e30f;
    node.bmax[a] = -1e30f;
  }
  for (int i = lo; i < hi; ++i) {
    for (int a = 0; a < 3; ++a) {
      node.bmin[a] = std::min(node.bmin[a], entries[i].bmin[a]);
      node.bmax[a] = std::max(node.bmax[a], entries[i].bmax[a]);
    }
  }
  if (hi - lo <= leaf_size) {
    // Emit one leaf node per primitive sharing the range (leaf_size is 1 by
    // default, matching one-primitive leaves).
    for (int i = lo; i < hi; ++i) {
      Node leaf;
      for (int a = 0; a < 3; ++a) {
        leaf.bmin[a] = entries[i].bmin[a];
        leaf.bmax[a] = entries[i].bmax[a];
      }
      leaf.prim = entries[i].prim;
      leaf.skip = -1;
      nodes.push_back(leaf);
    }
    return;
  }

  node.prim = -1;
  node.skip = -1;
  // Largest centroid extent axis.
  float cmin[3] = {1e30f, 1e30f, 1e30f};
  float cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = lo; i < hi; ++i) {
    for (int a = 0; a < 3; ++a) {
      cmin[a] = std::min(cmin[a], entries[i].centroid[a]);
      cmax[a] = std::max(cmax[a], entries[i].centroid[a]);
    }
  }
  int axis = 0;
  float best = cmax[0] - cmin[0];
  for (int a = 1; a < 3; ++a) {
    float e = cmax[a] - cmin[a];
    if (e > best) {
      best = e;
      axis = a;
    }
  }

  int mid = (lo + hi) / 2;
  std::nth_element(entries.begin() + lo, entries.begin() + mid,
                   entries.begin() + hi,
                   [axis](const BuildEntry& x, const BuildEntry& y) {
                     return x.centroid[axis] < y.centroid[axis];
                   });

  nodes.push_back(node);
  size_t self = nodes.size() - 1;
  build_recursive(entries, lo, mid, nodes, leaf_size);
  build_recursive(entries, mid, hi, nodes, leaf_size);
  (void)self;
}

// Second pass: skip[i] = index of the node following i's subtree.
void fill_skips(std::vector<Node>& nodes) {
  // Subtree extent: computed by walking with an explicit stack of open
  // inner nodes; since the layout is DFS, a node's subtree ends where the
  // parent's next sibling begins. Easiest: recompute sizes recursively.
  // subtree_size(i): leaf -> 1; inner -> 1 + left + right sizes. We don't
  // store child counts, so recover sizes with a linear walk using prim<0.
  // DFS property: inner node at i has left subtree at i+1.
  int n = (int)nodes.size();
  std::vector<int> size(n, 1);
  // Process backwards: an inner node's subtree = 1 + size[i+1] + size[i+1+size[i+1]]
  for (int i = n - 1; i >= 0; --i) {
    if (nodes[i].prim < 0) {
      int left = i + 1;
      int right = left + size[left];
      size[i] = 1 + size[left] + size[right];
    }
  }
  for (int i = 0; i < n; ++i) {
    nodes[i].skip = i + size[i];
  }
}

}  // namespace

extern "C" {

// Build a BVH over n primitive AABBs.
//   bmin, bmax: (n,3) float32
//   out_* buffers must hold up to 2*n entries.
// Returns the node count.
int32_t rtw_build_bvh(const float* bmin, const float* bmax, int32_t n,
                      int32_t leaf_size, float* out_bmin, float* out_bmax,
                      int32_t* out_prim, int32_t* out_skip) {
  if (n <= 0) return 0;
  std::vector<BuildEntry> entries(n);
  for (int i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      entries[i].bmin[a] = bmin[3 * i + a];
      entries[i].bmax[a] = bmax[3 * i + a];
      entries[i].centroid[a] = 0.5f * (bmin[3 * i + a] + bmax[3 * i + a]);
    }
    entries[i].prim = i;
  }
  std::vector<Node> nodes;
  nodes.reserve(2 * n);
  build_recursive(entries, 0, n, nodes, leaf_size < 1 ? 1 : leaf_size);
  fill_skips(nodes);
  for (size_t i = 0; i < nodes.size(); ++i) {
    for (int a = 0; a < 3; ++a) {
      out_bmin[3 * i + a] = nodes[i].bmin[a];
      out_bmax[3 * i + a] = nodes[i].bmax[a];
    }
    out_prim[i] = nodes[i].prim;
    out_skip[i] = nodes[i].skip;
  }
  return (int32_t)nodes.size();
}

}  // extern "C"
