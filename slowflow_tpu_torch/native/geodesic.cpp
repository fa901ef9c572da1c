// Host-side seed-graph k-NN for the EPIC sparse-to-dense interpolation.
//
// Role (parity): the reference finds, for every match seed, its k
// geodesically-closest seeds over the seed-adjacency graph
// (epic_aux.cpp:44-87). The graph is tiny (≤ a few thousand nodes) and the
// search is inherently sequential per source, so it runs on the host while
// the pixel-level distance transform runs on TPU. This implementation is a
// standard settled-array Dijkstra with early termination, written
// independently of the reference's code.
//
// The per-source state (tentative distances, settled flags) is epoch-stamped
// instead of cleared: one uint32 generation counter per node, bumped per
// source, makes stale entries self-invalidating. This removes the O(n) clear
// per source — with ~8k seeds that clear dominated the whole search
// (O(n^2) writes across sources on the single-core benchmark host).
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp geodesic.cpp -o libgeodesic.so
#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// Minimal binary min-heap over (dist, node) pairs on a reusable buffer.
// Lazy deletion: stale entries are skipped on pop via the settled stamp.
struct HeapEntry {
  float dist;
  int node;
};

class MinHeap {
 public:
  void clear() { data_.clear(); }
  bool empty() const { return data_.empty(); }

  void push(float dist, int node) {
    data_.push_back({dist, node});
    size_t i = data_.size() - 1;
    while (i > 0) {
      size_t parent = (i - 1) / 2;
      if (data_[parent].dist <= data_[i].dist) break;
      std::swap(data_[parent], data_[i]);
      i = parent;
    }
  }

  HeapEntry pop() {
    HeapEntry top = data_[0];
    data_[0] = data_.back();
    data_.pop_back();
    size_t i = 0;
    const size_t n = data_.size();
    while (true) {
      size_t l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < n && data_[l].dist < data_[m].dist) m = l;
      if (r < n && data_[r].dist < data_[m].dist) m = r;
      if (m == i) break;
      std::swap(data_[i], data_[m]);
      i = m;
    }
    return top;
  }

 private:
  std::vector<HeapEntry> data_;
};

}  // namespace

extern "C" {

// For each node of an undirected CSR graph, compute the k closest nodes by
// shortest-path distance (the node itself is included and comes first).
//   n_nodes    number of graph nodes
//   row_start  [n_nodes+1] CSR row offsets
//   col        [nnz] CSR column indices
//   weight     [nnz] non-negative edge weights
//   k          neighbours to report per node
//   out_idx    [n_nodes*k] int32; unfilled slots are -1
//   out_dis    [n_nodes*k] float32; unfilled slots are +inf
void geodesic_knn_all(int n_nodes, const int* row_start, const int* col,
                      const float* weight, int k, int* out_idx,
                      float* out_dis) {
  const float inf = std::numeric_limits<float>::infinity();
#pragma omp parallel
  {
    // per-thread epoch-stamped state, allocated once
    std::vector<float> tentative(n_nodes, inf);
    std::vector<uint32_t> tent_gen(n_nodes, 0);
    std::vector<uint32_t> settled_gen(n_nodes, 0);
    uint32_t gen = 0;
    MinHeap pq;

#pragma omp for schedule(dynamic, 64)
    for (int src = 0; src < n_nodes; ++src) {
      int* idx = out_idx + static_cast<int64_t>(src) * k;
      float* dis = out_dis + static_cast<int64_t>(src) * k;
      std::fill(idx, idx + k, -1);
      std::fill(dis, dis + k, inf);

      ++gen;
      if (gen == 0) {  // wrapped: hard reset once per 2^32 sources
        std::fill(tent_gen.begin(), tent_gen.end(), 0u);
        std::fill(settled_gen.begin(), settled_gen.end(), 0u);
        gen = 1;
      }
      pq.clear();
      tentative[src] = 0.0f;
      tent_gen[src] = gen;
      pq.push(0.0f, src);

      int found = 0;
      while (found < k && !pq.empty()) {
        const HeapEntry top = pq.pop();
        const int u = top.node;
        if (settled_gen[u] == gen) continue;  // stale lazy-deleted entry
        settled_gen[u] = gen;
        idx[found] = u;
        dis[found] = top.dist;
        ++found;
        const int e_end = row_start[u + 1];
        for (int e = row_start[u]; e < e_end; ++e) {
          const int v = col[e];
          if (settled_gen[v] == gen) continue;
          const float cand = top.dist + weight[e];
          if (tent_gen[v] != gen || cand < tentative[v]) {
            tentative[v] = cand;
            tent_gen[v] = gen;
            pq.push(cand, v);
          }
        }
      }
    }
  }
}

}  // extern "C"
