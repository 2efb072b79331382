// Native runtime core for ceres_tpu: fast problem IO and host-side
// preprocessor graph algorithms.
//
// JAX counterpart of the reference's native runtime layer: the
// orderings in internal/ceres/parameter_block_ordering.cc (greedy maximal
// independent set for Schur elimination) and
// internal/ceres/coordinate_descent_minimizer.cc (independent-set
// decomposition), plus the BAL text loader (examples/bal_problem.cc
// ReadFile). These run on the host CPU in the preprocessing phase; the
// compute path stays in XLA. Exposed through a plain C ABI consumed via
// ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libceres_tpu_core.so
//        ceres_tpu_core.cpp

#include <algorithm>
#include <cstdint>
#include <functional>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <map>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BAL text parsing (examples/bal_problem.cc ReadFile)
// ---------------------------------------------------------------------------

// Pass 1: read header. Returns 0 on success.
int bal_read_header(const char* path, int64_t* num_cameras,
                    int64_t* num_points, int64_t* num_observations) {
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  long long c, p, o;
  int got = std::fscanf(f, "%lld %lld %lld", &c, &p, &o);
  std::fclose(f);
  if (got != 3) return 2;
  *num_cameras = c;
  *num_points = p;
  *num_observations = o;
  return 0;
}

// Pass 2: fill caller-allocated arrays:
//   camera_index (O,), point_index (O,), observations (O*2,),
//   cameras (C*9,), points (P*3,)
int bal_read_body(const char* path, int64_t* camera_index,
                  int64_t* point_index, double* observations, double* cameras,
                  double* points) {
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  long long C, P, O;
  if (std::fscanf(f, "%lld %lld %lld", &C, &P, &O) != 3) {
    std::fclose(f);
    return 2;
  }
  for (long long i = 0; i < O; ++i) {
    long long ci, pi;
    double x, y;
    if (std::fscanf(f, "%lld %lld %lf %lf", &ci, &pi, &x, &y) != 4) {
      std::fclose(f);
      return 3;
    }
    camera_index[i] = ci;
    point_index[i] = pi;
    observations[2 * i] = x;
    observations[2 * i + 1] = y;
  }
  for (long long i = 0; i < 9 * C; ++i) {
    if (std::fscanf(f, "%lf", &cameras[i]) != 1) {
      std::fclose(f);
      return 4;
    }
  }
  for (long long i = 0; i < 3 * P; ++i) {
    if (std::fscanf(f, "%lf", &points[i]) != 1) {
      std::fclose(f);
      return 5;
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy maximal independent set for Schur elimination ordering
// (parameter_block_ordering.cc ComputeStableSchurOrdering semantics:
// visit blocks by increasing tangent size, an e-block claims all its
// residual instances; later blocks sharing a claimed instance are f).
// ---------------------------------------------------------------------------

// Inputs:
//   num_blocks            total parameter blocks (pids 0..num_blocks-1)
//   tangent_size  (num_blocks,) int32; <0 => inactive (constant/removed)
//   num_instances B
//   k                     args per instance
//   block_ids     (B*k,)  int32 pid per (instance, arg)
// Output:
//   e_blocks      (num_blocks,) int32 buffer; returns count of e-blocks.
int64_t schur_ordering(int64_t num_blocks, const int32_t* tangent_size,
                       int64_t num_instances, int64_t k,
                       const int32_t* block_ids, int32_t* e_blocks) {
  // occurrence lists: CSR of pid -> instance ids
  std::vector<int64_t> counts(num_blocks + 1, 0);
  const int64_t nk = num_instances * k;
  for (int64_t i = 0; i < nk; ++i) {
    int32_t pid = block_ids[i];
    if (pid >= 0 && pid < num_blocks) counts[pid + 1]++;
  }
  std::partial_sum(counts.begin(), counts.end(), counts.begin());
  std::vector<int64_t> occ(nk);
  std::vector<int64_t> fill(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < nk; ++i) {
    int32_t pid = block_ids[i];
    if (pid >= 0 && pid < num_blocks) occ[fill[pid]++] = i / k;
  }

  // visit order: by (tangent_size, -degree) like the Python ordering
  std::vector<int32_t> order;
  order.reserve(num_blocks);
  for (int64_t p = 0; p < num_blocks; ++p)
    if (tangent_size[p] >= 0) order.push_back((int32_t)p);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    int64_t da = counts[a + 1] - counts[a];
    int64_t db = counts[b + 1] - counts[b];
    if (tangent_size[a] != tangent_size[b])
      return tangent_size[a] < tangent_size[b];
    if (da != db) return da > db;
    return a < b;
  });

  std::vector<uint8_t> instance_blocked(num_instances, 0);
  int64_t n_e = 0;
  for (int32_t pid : order) {
    bool ok = true;
    for (int64_t j = counts[pid]; j < counts[pid + 1]; ++j) {
      if (instance_blocked[occ[j]]) {
        ok = false;
        break;
      }
    }
    if (!ok) continue;
    for (int64_t j = counts[pid]; j < counts[pid + 1]; ++j)
      instance_blocked[occ[j]] = 1;
    e_blocks[n_e++] = pid;
  }
  return n_e;
}

// ---------------------------------------------------------------------------
// Greedy graph coloring over the block-sharing graph (independent sets
// for coordinate descent, coordinate_descent_minimizer.h:49-86).
// color[pid] = -1 for inactive blocks; returns number of colors.
// ---------------------------------------------------------------------------

int64_t independent_set_coloring(int64_t num_blocks,
                                 const int32_t* tangent_size,
                                 int64_t num_instances, int64_t k,
                                 const int32_t* block_ids, int32_t* color) {
  // adjacency via instance co-occurrence; dedup with sort+unique
  std::vector<std::vector<int32_t>> adj(num_blocks);
  std::vector<int32_t> live;
  live.reserve(k);
  for (int64_t i = 0; i < num_instances; ++i) {
    live.clear();
    for (int64_t j = 0; j < k; ++j) {
      int32_t pid = block_ids[i * k + j];
      if (pid >= 0 && pid < num_blocks && tangent_size[pid] >= 0)
        live.push_back(pid);
    }
    for (size_t a = 0; a < live.size(); ++a)
      for (size_t b = 0; b < live.size(); ++b)
        if (a != b) adj[live[a]].push_back(live[b]);
  }
  for (int64_t p = 0; p < num_blocks; ++p) {
    auto& v = adj[p];
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
  }

  // visit high-degree first
  std::vector<int32_t> order;
  for (int64_t p = 0; p < num_blocks; ++p)
    if (tangent_size[p] >= 0) order.push_back((int32_t)p);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (adj[a].size() != adj[b].size()) return adj[a].size() > adj[b].size();
    return a < b;
  });

  std::fill(color, color + num_blocks, -1);
  int64_t ncolors = 0;
  std::vector<uint8_t> used;
  for (int32_t pid : order) {
    used.assign((size_t)ncolors + 1, 0);
    for (int32_t n : adj[pid]) {
      int32_t c = color[n];
      if (c >= 0 && c < (int32_t)used.size()) used[c] = 1;
    }
    int32_t c = 0;
    while (c < (int32_t)used.size() && used[c]) ++c;
    color[pid] = c;
    if (c + 1 > ncolors) ncolors = c + 1;
  }
  return ncolors;
}

// ---------------------------------------------------------------------------
// Visibility clustering (canonical views / single linkage analog used by
// CLUSTER_JACOBI-style preconditioners, single_linkage_clustering.h:58):
// cluster cameras by shared-point counts with a similarity threshold.
// cameras: instance arg column holding the camera pid per observation;
// points: column holding point pid. Output cluster id per camera pid
// position (dense 0..num_cameras-1 indices expected).
// ---------------------------------------------------------------------------

int64_t single_linkage_cluster(int64_t num_cameras, int64_t num_points,
                               int64_t num_obs, const int32_t* camera_index,
                               const int32_t* point_index, double threshold,
                               int32_t* cluster) {
  // camera-camera similarity via shared points: build point->cameras CSR
  std::vector<int64_t> pc(num_points + 1, 0);
  for (int64_t i = 0; i < num_obs; ++i) pc[point_index[i] + 1]++;
  std::partial_sum(pc.begin(), pc.end(), pc.begin());
  std::vector<int32_t> plist(num_obs);
  std::vector<int64_t> fill(pc.begin(), pc.end() - 1);
  for (int64_t i = 0; i < num_obs; ++i)
    plist[fill[point_index[i]]++] = camera_index[i];

  // per-camera visibility counts
  std::vector<int64_t> vis(num_cameras, 0);
  for (int64_t i = 0; i < num_obs; ++i) vis[camera_index[i]]++;

  // union-find
  std::vector<int32_t> parent(num_cameras);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };

  // pairwise shared counts (sparse accumulation per point)
  std::vector<std::pair<int64_t, int64_t>> edges;  // (packed pair, count)
  // For moderate camera counts a dense matrix is fine.
  std::vector<int64_t> shared((size_t)num_cameras * num_cameras, 0);
  for (int64_t p = 0; p < num_points; ++p) {
    for (int64_t a = pc[p]; a < pc[p + 1]; ++a)
      for (int64_t b = a + 1; b < pc[p + 1]; ++b) {
        int32_t ca = plist[a], cb = plist[b];
        if (ca != cb) shared[(size_t)std::min(ca, cb) * num_cameras +
                             std::max(ca, cb)]++;
      }
  }
  for (int32_t a = 0; a < num_cameras; ++a)
    for (int32_t b = a + 1; b < num_cameras; ++b) {
      int64_t s = shared[(size_t)a * num_cameras + b];
      if (s == 0) continue;
      double sim = (double)s / std::min(vis[a], vis[b]);
      if (sim >= threshold) {
        int32_t ra = find(a), rb = find(b);
        if (ra != rb) parent[ra] = rb;
      }
    }

  // densify cluster ids
  std::vector<int32_t> remap(num_cameras, -1);
  int64_t nclusters = 0;
  for (int32_t c = 0; c < num_cameras; ++c) {
    int32_t r = find(c);
    if (remap[r] < 0) remap[r] = (int32_t)nclusters++;
    cluster[c] = remap[r];
  }
  return nclusters;
}

// ---------------------------------------------------------------------------
// Canonical-views clustering (canonical_views_clustering.{h,cc}): greedily
// pick canonical cameras maximizing
//   sum_i max(0, sim(i,c) - max_sim_to_chosen(i))
//   - size_penalty_weight - similarity_penalty_weight * max_sim(c, chosen)
// then assign every camera to its most-similar canonical view. Similarity
// = shared-point count normalized by min visibility (same metric as
// single_linkage_cluster above). Writes dense cluster ids; returns the
// number of clusters (canonical views picked).
// ---------------------------------------------------------------------------

int64_t canonical_views_cluster(int64_t num_cameras, int64_t num_points,
                                int64_t num_obs, const int32_t* camera_index,
                                const int32_t* point_index, int64_t min_views,
                                double size_penalty_weight,
                                double similarity_penalty_weight,
                                int32_t* cluster) {
  std::vector<int64_t> pc(num_points + 1, 0);
  for (int64_t i = 0; i < num_obs; ++i) pc[point_index[i] + 1]++;
  std::partial_sum(pc.begin(), pc.end(), pc.begin());
  std::vector<int32_t> plist(num_obs);
  std::vector<int64_t> fill(pc.begin(), pc.end() - 1);
  for (int64_t i = 0; i < num_obs; ++i)
    plist[fill[point_index[i]]++] = camera_index[i];
  std::vector<int64_t> vis(num_cameras, 0);
  for (int64_t i = 0; i < num_obs; ++i) vis[camera_index[i]]++;

  // Similarity graph (visibility.cc CreateSchurComplementGraph):
  // w(a,b) = #shared / sqrt(vis_a * vis_b), self edges w(i,i) = 1.
  std::vector<double> sim((size_t)num_cameras * num_cameras, 0.0);
  {
    std::vector<int64_t> shared((size_t)num_cameras * num_cameras, 0);
    for (int64_t p = 0; p < num_points; ++p)
      for (int64_t a = pc[p]; a < pc[p + 1]; ++a)
        for (int64_t b = a + 1; b < pc[p + 1]; ++b) {
          int32_t ca = plist[a], cb = plist[b];
          if (ca != cb)
            shared[(size_t)std::min(ca, cb) * num_cameras +
                   std::max(ca, cb)]++;
        }
    for (int32_t a = 0; a < num_cameras; ++a) {
      sim[(size_t)a * num_cameras + a] = 1.0;
      for (int32_t b = a + 1; b < num_cameras; ++b) {
        int64_t s = shared[(size_t)a * num_cameras + b];
        if (s == 0) continue;
        double denom = std::sqrt((double)vis[a] * (double)vis[b]);
        double v = denom > 0 ? (double)s / denom : 0.0;
        sim[(size_t)a * num_cameras + b] = v;
        sim[(size_t)b * num_cameras + a] = v;
      }
    }
  }

  // Greedy selection (canonical_views_clustering.cc:108-135): pick the
  // argmax quality difference; keep going while gain > 0 OR fewer than
  // min_views centers.
  std::vector<double> best_to_chosen(num_cameras, 0.0);
  std::vector<int32_t> assigned_center(num_cameras, -1);
  std::vector<int32_t> canonical;
  std::vector<char> chosen(num_cameras, 0);
  while ((int64_t)canonical.size() < num_cameras) {
    double best_gain = -1e300;
    int32_t best_view = -1;
    for (int32_t c = 0; c < num_cameras; ++c) {
      if (chosen[c]) continue;
      double gain = 0.0;
      for (int32_t i = 0; i < num_cameras; ++i) {
        double s = sim[(size_t)c * num_cameras + i];
        if (s > best_to_chosen[i]) gain += s - best_to_chosen[i];
      }
      gain -= size_penalty_weight;
      for (int32_t k : canonical)
        gain -= similarity_penalty_weight *
                sim[(size_t)c * num_cameras + k];
      if (gain > best_gain) {
        best_gain = gain;
        best_view = c;
      }
    }
    if (best_view < 0) break;
    if (best_gain <= 0 && (int64_t)canonical.size() >= min_views) break;
    chosen[best_view] = 1;
    canonical.push_back(best_view);
    for (int32_t i = 0; i < num_cameras; ++i) {
      double s = sim[(size_t)best_view * num_cameras + i];
      if (s > best_to_chosen[i]) {
        best_to_chosen[i] = s;
        assigned_center[i] = (int32_t)canonical.size() - 1;
      }
    }
  }
  // Membership (ComputeClusterMembership): assigned during selection;
  // unreachable views become singleton clusters.
  int64_t nclusters = (int64_t)canonical.size();
  for (int32_t i = 0; i < num_cameras; ++i) {
    if (assigned_center[i] >= 0)
      cluster[i] = assigned_center[i];
    else
      cluster[i] = (int32_t)nclusters++;
  }
  return nclusters;
}

// ---------------------------------------------------------------------------
// Maximum-weight linear forest over the cluster visibility graph
// (visibility_based_preconditioner.cc ForestToClusterPairs analog,
// degree-constrained to <= 2 so every tree is a PATH): greedy Kruskal on
// cluster-pair shared-point weights, rejecting edges that would create a
// cycle or raise a degree above 2. The resulting chains make the
// CLUSTER_TRIDIAGONAL preconditioner literally block tridiagonal, which
// maps to a batched block-Thomas solve on the device.
// Inputs: per-observation (cluster id, point id). Output: edges as
// (a, b) pairs into edge_a/edge_b (capacity num_clusters-1); returns the
// number of edges written.
// ---------------------------------------------------------------------------

int64_t max_weight_linear_forest(int64_t num_clusters, int64_t num_points,
                                 int64_t num_obs,
                                 const int32_t* cluster_index,
                                 const int32_t* point_index, int32_t* edge_a,
                                 int32_t* edge_b) {
  std::vector<int64_t> pcount(num_points + 1, 0);
  for (int64_t i = 0; i < num_obs; ++i) pcount[point_index[i] + 1]++;
  std::partial_sum(pcount.begin(), pcount.end(), pcount.begin());
  std::vector<int32_t> plist(num_obs);
  std::vector<int64_t> fill(pcount.begin(), pcount.end() - 1);
  for (int64_t i = 0; i < num_obs; ++i)
    plist[fill[point_index[i]]++] = cluster_index[i];

  // cluster-pair weights (dedup repeated cluster ids per point first)
  std::map<std::pair<int32_t, int32_t>, int64_t> w;
  std::vector<int32_t> seen;
  for (int64_t p = 0; p < num_points; ++p) {
    seen.clear();
    for (int64_t a = pcount[p]; a < pcount[p + 1]; ++a) {
      int32_t c = plist[a];
      if (std::find(seen.begin(), seen.end(), c) == seen.end())
        seen.push_back(c);
    }
    for (size_t a = 0; a < seen.size(); ++a)
      for (size_t b = a + 1; b < seen.size(); ++b)
        w[{std::min(seen[a], seen[b]), std::max(seen[a], seen[b])}]++;
  }
  std::vector<std::pair<int64_t, std::pair<int32_t, int32_t>>> edges;
  edges.reserve(w.size());
  for (auto& kv : w) edges.push_back({kv.second, kv.first});
  std::sort(edges.begin(), edges.end(),
            [](const auto& x, const auto& y) { return x.first > y.first; });

  std::vector<int32_t> parent(num_clusters), degree(num_clusters, 0);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  int64_t nedges = 0;
  for (auto& e : edges) {
    int32_t a = e.second.first, b = e.second.second;
    if (degree[a] >= 2 || degree[b] >= 2) continue;
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) continue;
    parent[ra] = rb;
    degree[a]++;
    degree[b]++;
    edge_a[nedges] = a;
    edge_b[nedges] = b;
    ++nedges;
    if (nedges >= num_clusters - 1) break;
  }
  return nedges;
}

// ---------------------------------------------------------------------------
// Simplicial sparse Cholesky with minimum-degree ordering.
//
// JAX counterpart of the reference's sparse direct stack
// (internal/ceres/sparse_cholesky.h:71-112 factor-once/refactor-many
// interface, suitesparse.h:306 CHOLMOD wrapper, and the AMD fill-reducing
// ordering in reorder_program.cc). This runs on the host: symbolic
// analysis once per sparsity pattern, numeric refactorization per LM
// iteration, invoked from the XLA graph via jax.pure_callback. The
// factorization is an up-looking row LL^T driven by the elimination
// tree; the ordering is greedy minimum degree on the quotient graph.
//
// Matrix format: upper-triangular CSC (column j holds sorted rows
// i <= j, diagonal present), 64-bit column pointers, 32-bit row indices.
// ---------------------------------------------------------------------------

// Greedy minimum-degree ordering. A is the upper-triangular pattern;
// writes perm (perm[k] = original index eliminated k-th). Returns 0.
int mindeg_order(int64_t n, const int64_t* Ap, const int32_t* Ai,
                 int32_t* perm) {
  // Symmetrize into per-node adjacency lists.
  std::vector<std::vector<int32_t>> adj(n);
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int32_t i = Ai[p];
      if (i == j) continue;
      adj[i].push_back((int32_t)j);
      adj[j].push_back(i);
    }
  }
  std::vector<char> eliminated(n, 0);
  std::vector<int32_t> stamp(n, -1);  // dedup scratch
  // Degree buckets for O(1) min extraction with lazy degree updates.
  std::vector<int64_t> degree(n);
  for (int64_t v = 0; v < n; ++v) {
    std::sort(adj[v].begin(), adj[v].end());
    adj[v].erase(std::unique(adj[v].begin(), adj[v].end()), adj[v].end());
    degree[v] = (int64_t)adj[v].size();
  }
  // Simple lazy heap: (degree, node); stale entries skipped on pop.
  typedef std::pair<int64_t, int32_t> DN;
  std::vector<DN> heap;
  heap.reserve(n);
  for (int64_t v = 0; v < n; ++v) heap.push_back({degree[v], (int32_t)v});
  std::make_heap(heap.begin(), heap.end(), std::greater<DN>());
  std::vector<int32_t> nbrs;
  for (int64_t k = 0; k < n; ++k) {
    int32_t v = -1;
    while (!heap.empty()) {
      DN top = heap.front();
      std::pop_heap(heap.begin(), heap.end(), std::greater<DN>());
      heap.pop_back();
      if (!eliminated[top.second] && degree[top.second] == top.first) {
        v = top.second;
        break;
      }
    }
    if (v < 0) {  // all remaining entries stale: pick any live node
      for (int64_t u = 0; u < n; ++u)
        if (!eliminated[u]) { v = (int32_t)u; break; }
    }
    perm[k] = v;
    eliminated[v] = 1;
    // Live neighbors of v form a clique in the elimination graph.
    nbrs.clear();
    for (int32_t u : adj[v])
      if (!eliminated[u]) nbrs.push_back(u);
    for (int32_t u : nbrs) {
      // Merge clique into u's list, drop eliminated nodes, dedup.
      std::vector<int32_t>& au = adj[u];
      int64_t w = 0;
      for (int64_t r = 0; r < (int64_t)au.size(); ++r)
        if (!eliminated[au[r]]) au[w++] = au[r];
      au.resize(w);
      for (int32_t t : au) stamp[t] = u;
      stamp[u] = u;
      for (int32_t t : nbrs)
        if (stamp[t] != u) { au.push_back(t); stamp[t] = u; }
      degree[u] = (int64_t)au.size();
      heap.push_back({degree[u], u});
      std::push_heap(heap.begin(), heap.end(), std::greater<DN>());
    }
    adj[v].clear();
    adj[v].shrink_to_fit();
  }
  return 0;
}

// Internal: build the permuted upper pattern B = P A P' (upper CSC,
// sorted rows). iperm[old] = new.
static void permute_upper(int64_t n, const int64_t* Ap, const int32_t* Ai,
                          const int32_t* perm, std::vector<int64_t>& Bp,
                          std::vector<int32_t>& Bi,
                          std::vector<int64_t>& Bsrc) {
  std::vector<int32_t> iperm(n);
  for (int64_t k = 0; k < n; ++k) iperm[perm[k]] = (int32_t)k;
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int32_t i = Ai[p];
      int32_t nj = iperm[j], ni = iperm[i];
      int32_t cj = std::max(ni, nj);
      count[cj + 1]++;
    }
  }
  Bp.assign(n + 1, 0);
  for (int64_t j = 0; j < n; ++j) Bp[j + 1] = Bp[j] + count[j + 1];
  std::vector<int64_t> next(Bp.begin(), Bp.end() - 1);
  int64_t nnz = Bp[n];
  Bi.resize(nnz);
  Bsrc.resize(nnz);
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int32_t i = Ai[p];
      int32_t nj = iperm[j], ni = iperm[i];
      int32_t cj = std::max(ni, nj), ci = std::min(ni, nj);
      int64_t q = next[cj]++;
      Bi[q] = ci;
      Bsrc[q] = p;
    }
  }
  // Sort rows within each column (tracking source positions).
  std::vector<std::pair<int32_t, int64_t>> tmp;
  for (int64_t j = 0; j < n; ++j) {
    tmp.clear();
    for (int64_t p = Bp[j]; p < Bp[j + 1]; ++p) tmp.push_back({Bi[p], Bsrc[p]});
    std::sort(tmp.begin(), tmp.end());
    for (int64_t t = 0; t < (int64_t)tmp.size(); ++t) {
      Bi[Bp[j] + t] = tmp[t].first;
      Bsrc[Bp[j] + t] = tmp[t].second;
    }
  }
}

// Internal: elimination tree of the permuted upper pattern, plus the
// row-subtree reach used for both column counts and numeric rows.
static void etree_of(int64_t n, const std::vector<int64_t>& Bp,
                     const std::vector<int32_t>& Bi,
                     std::vector<int32_t>& parent) {
  parent.assign(n, -1);
  std::vector<int32_t> ancestor(n, -1);
  for (int64_t k = 0; k < n; ++k) {
    for (int64_t p = Bp[k]; p < Bp[k + 1]; ++p) {
      int32_t i = Bi[p];
      while (i != -1 && i < k) {
        int32_t next_i = ancestor[i];
        ancestor[i] = (int32_t)k;
        if (next_i == -1) parent[i] = (int32_t)k;
        i = next_i;
      }
    }
  }
}

// Internal: nodes of row k's subtree reach in topological (ascending)
// order; returns count, fills reach[0..count).
static int64_t row_reach(int64_t k, const std::vector<int64_t>& Bp,
                         const std::vector<int32_t>& Bi,
                         const std::vector<int32_t>& parent,
                         std::vector<int32_t>& mark,
                         std::vector<int32_t>& stack,
                         std::vector<int32_t>& reach) {
  int64_t top = 0, nreach = 0;
  mark[k] = (int32_t)k;
  for (int64_t p = Bp[k]; p < Bp[k + 1]; ++p) {
    int32_t i = Bi[p];
    if (i >= k) continue;
    int64_t len = 0;
    while (mark[i] != (int32_t)k) {
      stack[len++] = i;
      mark[i] = (int32_t)k;
      i = parent[i];
    }
    // stack holds a root-ward path; emit it reversed so the combined
    // reach list stays topologically ordered per path.
    while (len > 0) reach[nreach++] = stack[--len];
  }
  // Paths from different entries interleave; a final sort gives the
  // ascending elimination order the up-looking update needs.
  std::sort(reach.begin(), reach.begin() + nreach);
  return nreach;
}

}  // extern "C"

// Symbolic factorization state: the permuted pattern + source map +
// elimination tree + L column pointers, computed once per sparsity
// pattern (SuiteSparse cholmod_analyze analog). Numeric refactorization
// (per LM iteration) reuses all of it — the analyze-once/refactor-many
// split of sparse_cholesky.h:71-112.
struct SparseCholSymbolic {
  int64_t n;
  std::vector<int64_t> Bp;
  std::vector<int32_t> Bi;
  std::vector<int64_t> Bsrc;
  std::vector<int32_t> parent;
  std::vector<int64_t> Lp;
};

// Numeric core shared by the handle API and the legacy one-shot entry.
// Templated over the factor scalar type: double is the exact path,
// float backs the mixed-precision RefinedSparseCholesky analog
// (internal/ceres/sparse_cholesky.h:118, dense_cholesky.h:104-246 —
// factor in single precision, wrap with double-precision refinement).
template <typename T>
static int64_t chol_numeric_t(const SparseCholSymbolic& S, const T* Ax,
                              int32_t* Li, T* Lx) {
  const int64_t n = S.n;
  const std::vector<int64_t>& Bp = S.Bp;
  const std::vector<int32_t>& Bi = S.Bi;
  const std::vector<int64_t>& Bsrc = S.Bsrc;
  const std::vector<int32_t>& parent = S.parent;
  const int64_t* Lp = S.Lp.data();
  std::vector<int32_t> mark(n, -1), stack(n), reach(n);
  std::vector<T> x(n, T(0));
  std::vector<int64_t> lnext(n);  // next free slot per column of L
  for (int64_t j = 0; j < n; ++j) lnext[j] = Lp[j] + 1;  // slot 0 = diag
  for (int64_t k = 0; k < n; ++k) {
    // Scatter row k of B (upper column k) into x; diagonal into d.
    T d = T(0);
    int64_t nr = row_reach(k, Bp, Bi, parent, mark, stack, reach);
    for (int64_t p = Bp[k]; p < Bp[k + 1]; ++p) {
      int32_t i = Bi[p];
      T v = Ax[Bsrc[p]];
      if (i == k)
        d = v;
      else
        x[i] = v;
    }
    // Up-looking triangular solve along the reach.
    for (int64_t t = 0; t < nr; ++t) {
      int32_t j = reach[t];
      T lkj = x[j] / Lx[Lp[j]];  // divide by L(j,j)
      x[j] = T(0);
      for (int64_t p = Lp[j] + 1; p < lnext[j]; ++p) x[Li[p]] -= Lx[p] * lkj;
      d -= lkj * lkj;
      int64_t q = lnext[j]++;
      Li[q] = (int32_t)k;
      Lx[q] = lkj;
    }
    if (!(d > T(0))) return k + 1;
    Li[Lp[k]] = (int32_t)k;
    Lx[Lp[k]] = std::sqrt(d);
  }
  return 0;
}

static int64_t chol_numeric(const SparseCholSymbolic& S, const double* Ax,
                            int32_t* Li, double* Lx) {
  return chol_numeric_t<double>(S, Ax, Li, Lx);
}

// Shared triangular-solve core: x = P' (L^-T (L^-1 (P b))).
template <typename T>
static void chol_solve_t(int64_t n, const int64_t* Lp, const int32_t* Li,
                         const T* Lx, const int32_t* perm, int64_t nrhs,
                         const T* B, T* X) {
  std::vector<T> z(n);
  for (int64_t r = 0; r < nrhs; ++r) {
    const T* b = B + r * n;
    T* xo = X + r * n;
    for (int64_t k = 0; k < n; ++k) z[k] = b[perm[k]];
    for (int64_t j = 0; j < n; ++j) {  // L z' = z
      T zj = z[j] / Lx[Lp[j]];
      z[j] = zj;
      for (int64_t p = Lp[j] + 1; p < Lp[j + 1]; ++p) z[Li[p]] -= Lx[p] * zj;
    }
    for (int64_t j = n - 1; j >= 0; --j) {  // L^T y = z'
      T zj = z[j];
      for (int64_t p = Lp[j] + 1; p < Lp[j + 1]; ++p) zj -= Lx[p] * z[Li[p]];
      z[j] = zj / Lx[Lp[j]];
    }
    for (int64_t k = 0; k < n; ++k) xo[perm[k]] = z[k];
  }
}

extern "C" {

// Symbolic analysis returning an opaque handle for refactorization.
// Ordering is caller-provided in perm (use mindeg_order or identity).
// Fills parent (elimination tree) and Lp (L column pointers, lower CSC,
// diagonal first per column). Returns the handle; null on error.
void* sparse_chol_symbolic_new(int64_t n, const int64_t* Ap,
                               const int32_t* Ai, const int32_t* perm,
                               int32_t* parent, int64_t* Lp) {
  SparseCholSymbolic* s = new SparseCholSymbolic;
  s->n = n;
  permute_upper(n, Ap, Ai, perm, s->Bp, s->Bi, s->Bsrc);
  etree_of(n, s->Bp, s->Bi, s->parent);
  std::vector<int64_t> colcount(n, 1);  // diagonal
  std::vector<int32_t> mark(n, -1), stack(n), reach(n);
  for (int64_t k = 0; k < n; ++k) {
    int64_t nr = row_reach(k, s->Bp, s->Bi, s->parent, mark, stack, reach);
    for (int64_t t = 0; t < nr; ++t) colcount[reach[t]]++;
  }
  s->Lp.assign(n + 1, 0);
  for (int64_t j = 0; j < n; ++j) s->Lp[j + 1] = s->Lp[j] + colcount[j];
  for (int64_t j = 0; j < n; ++j) parent[j] = s->parent[j];
  for (int64_t j = 0; j <= n; ++j) Lp[j] = s->Lp[j];
  return s;
}

int64_t sparse_chol_symbolic_nnz(void* handle) {
  return ((SparseCholSymbolic*)handle)->Lp.back();
}

void sparse_chol_symbolic_free(void* handle) {
  delete (SparseCholSymbolic*)handle;
}

// Numeric refactorization on a symbolic handle: NO symbolic work is
// repeated (the per-iteration cost CHOLMOD's factorize gives the
// reference). Values Ax correspond to the ORIGINAL (unpermuted) pattern
// handed to sparse_chol_symbolic_new. Returns 0 on success, k+1 if the
// pivot at permuted column k is not positive (matrix not positive
// definite — LinearSolverTerminationType FAILURE).
int64_t sparse_chol_refactorize(void* handle, const double* Ax, int32_t* Li,
                                double* Lx) {
  return chol_numeric(*(SparseCholSymbolic*)handle, Ax, Li, Lx);
}

// Legacy one-shot entries (kept for ABI compatibility; prefer the
// handle API above, which amortizes the symbolic work).
int64_t sparse_chol_analyze(int64_t n, const int64_t* Ap, const int32_t* Ai,
                            const int32_t* perm, int32_t* parent,
                            int64_t* Lp) {
  void* h = sparse_chol_symbolic_new(n, Ap, Ai, perm, parent, Lp);
  if (!h) return -1;
  int64_t nnz = sparse_chol_symbolic_nnz(h);
  sparse_chol_symbolic_free(h);
  return nnz;
}

int64_t sparse_chol_factorize(int64_t n, const int64_t* Ap, const int32_t* Ai,
                              const double* Ax, const int32_t* perm,
                              const int64_t* Lp, int32_t* Li, double* Lx) {
  (void)Lp;
  SparseCholSymbolic s;
  s.n = n;
  permute_upper(n, Ap, Ai, perm, s.Bp, s.Bi, s.Bsrc);
  etree_of(n, s.Bp, s.Bi, s.parent);
  s.Lp.assign(n + 1, 0);
  {
    std::vector<int64_t> colcount(n, 1);
    std::vector<int32_t> mark(n, -1), stack(n), reach(n);
    for (int64_t k = 0; k < n; ++k) {
      int64_t nr = row_reach(k, s.Bp, s.Bi, s.parent, mark, stack, reach);
      for (int64_t t = 0; t < nr; ++t) colcount[reach[t]]++;
    }
    for (int64_t j = 0; j < n; ++j) s.Lp[j + 1] = s.Lp[j] + colcount[j];
  }
  return chol_numeric(s, Ax, Li, Lx);
}

// Solve A x = b given the factor of P A P': x = P' (L^-T (L^-1 (P b))).
// B/X are (nrhs, n) row-major. Returns 0.
int sparse_chol_solve(int64_t n, const int64_t* Lp, const int32_t* Li,
                      const double* Lx, const int32_t* perm, int64_t nrhs,
                      const double* B, double* X) {
  chol_solve_t<double>(n, Lp, Li, Lx, perm, nrhs, B, X);
  return 0;
}

// Single-precision numeric refactorization on a double-analyzed pattern
// (RefinedSparseCholesky analog, sparse_cholesky.h:118): same symbolic
// handle, float values/factor. The caller wraps this with
// double-precision iterative refinement (iterative_refiner.h).
int64_t sparse_chol_refactorize_f32(void* handle, const float* Ax,
                                    int32_t* Li, float* Lx) {
  return chol_numeric_t<float>(*(SparseCholSymbolic*)handle, Ax, Li, Lx);
}

int sparse_chol_solve_f32(int64_t n, const int64_t* Lp, const int32_t* Li,
                          const float* Lx, const int32_t* perm, int64_t nrhs,
                          const float* B, float* X) {
  chol_solve_t<float>(n, Lp, Li, Lx, perm, nrhs, B, X);
  return 0;
}

}  // extern "C"
