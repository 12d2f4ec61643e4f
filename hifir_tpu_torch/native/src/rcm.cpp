// Reverse Cuthill-McKee ordering (George-Liu BFS with pseudo-peripheral
// root).  Counterpart of the reference pre/rcm.hpp; operates on a symmetric
// adjacency pattern (caller symmetrizes).

#include "common.hpp"

#include <queue>

namespace {

// BFS level structure from root; returns (last level start, order filled)
i64 bfs_levels(i64 n, const i64 *indptr, const i32 *indices, i64 root,
               const std::vector<char> &in_comp, std::vector<i64> &order,
               std::vector<i64> &level_ptr, std::vector<char> &visited) {
  order.clear();
  level_ptr.clear();
  std::fill(visited.begin(), visited.end(), 0);
  order.push_back(root);
  visited[root] = 1;
  level_ptr.push_back(0);
  i64 lvl_start = 0;
  while (lvl_start < (i64)order.size()) {
    const i64 lvl_end = (i64)order.size();
    level_ptr.push_back(lvl_end);
    for (i64 cur = lvl_start; cur < lvl_end; ++cur) {
      const i64 x = order[cur];
      for (i64 k = indptr[x]; k < indptr[x + 1]; ++k) {
        const i32 y = indices[k];
        if (!visited[y] && in_comp[y]) {
          visited[y] = 1;
          order.push_back(y);
        }
      }
    }
    lvl_start = lvl_end;
  }
  if (level_ptr.size() >= 2 &&
      level_ptr.back() == level_ptr[level_ptr.size() - 2])
    level_ptr.pop_back();
  return (i64)level_ptr.size() - 1;  // number of levels
}

}  // namespace

HT_API int ht_rcm(i64 n, const i64 *indptr, const i32 *indices, i64 *perm) {
  std::vector<i64> deg(n);
  for (i64 i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];

  std::vector<char> assigned(n, 0), visited(n, 0), in_comp(n, 1);
  std::vector<i64> order, level_ptr, result;
  result.reserve(n);

  for (i64 start = 0; start < n; ++start) {
    if (assigned[start]) continue;
    // find pseudo-peripheral root in this component
    i64 root = start;
    i64 nl = bfs_levels(n, indptr, indices, root, in_comp, order, level_ptr,
                        visited);
    // remember component nodes
    std::vector<i64> comp(order);
    for (int iter = 0; iter < 8; ++iter) {
      // pick min-degree node in last level
      i64 best = -1, best_deg = n + 1;
      for (i64 k = level_ptr[nl - 1]; k < (i64)order.size(); ++k)
        if (deg[order[k]] < best_deg) {
          best_deg = deg[order[k]];
          best = order[k];
        }
      if (best < 0) break;
      const i64 nl2 = bfs_levels(n, indptr, indices, best, in_comp, order,
                                 level_ptr, visited);
      if (nl2 > nl) {
        nl = nl2;
        root = best;
      } else
        break;
    }
    // Cuthill-McKee from root: BFS, neighbors by increasing degree
    std::fill(visited.begin(), visited.end(), 0);
    std::vector<i64> q{root};
    visited[root] = 1;
    i64 head = 0;
    std::vector<i64> nbr;
    while (head < (i64)q.size()) {
      const i64 x = q[head++];
      result.push_back(x);
      assigned[x] = 1;
      nbr.clear();
      for (i64 k = indptr[x]; k < indptr[x + 1]; ++k)
        if (!visited[indices[k]]) {
          visited[indices[k]] = 1;
          nbr.push_back(indices[k]);
        }
      std::sort(nbr.begin(), nbr.end(),
                [&](i64 a, i64 b) { return deg[a] < deg[b]; });
      for (i64 y : nbr) q.push_back(y);
    }
  }
  // reverse
  for (i64 i = 0; i < n; ++i) perm[i] = result[n - 1 - i];
  return 0;
}
