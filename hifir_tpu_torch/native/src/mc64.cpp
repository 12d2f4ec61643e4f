// MC64 job-5 equivalent: maximum-product bipartite matching with scalings.
//
// From-scratch implementation of the Duff-Koster algorithm (the reference
// vendors an HSL MC64 translation at pre/equilibrate.hpp; see
// hifir_tpu/pre/matching.py for the annotated Python anchor with identical
// semantics).  Min-cost perfect matching on c_ij = log(colmax_j/|a_ij|) via
// successive shortest augmenting paths (Dijkstra, binary heap) with dual
// potentials; the duals give the row/column scalings.

#include "common.hpp"

namespace {

struct HeapEntry {
  double d;
  i32 row;
};
struct HeapCmp {
  bool operator()(const HeapEntry &a, const HeapEntry &b) const {
    return a.d > b.d;  // min-heap
  }
};

}  // namespace

// Input: CSC of A (column j -> rows/vals), square n.
// Output: p[j] = matched row of column j; s (row scalings), t (col scalings).
// Returns 0 ok, 1 structurally singular, 2 scaling overflow risk, <0 error.
HT_API int ht_mc64(i64 n, const i64 *indptr, const i32 *indices,
                   const double *vals, i64 *p, double *s, double *t) {
  const double INF = HUGE_VAL;
  std::vector<double> cost(indptr[n]);
  std::vector<double> cmax(n, 0.0);
  for (i64 j = 0; j < n; ++j)
    for (i64 k = indptr[j]; k < indptr[j + 1]; ++k)
      cmax[j] = std::max(cmax[j], std::fabs(vals[k]));
  for (i64 j = 0; j < n; ++j) {
    for (i64 k = indptr[j]; k < indptr[j + 1]; ++k) {
      const double a = std::fabs(vals[k]);
      cost[k] = (a > 0.0 && cmax[j] > 0.0) ? std::log(cmax[j]) - std::log(a)
                                           : INF;
    }
  }

  std::vector<double> u(n, 0.0), v(n, 0.0);
  std::vector<i64> match_col(n, -1), match_row(n, -1);

  // greedy init on zero-cost (column-max) entries
  for (i64 j = 0; j < n; ++j)
    for (i64 k = indptr[j]; k < indptr[j + 1]; ++k)
      if (cost[k] == 0.0 && match_row[indices[k]] < 0) {
        match_col[j] = indices[k];
        match_row[indices[k]] = j;
        break;
      }

  int info = 0;
  std::vector<double> dist(n);
  std::vector<i64> pred(n);
  std::vector<char> in_tree(n);
  std::vector<HeapEntry> heap;
  std::vector<i64> scanned_rows, scanned_cols;

  for (i64 j0 = 0; j0 < n; ++j0) {
    if (match_col[j0] >= 0) continue;
    std::fill(dist.begin(), dist.end(), INF);
    std::fill(in_tree.begin(), in_tree.end(), 0);
    heap.clear();
    scanned_rows.clear();
    scanned_cols.clear();
    scanned_cols.push_back(j0);
    double minval = 0.0;
    i64 cur_col = j0, sink = -1;
    while (true) {
      const double ucur = u[cur_col];
      for (i64 k = indptr[cur_col]; k < indptr[cur_col + 1]; ++k) {
        const i32 i = indices[k];
        if (in_tree[i] || cost[k] == INF) continue;
        const double nd = minval + cost[k] - ucur - v[i];
        if (nd < dist[i]) {
          dist[i] = nd;
          pred[i] = cur_col;
          heap.push_back({nd, i});
          std::push_heap(heap.begin(), heap.end(), HeapCmp());
        }
      }
      i32 inext = -1;
      double dnext = INF;
      while (!heap.empty()) {
        std::pop_heap(heap.begin(), heap.end(), HeapCmp());
        HeapEntry e = heap.back();
        heap.pop_back();
        if (!in_tree[e.row] && e.d <= dist[e.row]) {
          inext = e.row;
          dnext = e.d;
          break;
        }
      }
      if (inext < 0) break;  // no augmenting path
      minval = dnext;
      in_tree[inext] = 1;
      scanned_rows.push_back(inext);
      if (match_row[inext] < 0) {
        sink = inext;
        break;
      }
      cur_col = match_row[inext];
      scanned_cols.push_back(cur_col);
    }
    if (sink < 0) {
      info = 1;
      continue;
    }
    u[j0] += minval;
    for (i64 j : scanned_cols)
      if (j != j0) u[j] += minval - dist[match_col[j]];
    for (i64 i : scanned_rows) v[i] += dist[i] - minval;
    // augment
    i64 i = sink;
    while (true) {
      const i64 j = pred[i];
      const i64 nxt = match_col[j];
      match_col[j] = i;
      match_row[i] = j;
      if (j == j0) break;
      i = nxt;
    }
  }

  if (info) {
    // complete arbitrarily for structurally singular systems
    std::vector<i64> free_rows;
    for (i64 i = 0; i < n; ++i)
      if (match_row[i] < 0) free_rows.push_back(i);
    i64 k = 0;
    for (i64 j = 0; j < n; ++j)
      if (match_col[j] < 0) {
        match_col[j] = free_rows[k];
        match_row[free_rows[k]] = j;
        ++k;
      }
  }

  for (i64 j = 0; j < n; ++j) p[j] = match_col[j];
  for (i64 i = 0; i < n; ++i) {
    double si = std::exp(v[i]);
    if (!std::isfinite(si)) si = 1.0;
    s[i] = si;
    if (si > 1e300) info = info > 1 ? info : 2;
  }
  for (i64 j = 0; j < n; ++j) {
    double tj = cmax[j] > 0.0 ? std::exp(u[j]) / cmax[j] : 1.0;
    if (!std::isfinite(tj)) tj = 1.0;
    t[j] = tj;
    if (tj > 1e300) info = info > 1 ? info : 2;
  }
  return info;
}
