// O(nnz) analysis passes: pattern-symmetry ratio and the static-deferral
// probe (diagonal lookup + row/col max magnitudes) — the remaining hot
// Python-side preprocessing costs at scale.

#include "common.hpp"

// fraction of entries whose transposed position also exists
HT_API double ht_pattern_symm(i64 n, const i64 *indptr, const i32 *indices) {
  const i64 nnz = indptr[n];
  if (!nnz) return 1.0;
  // build transpose pattern via counting
  std::vector<i64> cptr(n + 1, 0);
  for (i64 k = 0; k < nnz; ++k) ++cptr[indices[k] + 1];
  for (i64 c = 0; c < n; ++c) cptr[c + 1] += cptr[c];
  std::vector<i32> crow(nnz);
  {
    std::vector<i64> nxt(cptr.begin(), cptr.end() - 1);
    for (i64 i = 0; i < n; ++i)
      for (i64 k = indptr[i]; k < indptr[i + 1]; ++k)
        crow[nxt[indices[k]]++] = (i32)i;
  }
  // rows i: sorted indices; transpose row i (= column i) sorted by
  // construction; two-pointer intersection per row
  i64 hits = 0;
  for (i64 i = 0; i < n; ++i) {
    i64 a = indptr[i], b = cptr[i];
    const i64 ae = indptr[i + 1], be = cptr[i + 1];
    while (a < ae && b < be) {
      if (indices[a] < crow[b]) ++a;
      else if (indices[a] > crow[b]) ++b;
      else { ++hits; ++a; ++b; }
    }
  }
  return (double)hits / (double)nnz;
}

// For each leading pair (p[i], q[i]): diag value and max(row,col) magnitude.
HT_API void ht_defer_probe(i64 n, const i64 *indptr, const i32 *indices,
                           const double *vals, i64 m0, const i64 *p,
                           const i64 *q, double *diag, double *mx) {
  std::vector<double> rowmax(n, 0.0), colmax(n, 0.0);
  for (i64 i = 0; i < n; ++i)
    for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
      const double a = std::fabs(vals[k]);
      if (a > rowmax[i]) rowmax[i] = a;
      if (a > colmax[indices[k]]) colmax[indices[k]] = a;
    }
  for (i64 i = 0; i < m0; ++i) {
    const i64 r = p[i];
    const i32 c = (i32)q[i];
    double dv = 0.0;
    // binary search within the sorted row
    i64 lo = indptr[r], hi = indptr[r + 1];
    while (lo < hi) {
      const i64 mid = (lo + hi) / 2;
      if (indices[mid] < c) lo = mid + 1;
      else hi = mid;
    }
    if (lo < indptr[r + 1] && indices[lo] == c) dv = vals[lo];
    diag[i] = dv;
    double m = rowmax[r] > colmax[c] ? rowmax[r] : colmax[c];
    if (m == 0.0) m = 1.0;
    mx[i] = m;
  }
}

// Symmetrized leading-block pattern for fill-reducing orderings:
// P = pattern(B) | pattern(B)^T where B = A[p[:m], q[:m]] in block positions
// (ref compute_leading_block, pre/matching_scaling.hpp:199-321 + the
// reordering wrappers' A+A^T symmetrization).  One O(nnz) pass replaces the
// scipy fancy-index + csr_plus_csr chain.  Pi must have capacity
// >= 2 * sum(row_nnz(A)[p[:m]]); returns the union nnz.  Rows are emitted
// unsorted (AMD sorts its adjacency on build; RCM orders neighbors by
// degree), Bt part first so each row starts with its sorted transpose part.
HT_API i64 ht_sym_leading_pattern(i64 n, const i64 *Ap, const i32 *Ai,
                                  const i64 *p, const i64 *q, i64 m,
                                  i64 *Pp, i32 *Pi) {
  std::vector<i64> qinv(n, -1);
  for (i64 j = 0; j < m; ++j) qinv[q[j]] = j;
  // B rows in block positions
  std::vector<i64> Bp(m + 1, 0);
  i64 nnzb_cap = 0;
  for (i64 i = 0; i < m; ++i) nnzb_cap += Ap[p[i] + 1] - Ap[p[i]];
  std::vector<i32> Bi;
  Bi.reserve(nnzb_cap);
  for (i64 i = 0; i < m; ++i) {
    const i64 r = p[i];
    for (i64 k = Ap[r]; k < Ap[r + 1]; ++k) {
      const i64 c = qinv[Ai[k]];
      if (c >= 0) Bi.push_back((i32)c);
    }
    Bp[i + 1] = (i64)Bi.size();
  }
  // transpose pattern (sorted rows by construction)
  std::vector<i64> Tp(m + 1, 0);
  for (i32 c : Bi) ++Tp[c + 1];
  for (i64 i = 0; i < m; ++i) Tp[i + 1] += Tp[i];
  std::vector<i32> Ti(Bi.size());
  {
    std::vector<i64> nx(Tp.begin(), Tp.end() - 1);
    for (i64 i = 0; i < m; ++i)
      for (i64 k = Bp[i]; k < Bp[i + 1]; ++k) Ti[nx[Bi[k]]++] = (i32)i;
  }
  // per-row union with a stamp workspace
  std::vector<i64> stamp(m, -1);
  i64 w = 0;
  Pp[0] = 0;
  for (i64 i = 0; i < m; ++i) {
    for (i64 k = Tp[i]; k < Tp[i + 1]; ++k) {
      const i32 c = Ti[k];
      if (stamp[c] != i) {
        stamp[c] = i;
        Pi[w++] = c;
      }
    }
    for (i64 k = Bp[i]; k < Bp[i + 1]; ++k) {
      const i32 c = Bi[k];
      if (stamp[c] != i) {
        stamp[c] = i;
        Pi[w++] = c;
      }
    }
    Pp[i + 1] = w;
  }
  return w;
}

// exact value symmetry: returns 1 iff A == A^T entrywise (real f64).  Used
// by the auto-LDL^T dispatch (hifir_tpu/api.py): a provably symmetric input
// runs the mode-1 mirror kernel, halving the Crout scan work — the
// reference only engages its symmetric path when the USER sets is_symm
// (Options.h:152), leaving the speedup on the table for plain A.
HT_API int ht_value_symm(i64 n, const i64 *indptr, const i32 *indices,
                         const double *vals) {
  const i64 nnz = indptr[n];
  if (!nnz) return 1;
  std::vector<i64> cptr(n + 1, 0);
  for (i64 k = 0; k < nnz; ++k) ++cptr[indices[k] + 1];
  for (i64 c = 0; c < n; ++c) cptr[c + 1] += cptr[c];
  std::vector<i32> crow(nnz);
  std::vector<double> cval(nnz);
  {
    std::vector<i64> nxt(cptr.begin(), cptr.end() - 1);
    for (i64 i = 0; i < n; ++i)
      for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
        const i64 pos = nxt[indices[k]]++;
        crow[pos] = (i32)i;
        cval[pos] = vals[k];
      }
  }
  // row i of A vs row i of A^T must be identical (both sorted by column)
  for (i64 i = 0; i < n; ++i) {
    const i64 a = indptr[i], b = cptr[i];
    if (indptr[i + 1] - a != cptr[i + 1] - b) return 0;
    const i64 len = indptr[i + 1] - a;
    for (i64 k = 0; k < len; ++k)
      if (indices[a + k] != crow[b + k] || vals[a + k] != cval[b + k])
        return 0;
  }
  return 1;
}
