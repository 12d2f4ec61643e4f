// Permuted + scaled matrix assembly: Ahat = (diag(s) A diag(t))[p, q],
// single O(nnz) pass (ref compute_perm, ds/CompressedStorage.hpp:551).
// Rows are emitted with *unsorted* columns: no consumer requires sorted
// rows (the Crout kernel scatters, the finalize E/F extraction and Schur
// sort their own per-row buffers, and transposes are counting passes), so
// the two counting-sort passes this used to do were pure overhead.

#include "common.hpp"

namespace {
template <class VT>
void permute_scale_t(i64 n, const i64 *Ap, const i32 *Ai, const VT *Av,
                     const double *s, const double *t, const i64 *p,
                     const i64 *q_inv, i64 *Bp, i32 *Bi, VT *Bv) {
  // row offsets first (prefix sum of permuted row lengths), then a
  // parallel fill over disjoint output ranges — bit-identical to the
  // serial pass (per-entry arithmetic and order unchanged)
  Bp[0] = 0;
  for (i64 i = 0; i < n; ++i) Bp[i + 1] = Bp[i] + (Ap[p[i] + 1] - Ap[p[i]]);
#pragma omp parallel for schedule(static) if (Bp[n] > 1 << 21)
  for (i64 i = 0; i < n; ++i) {
    const i64 r = p[i];
    const double sr = s[r];
    i64 w = Bp[i];
    for (i64 k = Ap[r]; k < Ap[r + 1]; ++k, ++w) {
      Bi[w] = (i32)q_inv[Ai[k]];
      // scale in f64, store in working precision (the s/t scalings from
      // preprocessing are always f64)
      Bv[w] = (VT)(sr * (double)Av[k] * t[Ai[k]]);
    }
  }
}
}  // namespace

HT_API void ht_permute_scale(i64 n, const i64 *Ap, const i32 *Ai,
                             const double *Av, const double *s,
                             const double *t, const i64 *p, const i64 *q_inv,
                             i64 *Bp, i32 *Bi, double *Bv) {
  permute_scale_t<double>(n, Ap, Ai, Av, s, t, p, q_inv, Bp, Bi, Bv);
}

HT_API void ht_permute_scale_s(i64 n, const i64 *Ap, const i32 *Ai,
                               const float *Av, const double *s,
                               const double *t, const i64 *p,
                               const i64 *q_inv, i64 *Bp, i32 *Bi,
                               float *Bv) {
  permute_scale_t<float>(n, Ap, Ai, Av, s, t, p, q_inv, Bp, Bi, Bv);
}

// counting CSR -> CSC transpose (columns sorted by construction); MC64 and
// the Crout kernel consume unsorted/sorted alike, so no comparison sorts
HT_API void ht_transpose(i64 nrows, i64 ncols, const i64 *Ap, const i32 *Ai,
                         const double *Av, i64 *Bp, i32 *Bi, double *Bv) {
  const i64 nnz = Ap[nrows];
  for (i64 j = 0; j <= ncols; ++j) Bp[j] = 0;
  for (i64 k = 0; k < nnz; ++k) ++Bp[Ai[k] + 1];
  for (i64 j = 0; j < ncols; ++j) Bp[j + 1] += Bp[j];
  std::vector<i64> nx(Bp, Bp + ncols);
  for (i64 i = 0; i < nrows; ++i)
    for (i64 k = Ap[i]; k < Ap[i + 1]; ++k) {
      const i64 pos = nx[Ai[k]]++;
      Bi[pos] = (i32)i;
      Bv[pos] = Av[k];
    }
}

// diagonal of a CSR (first match per row; rows need not be sorted)
HT_API void ht_diag(i64 n, const i64 *Ap, const i32 *Ai, const double *Av,
                    i64 nd, double *out) {
  for (i64 i = 0; i < nd; ++i) {
    out[i] = 0.0;
    for (i64 k = Ap[i]; k < Ap[i + 1]; ++k)
      if (Ai[k] == (i32)i) {
        out[i] = Av[k];
        break;
      }
  }
}
