// Host sequential sparse triangular solves (unit-diagonal strict factors).
//
// CPU fallback counterpart of the reference solve_as_strict_lower/upper
// (ds/CompressedStorage.hpp:1358,1451); the TPU path uses the level-scheduled
// jitted kernels in hifir_tpu/ops/trsv.py instead.  Instantiated for f64 and
// f32 (the reference's HIF<double>/HIF<float> value types).

#include "common.hpp"

namespace {

template <class VT>
void trsv_lower_t(i64 n, const i64 *indptr, const i32 *indices,
                  const VT *vals, VT *x) {
  for (i64 i = 0; i < n; ++i) {
    VT acc = x[i];
    for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
      const i32 j = indices[k];
      if (j < i) acc -= vals[k] * x[j];
    }
    x[i] = acc;
  }
}

template <class VT>
void trsv_upper_t(i64 n, const i64 *indptr, const i32 *indices,
                  const VT *vals, VT *x) {
  for (i64 i = n - 1; i >= 0; --i) {
    VT acc = x[i];
    for (i64 k = indptr[i + 1] - 1; k >= indptr[i]; --k) {
      const i32 j = indices[k];
      if (j > i) acc -= vals[k] * x[j];
    }
    x[i] = acc;
  }
}

// Multi-RHS variants over a row-major n-by-k block (counterpart of the
// reference's dedicated mrhs trsv kernels, CompressedStorage.hpp:1382-1518;
// the reference fixes Nrhs at compile time, here k is a runtime argument and
// the inner axpy vectorizes over the contiguous RHS axis).
template <class VT>
void trsv_lower_mrhs_t(i64 n, const i64 *indptr, const i32 *indices,
                       const VT *vals, VT *x, i64 k) {
  for (i64 i = 0; i < n; ++i) {
    VT *HT_RESTRICT xi = x + i * k;
    for (i64 e = indptr[i]; e < indptr[i + 1]; ++e) {
      const i32 j = indices[e];
      if (j < i) {
        const VT v = vals[e];
        const VT *HT_RESTRICT xj = x + (i64)j * k;
        for (i64 c = 0; c < k; ++c) xi[c] -= v * xj[c];
      }
    }
  }
}

template <class VT>
void trsv_upper_mrhs_t(i64 n, const i64 *indptr, const i32 *indices,
                       const VT *vals, VT *x, i64 k) {
  for (i64 i = n - 1; i >= 0; --i) {
    VT *HT_RESTRICT xi = x + i * k;
    for (i64 e = indptr[i + 1] - 1; e >= indptr[i]; --e) {
      const i32 j = indices[e];
      if (j > i) {
        const VT v = vals[e];
        const VT *HT_RESTRICT xj = x + (i64)j * k;
        for (i64 c = 0; c < k; ++c) xi[c] -= v * xj[c];
      }
    }
  }
}

}  // namespace

HT_API void ht_trsv_lower(i64 n, const i64 *indptr, const i32 *indices,
                          const double *vals, double *x) {
  trsv_lower_t<double>(n, indptr, indices, vals, x);
}

HT_API void ht_trsv_upper(i64 n, const i64 *indptr, const i32 *indices,
                          const double *vals, double *x) {
  trsv_upper_t<double>(n, indptr, indices, vals, x);
}

HT_API void ht_trsv_lower_mrhs(i64 n, const i64 *indptr, const i32 *indices,
                               const double *vals, double *x, i64 k) {
  trsv_lower_mrhs_t<double>(n, indptr, indices, vals, x, k);
}

HT_API void ht_trsv_upper_mrhs(i64 n, const i64 *indptr, const i32 *indices,
                               const double *vals, double *x, i64 k) {
  trsv_upper_mrhs_t<double>(n, indptr, indices, vals, x, k);
}

HT_API void ht_trsv_lower_s(i64 n, const i64 *indptr, const i32 *indices,
                            const float *vals, float *x) {
  trsv_lower_t<float>(n, indptr, indices, vals, x);
}

HT_API void ht_trsv_upper_s(i64 n, const i64 *indptr, const i32 *indices,
                            const float *vals, float *x) {
  trsv_upper_t<float>(n, indptr, indices, vals, x);
}

HT_API void ht_trsv_lower_mrhs_s(i64 n, const i64 *indptr,
                                 const i32 *indices, const float *vals,
                                 float *x, i64 k) {
  trsv_lower_mrhs_t<float>(n, indptr, indices, vals, x, k);
}

HT_API void ht_trsv_upper_mrhs_s(i64 n, const i64 *indptr,
                                 const i32 *indices, const float *vals,
                                 float *x, i64 k) {
  trsv_upper_mrhs_t<float>(n, indptr, indices, vals, x, k);
}
