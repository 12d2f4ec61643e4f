// Dependency-level computation for level-scheduled triangular solves
// (host, O(nnz)); feeds hifir_tpu/ops/trsv.py scheduling.

#include "common.hpp"

HT_API void ht_trsv_levels(i64 n, const i64 *indptr, const i32 *indices,
                           int lower, i64 *lev) {
  if (lower) {
    for (i64 i = 0; i < n; ++i) {
      i64 mx = -1;
      for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
        const i32 j = indices[k];
        if (j < i && lev[j] > mx) mx = lev[j];
      }
      lev[i] = mx + 1;
    }
  } else {
    for (i64 i = n - 1; i >= 0; --i) {
      i64 mx = -1;
      for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
        const i32 j = indices[k];
        if (j > i && lev[j] > mx) mx = lev[j];
      }
      lev[i] = mx + 1;
    }
  }
}
