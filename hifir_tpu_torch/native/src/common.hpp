// Shared helpers for the hifir_tpu native host kernels.
//
// These kernels are the production counterparts of the Python anchors in
// hifir_tpu/{pre,alg}; design notes live in the corresponding Python modules.
// The reference keeps comparable serial algorithms in optimized C++
// (src/hif/{pre,alg} of the reference HIFIR library); this library is a from-scratch
// implementation around a stable-id factorization design (no linked lists,
// no index rotation).
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

using i64 = std::int64_t;
using i32 = std::int32_t;

#define HT_API extern "C" __attribute__((visibility("default")))
#define HT_RESTRICT __restrict__

namespace ht {

// Stable LSD radix sort of records by a non-negative i32 key (9-bit
// digits).  Comparison sorts on short random-key arrays are branch-
// mispredict-bound (~20 cycles/comparison); the counting passes here are
// branchless.  `key(rec)` extracts the key; `tmp` is caller-provided
// ping-pong scratch.
template <class Rec, class KeyFn>
inline void radix_sort_by_key(Rec *a, i64 n, std::vector<Rec> &tmp,
                              i32 maxkey, KeyFn key) {
  if (n < 2) return;
  if ((i64)tmp.size() < n) tmp.resize(n);
  int bits = 1;
  while ((1 << bits) <= maxkey) ++bits;
  // adaptive digit width: the per-pass counter prefix costs 2^width ops,
  // so short arrays want narrow digits (total = passes * (n + 2^width));
  // large arrays cap at 8 bits -- more open scatter streams than TLB
  // entries turns each bucket write into a page walk
  int width = 4;
  while (width < 8 && (i64)1 << (width + 1) <= n) ++width;
  int passes = (bits + width - 1) / width;
  width = (bits + passes - 1) / passes;  // balance the digit widths
  const i32 mask = (1 << width) - 1;
  Rec *src = a;
  Rec *dst = tmp.data();
  i64 cnt[2048];
  for (int shift = 0; shift < bits; shift += width) {
    std::memset(cnt, 0, sizeof(i64) << width);
    for (i64 k = 0; k < n; ++k) ++cnt[(key(src[k]) >> shift) & mask];
    i64 run = 0;
    for (i32 b = 0; b <= mask; ++b) {
      const i64 c = cnt[b];
      cnt[b] = run;
      run += c;
    }
    for (i64 k = 0; k < n; ++k)
      dst[cnt[(key(src[k]) >> shift) & mask]++] = src[k];
    std::swap(src, dst);
  }
  if (src != a) std::memcpy(a, src, n * sizeof(Rec));
}

// growable CSR assembly buffer
struct CsrBuf {
  std::vector<i64> indptr{0};
  std::vector<i32> indices;
  std::vector<double> vals;
  i64 ncols = 0;

  void push_row_end() { indptr.push_back((i64)indices.size()); }
  i64 nnz() const { return (i64)indices.size(); }
  i64 nrows() const { return (i64)indptr.size() - 1; }
};

// transpose a CSR (nrows x ncols) into CSC arrays (per-column rows).
// Two-thread counting transpose for large inputs: each thread counts its
// row half's columns, an exclusive scan over (half, column) assigns every
// (half, column) run a disjoint output slot range, and the two fill passes
// scatter concurrently with no overlap (row order within a column is
// preserved because half 0's slots precede half 1's for every column).
template <class VT>
inline void transpose_csr(i64 nrows, i64 ncols, const i64 *indptr,
                          const i32 *indices, const VT *vals,
                          std::vector<i64> &cptr, std::vector<i32> &crow,
                          std::vector<VT> &cval) {
  const i64 nnz = indptr[nrows];
  cptr.assign(ncols + 1, 0);
  crow.resize(nnz);
  cval.resize(nnz);
  if (nnz >= (i64)1 << 22) {
    const i64 mid = nrows / 2;
    std::vector<i64> cnt0(ncols, 0), cnt1(ncols, 0);
#pragma omp parallel sections num_threads(2)
    {
#pragma omp section
      for (i64 k = indptr[0]; k < indptr[mid]; ++k) ++cnt0[indices[k]];
#pragma omp section
      for (i64 k = indptr[mid]; k < indptr[nrows]; ++k) ++cnt1[indices[k]];
    }
    // next0[c] = start slot of half 0's run in column c; next1[c] follows it
    std::vector<i64> next0(ncols), next1(ncols);
    i64 acc = 0;
    for (i64 c = 0; c < ncols; ++c) {
      next0[c] = acc;
      next1[c] = acc + cnt0[c];
      acc += cnt0[c] + cnt1[c];
      cptr[c + 1] = acc;
    }
#pragma omp parallel sections num_threads(2)
    {
#pragma omp section
      for (i64 i = 0; i < mid; ++i)
        for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
          const i64 pos = next0[indices[k]]++;
          crow[pos] = (i32)i;
          cval[pos] = vals[k];
        }
#pragma omp section
      for (i64 i = mid; i < nrows; ++i)
        for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
          const i64 pos = next1[indices[k]]++;
          crow[pos] = (i32)i;
          cval[pos] = vals[k];
        }
    }
    return;
  }
  for (i64 k = 0; k < nnz; ++k) ++cptr[indices[k] + 1];
  for (i64 j = 0; j < ncols; ++j) cptr[j + 1] += cptr[j];
  std::vector<i64> next(cptr.begin(), cptr.end() - 1);
  for (i64 i = 0; i < nrows; ++i)
    for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
      const i64 pos = next[indices[k]]++;
      crow[pos] = (i32)i;
      cval[pos] = vals[k];
    }
}

// sort every CSR row by column via two counting transposes: O(nnz), no
// comparison sorts (used for factor/block assembly where rows are built
// unsorted)
template <class VT>
inline void sort_csr_rows(i64 nrows, i64 ncols, const std::vector<i64> &ptr,
                          std::vector<i32> &idx, std::vector<VT> &val) {
  const i64 nnz = ptr[nrows];
  if (!nnz) return;
  // pass 1: scatter to column-major (stable in row order)
  std::vector<i64> cptr(ncols + 1, 0);
  for (i64 k = 0; k < nnz; ++k) ++cptr[idx[k] + 1];
  for (i64 c = 0; c < ncols; ++c) cptr[c + 1] += cptr[c];
  std::vector<i32> cm_row(nnz);
  std::vector<VT> cm_val(nnz);
  {
    std::vector<i64> nx(cptr.begin(), cptr.end() - 1);
    for (i64 i = 0; i < nrows; ++i)
      for (i64 k = ptr[i]; k < ptr[i + 1]; ++k) {
        const i64 pos = nx[idx[k]]++;
        cm_row[pos] = (i32)i;
        cm_val[pos] = val[k];
      }
  }
  // pass 2: traverse columns in order, emit back per row => rows sorted
  {
    std::vector<i64> nx(ptr.begin(), ptr.end() - 1);
    for (i64 c = 0; c < ncols; ++c)
      for (i64 k = cptr[c]; k < cptr[c + 1]; ++k) {
        const i64 pos = nx[cm_row[k]]++;
        idx[pos] = (i32)c;
        val[pos] = cm_val[k];
      }
  }
}

}  // namespace ht
