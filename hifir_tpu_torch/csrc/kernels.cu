// Hand-written Hopper (sm_90a) kernels of the multilevel M-solve and of
// HIFIR refinement.  Plain C interface, bound with ctypes by
// hifir_tpu_torch/kernels/build.py.  Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.
//
// K7  bsr_spmv     replaces hifir_tpu/ops/pallas_spmv.py:bsr_matvec_mrhs
//                  (Pallas _bsr_kernel)
// K1  sell_spmv    replaces hifir_tpu/ops/spmv.py:ell_matvec_mrhs
//                  (sliced-ELL branch, XLA-compiled gathers)
// K2  trsv_scan    replaces hifir_tpu/ops/trsv.py:trsv_apply_mrhs
//                  (TrsvSchedule branch, lax.scan over chunks)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// K7: block-sparse (uniform KB) times dense, Y = A X.
//
// Bound: at bs=128 and 128 right-hand sides each 128x128 block is used
// against a 128-column slab, 2*nrhs FLOP per block element read.  f32 is
// bound by operations (67 TFLOP/s on CUDA cores, no TF32); f64 moves twice
// the bytes for the same operations and sits at the balance point, just on
// the bytes side (3.35 TB/s against 67 TFLOP/s of DMMA).  At one right-hand
// side it reads every block once for 2 FLOP per element and is bound by
// bytes in both dtypes.
//
// Design: the TPU grid (row block i, slot k) ran k in order and carried the
// sum in VMEM scratch.  Here one thread block owns a 128-row x 32-column
// output tile of row block i and walks the KB slots itself, reading
// block_cols[i, k] to find the X slab, so the sum stays in registers
// (4x4 per thread, working dtype) and no grid-level carry is needed.  Tiles
// of the block (128 x 32) and of the slab (32 x 32) are staged in shared
// memory: 42 KB in f64, under the 48 KB static limit, so no opt-in is
// needed.  Padding blocks (zero values, column 0) are multiplied like any
// other.  Ragged bs and nrhs are masked at the tile edge.
constexpr int kBsrTM = 128;
constexpr int kBsrTN = 32;
constexpr int kBsrTK = 32;
constexpr int kBsrThreads = 256;  // 32 row groups x 8 column groups

template <typename T>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                const T* __restrict__ X, T* __restrict__ Y, int kb, int bs,
                int nrhs, int row_tiles) {
  __shared__ T As[kBsrTM][kBsrTK + 1];
  __shared__ T Xs[kBsrTK][kBsrTN];
  const int i = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * kBsrTM;
  const int c0 = blockIdx.y * kBsrTN;
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

  for (int k = 0; k < kb; ++k) {
    const int bc = bcols[(int64_t)i * kb + k];
    const T* blk = blocks + ((int64_t)i * kb + k) * bs * bs;
    const T* xs = X + (int64_t)bc * bs * nrhs;
    for (int j0 = 0; j0 < bs; j0 += kBsrTK) {
      for (int e = threadIdx.x; e < kBsrTM * kBsrTK; e += kBsrThreads) {
        const int rr = e / kBsrTK, cc = e % kBsrTK;
        const int gr = r0 + rr, gc = j0 + cc;
        As[rr][cc] = (gr < bs && gc < bs) ? blk[(int64_t)gr * bs + gc] : T(0);
      }
      for (int e = threadIdx.x; e < kBsrTK * kBsrTN; e += kBsrThreads) {
        const int rr = e / kBsrTN, cc = e % kBsrTN;
        const int gr = j0 + rr, gc = c0 + cc;
        Xs[rr][cc] =
            (gr < bs && gc < nrhs) ? xs[(int64_t)gr * nrhs + gc] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBsrTK; ++kk) {
        T a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = As[ty + 32 * r][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Xs[kk][tx + 8 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = r0 + ty + 32 * r;
    if (gr >= bs) continue;
    T* yrow = Y + ((int64_t)i * bs + gr) * nrhs;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = c0 + tx + 8 * c;
      if (gc < nrhs) yrow[gc] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K1: sliced-ELL times dense, Y = A X, all row-length buckets in one launch.
//
// Bound: bytes.  Each stored entry (index + value) is read once and used for
// nrhs multiply-adds, but every one of them also gathers a row of X, so the
// kernel moves at least indices + values + X + Y and does 2 FLOP per
// (entry, column): far below the card's ~20 FLOP/byte balance point.
//
// Design: the JAX version ran one gather-multiply-reduce per bucket, then
// concatenated the buckets and gathered rows back into original order.  Here
// a per-row table (row_ptr: offset of the row's entries in the concatenated
// bucket arrays, row_len: its bucket's width) lets one launch cover every
// bucket and write each row straight to its original position.  One thread
// per (row, column), columns fastest: a warp reads one row's index/value
// (broadcast) and 32 consecutive columns of X (coalesced).  Pad entries
// (index == ncols) are skipped by a bounds test.  row_ptr == nullptr means a
// uniform ELL (row r at r * k_uniform).
template <typename T>
__global__ void sell_spmv_kernel(const int* __restrict__ idx,
                                 const T* __restrict__ val,
                                 const int64_t* __restrict__ row_ptr,
                                 const int* __restrict__ row_len,
                                 int k_uniform, int64_t nrows, int nrhs,
                                 int ncols, const T* __restrict__ X,
                                 T* __restrict__ Y) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nrows * nrhs) return;
  const int64_t r = t / nrhs;
  const int j = (int)(t % nrhs);
  int64_t start;
  int len;
  if (row_ptr != nullptr) {
    start = row_ptr[r];
    len = row_len[r];
  } else {
    start = r * k_uniform;
    len = k_uniform;
  }
  T acc = T(0);
  for (int k = 0; k < len; ++k) {
    const int c = idx[start + k];
    if (c < ncols) acc += val[start + k] * X[(int64_t)c * nrhs + j];
  }
  Y[r * nrhs + j] = acc;
}

// ---------------------------------------------------------------------------
// K2: one dependency level of the slot-ordered triangular scan, in place:
// x[s, :] -= sum_k vals[s, k] * x[cols[s, k], :] for the level's slots.
//
// Bound: bytes (and, on deep factors, launch latency).  Each slot reads its
// K (col, val) pairs and K gathered rows of x for 2*K*nrhs FLOP.
//
// Design: on the TPU one lax.scan step handled one chunk and the chunk
// latency set the pace.  Slots of one effective level never depend on each
// other (chunks are level-aligned, partial-sum slots of split rows sit in
// earlier sub-levels), so one launch covers all chunks of a level and the
// host loop below launches the levels in order on one stream.  One thread
// per (slot, column), columns fastest.  Pad dependencies (col == nslots) are
// skipped by a bounds test; padding slots have only pad dependencies and
// keep their zero.
template <typename T>
__global__ void trsv_level_kernel(T* __restrict__ x,
                                  const int* __restrict__ cols,
                                  const T* __restrict__ vals, int64_t s0,
                                  int64_t nlev_slots, int K, int nrhs,
                                  int64_t nslots) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nlev_slots * nrhs) return;
  const int64_t s = s0 + t / nrhs;
  const int j = (int)(t % nrhs);
  const int* cs = cols + s * K;
  const T* vs = vals + s * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int c = cs[k];
    if (c < nslots) acc += vs[k] * x[(int64_t)c * nrhs + j];
  }
  x[s * nrhs + j] -= acc;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <typename T>
int bsr_spmv(const T* blocks, const int* bcols, const T* X, T* Y, int nbr,
             int kb, int bs, int nrhs, void* stream) {
  const int row_tiles = (bs + kBsrTM - 1) / kBsrTM;
  dim3 grid((unsigned)(nbr * row_tiles), (unsigned)((nrhs + kBsrTN - 1) / kBsrTN));
  bsr_spmv_kernel<T><<<grid, kBsrThreads, 0, (cudaStream_t)stream>>>(
      blocks, bcols, X, Y, kb, bs, nrhs, row_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int sell_spmv(const int* idx, const T* val, const int64_t* row_ptr,
              const int* row_len, int k_uniform, int64_t nrows, int nrhs,
              int ncols, const T* X, T* Y, void* stream) {
  sell_spmv_kernel<T>
      <<<blocks_for(nrows * nrhs), kThreads, 0, (cudaStream_t)stream>>>(
          idx, val, row_ptr, row_len, k_uniform, nrows, nrhs, ncols, X, Y);
  return (int)cudaGetLastError();
}

// level_slots is a HOST array of nlev + 1 slot offsets.
template <typename T>
int trsv_scan(T* x, const int* cols, const T* vals, const int64_t* level_slots,
              int nlev, int K, int nrhs, int64_t nslots, void* stream) {
  for (int l = 0; l < nlev; ++l) {
    const int64_t s0 = level_slots[l];
    const int64_t len = level_slots[l + 1] - s0;
    trsv_level_kernel<T>
        <<<blocks_for(len * nrhs), kThreads, 0, (cudaStream_t)stream>>>(
            x, cols, vals, s0, len, K, nrhs, nslots);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hifir_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#define HIFIR_DEFINE(SUFFIX, T)                                               \
  int bsr_spmv_##SUFFIX(const T* blocks, const int* bcols, const T* X, T* Y, \
                        int nbr, int kb, int bs, int nrhs, void* stream) {    \
    return bsr_spmv<T>(blocks, bcols, X, Y, nbr, kb, bs, nrhs, stream);      \
  }                                                                           \
  int sell_spmv_##SUFFIX(const int* idx, const T* val,                       \
                         const int64_t* row_ptr, const int* row_len,         \
                         int k_uniform, int64_t nrows, int nrhs, int ncols,  \
                         const T* X, T* Y, void* stream) {                   \
    return sell_spmv<T>(idx, val, row_ptr, row_len, k_uniform, nrows, nrhs,  \
                        ncols, X, Y, stream);                                \
  }                                                                           \
  int trsv_scan_##SUFFIX(T* x, const int* cols, const T* vals,               \
                         const int64_t* level_slots, int nlev, int K,        \
                         int nrhs, int64_t nslots, void* stream) {           \
    return trsv_scan<T>(x, cols, vals, level_slots, nlev, K, nrhs, nslots,   \
                        stream);                                              \
  }

HIFIR_DEFINE(f32, float)
HIFIR_DEFINE(f64, double)

#undef HIFIR_DEFINE

}  // extern "C"
