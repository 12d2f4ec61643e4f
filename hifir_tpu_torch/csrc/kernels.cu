// Hand-written Hopper (sm_90a) kernels of the multilevel M-solve and of
// HIFIR refinement.  Plain C interface, bound with ctypes by
// hifir_tpu_torch/kernels/build.py.  Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of a refused attribute or launch) so that
// the Python wrapper can raise.
//
// K7  bsr_spmv     replaces hifir_tpu/ops/pallas_spmv.py:bsr_matvec_mrhs
//                  (Pallas _bsr_kernel)
// K1  sell_spmv    replaces hifir_tpu/ops/spmv.py:ell_matvec_mrhs
//                  (sliced-ELL branch, XLA-compiled gathers)
// K2  trsv_solve   replaces hifir_tpu/ops/trsv.py:trsv_apply_mrhs
//                  (TrsvSchedule branch: entry gather, lax.scan over chunks,
//                  exit gather)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

// Raise a kernel's dynamic shared-memory limit to ``bytes`` (needed above
// 48 KB) the first time a launch needs it; ``granted`` is the kernel's own
// record of what was set.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= kStaticSmem || bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// Asynchronous global -> shared copies (cp.async).  ``ok == false`` copies
// no bytes and fills the destination with zeros (the ragged tile edge).

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TMA bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on mbarrier ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until the phase of mbarrier ``bar`` with the given parity completes;
// a wait that cannot end traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// K7: block-sparse (uniform KB) times dense, Y = A X.
//
// Bound, at the main path's bs=128: each 128x128 block is used against a
// slab of X, 2*nrhs FLOP per block element.  At 128 right-hand sides f64
// moves 8 B per element and sits at the balance point of the DMMA tensor
// cores (67 TFLOP/s) and HBM (3.35 TB/s), just on the bytes side; f32 in
// 3xTF32 (three TF32 products at 495 TFLOP/s) is bound by bytes.  At one or
// two right-hand sides every block element is read once for 2*nrhs FLOP:
// bytes in both dtypes.
//
// Design: the TPU grid (row block i, slot k) ran k in order and carried the
// sum in VMEM scratch; here a thread block walks the KB slots of its row
// block itself, reading block_cols[i, k] to find the X slab, so the sum
// stays in registers and no grid-level carry is needed.  Three paths, chosen
// by the wrapper (ops/bsr_spmv.py:bsr_path) from the dtype and nrhs:
//
// - f64 ("dmma"): mma.sync m16n8k8 .f64 on the DMMA units.  wgmma has no
//   f64 form, so mma.sync is the route to the 67 TFLOP/s; SIMT f64 (34
//   TFLOP/s) alone needs ~47 us for the 1.6 GFLOP of the main path.
// - f32 ("tf32x3"): mma.sync m16n8k8 .tf32 in split TF32: each operand is
//   split as a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a - a_hi)
//   (cvt.rna), and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is summed in f32
//   (error ~2^-21 per product against TF32's 2^-11).  It is the card's
//   counterpart of the TPU kernel's Precision.HIGHEST, which runs the MXU in
//   several bf16 passes to reach f32 accuracy.
// - one or two right-hand sides ("stream"): bound by the bytes of the
//   blocks; see bsr_stream_kernel.
//
// The two tensor-core paths share bsr_mma_kernel: one thread block of four
// warps owns a 64-row x 64-column output tile of row block i (each warp
// 32x32: two m16 by four n8 fragments).  The (64 x BK) block tile and the
// (BK x 64) X-slab tile are staged in shared memory by cp.async in a
// three-stage ring, so the next two K-tiles load while the current one
// multiplies; BK is 128 bytes of a row (16 f64, 32 f32).  Rows are padded
// so that fragment loads hit distinct banks.  Ragged bs and nrhs are
// zero-filled at the tile edge and masked at the store; VEC > 1 (16-byte
// copies) needs bs, nrhs and the base pointers 16-byte aligned, which the
// wrapper checks, and VEC == 1 copies element by element.

// Tensor-core policies: element type, mma depth, staged tile depth, row
// padding, fragments and the mma itself.  g = lane / 4, t = lane % 4.  Both
// use m16n8k8: A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4); B(t, g),
// B(t+4, g); C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1).

struct MmaF64 {
  using T = double;
  static constexpr int kK = 8;
  static constexpr int kBK = 16;
  static constexpr int kPadA = 4, kPadX = 4;  // rows of 20 and 68 doubles
  struct FragA {
    double a[4];
  };
  struct FragB {
    double b[2];
  };
  __device__ static void load_a(FragA& f, const double* As, int lda, int m0,
                                int k0, int g, int t) {
    f.a[0] = As[(m0 + g) * lda + k0 + t];
    f.a[1] = As[(m0 + g + 8) * lda + k0 + t];
    f.a[2] = As[(m0 + g) * lda + k0 + t + 4];
    f.a[3] = As[(m0 + g + 8) * lda + k0 + t + 4];
  }
  __device__ static void load_b(FragB& f, const double* Xs, int ldx, int n0,
                                int k0, int g, int t) {
    f.b[0] = Xs[(k0 + t) * ldx + n0 + g];
    f.b[1] = Xs[(k0 + t + 4) * ldx + n0 + g];
  }
  __device__ static void mma(double (&c)[4], const FragA& a,
                             const FragB& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a.a[0]), "d"(a.a[1]), "d"(a.a[2]), "d"(a.a[3]), "d"(b.b[0]),
          "d"(b.b[1]));
  }
};

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct MmaTf32x3 {
  using T = float;
  static constexpr int kK = 8;
  static constexpr int kBK = 32;
  static constexpr int kPadA = 4, kPadX = 8;  // rows of 36 and 72 floats
  struct FragA {
    unsigned hi[4], lo[4];
  };
  struct FragB {
    unsigned hi[2], lo[2];
  };
  __device__ static void load_a(FragA& f, const float* As, int lda, int m0,
                                int k0, int g, int t) {
    split_tf32(As[(m0 + g) * lda + k0 + t], f.hi[0], f.lo[0]);
    split_tf32(As[(m0 + g + 8) * lda + k0 + t], f.hi[1], f.lo[1]);
    split_tf32(As[(m0 + g) * lda + k0 + t + 4], f.hi[2], f.lo[2]);
    split_tf32(As[(m0 + g + 8) * lda + k0 + t + 4], f.hi[3], f.lo[3]);
  }
  __device__ static void load_b(FragB& f, const float* Xs, int ldx, int n0,
                                int k0, int g, int t) {
    split_tf32(Xs[(k0 + t) * ldx + n0 + g], f.hi[0], f.lo[0]);
    split_tf32(Xs[(k0 + t + 4) * ldx + n0 + g], f.hi[1], f.lo[1]);
  }
  // small products first, so that they are not lost against the large one
  __device__ static void mma(float (&c)[4], const FragA& a, const FragB& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileThreads = 128;  // 2 x 2 warps of 32 x 32
constexpr int kStages = 3;

template <typename M>
struct TileShape {
  static constexpr int kBK = M::kBK;
  static constexpr int kLdA = kBK + M::kPadA;
  static constexpr int kLdX = kTileN + M::kPadX;
  static constexpr int kStageElems = kTileM * kLdA + kBK * kLdX;
  static constexpr int kSmemBytes =
      kStages * kStageElems * (int)sizeof(typename M::T);
};

// At most 128 registers a thread, so that four blocks run on an SM (4 x 56
// KB of shared memory): the main path's 512 tiles then fit one wave on 132
// SMs.
template <typename M, int VEC, typename T = typename M::T>
__global__ void __launch_bounds__(kTileThreads, 4)
bsr_mma_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
               const T* __restrict__ X, T* __restrict__ Y, int kb, int bs,
               int nrhs, int row_tiles, int col_tiles) {
  using S = TileShape<M>;
  constexpr int BK = S::kBK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // column tiles of one row tile are neighbours in launch order, so they
  // run together and share the block tiles in L2
  const int c0 = (blockIdx.x % col_tiles) * kTileN;
  const int rt = blockIdx.x / col_tiles;
  const int i = rt / row_tiles;
  const int r0 = (rt % row_tiles) * kTileM;
  const int ktiles = (bs + BK - 1) / BK;
  const int nsteps = kb * ktiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  auto load = [&](int step, int stage) {
    const int k = step / ktiles;
    const int j0 = (step % ktiles) * BK;
    const int bc = bcols[(int64_t)i * kb + k];
    const T* blk = blocks + ((int64_t)i * kb + k) * bs * bs;
    const T* xs = X + (int64_t)bc * bs * nrhs;
    T* As = smem + stage * S::kStageElems;
    T* Xs = As + kTileM * S::kLdA;
    for (int e = threadIdx.x; e < kTileM * BK / VEC; e += kTileThreads) {
      const int rr = e / (BK / VEC), cc = (e % (BK / VEC)) * VEC;
      const int gr = r0 + rr, gc = j0 + cc;
      const bool ok = gr < bs && gc < bs;
      cp_async<VEC * sizeof(T)>(As + rr * S::kLdA + cc,
                                ok ? blk + (int64_t)gr * bs + gc : blk, ok);
    }
    for (int e = threadIdx.x; e < BK * kTileN / VEC; e += kTileThreads) {
      const int rr = e / (kTileN / VEC), cc = (e % (kTileN / VEC)) * VEC;
      const int gr = j0 + rr, gc = c0 + cc;
      const bool ok = gr < bs && gc < nrhs;
      cp_async<VEC * sizeof(T)>(Xs + rr * S::kLdX + cc,
                                ok ? xs + (int64_t)gr * nrhs + gc : xs, ok);
    }
  };

  T acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = T(0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tile landed; last step's slot is free
    const int nxt = step + kStages - 1;
    if (nxt < nsteps) load(nxt, nxt % kStages);
    cp_async_commit();
    const T* As = smem + (step % kStages) * S::kStageElems;
    const T* Xs = As + kTileM * S::kLdA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += M::kK) {
      typename M::FragA fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        M::load_a(fa[mt], As, S::kLdA, wm + 16 * mt, kk, g, t);
      // one B fragment live at a time keeps the f64 tile within 128
      // registers
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        typename M::FragB fb;
        M::load_b(fb, Xs, S::kLdX, wn + 8 * nt, kk, g, t);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) M::mma(acc[mt][nt], fa[mt], fb);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + wm + 16 * mt + g + 8 * h;
      if (gr >= bs) continue;
      T* yrow = Y + ((int64_t)i * bs + gr) * nrhs;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gc = c0 + wn + 8 * nt + 2 * t;
        if (gc < nrhs) yrow[gc] = acc[mt][nt][2 * h];
        if (gc + 1 < nrhs) yrow[gc + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// K7 streaming path, NR == nrhs <= 2: bound by the bytes of the blocks
// (2*nrhs FLOP per 4 or 8 B read).  One warp a row of A: it reads the row's
// KB block rows with 16-byte loads (VEC elements a lane, neighbouring lanes
// on neighbouring addresses) and the matching VEC * NR elements of X (one
// X slab per slot, read through L1, where the block's eight warps, eight
// rows of one row block, share it).  A warp issues kStreamBatch (slot,
// line) loads of A and X before it multiplies them, and no barrier or
// shared-memory staging stands before the first load.  Each lane keeps NR
// partial sums; warp shuffles reduce them and lane j stores column j.  On
// the H100 a batch of 2 read the main path's blocks at 92-96% of the rate
// of a plain read kernel over them; batches of 4 and 8 were slower (their
// registers cost more resident warps than the loads they add in flight).
constexpr int kStreamThreads = 256;
constexpr int kStreamBatch = 2;

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<double, 2> {
  __device__ static void load(double* a, const double* p) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    a[0] = v.x;
    a[1] = v.y;
  }
};
template <>
struct Vec<float, 4> {
  __device__ static void load(float* a, const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
};
template <typename T>
struct Vec<T, 1> {
  __device__ static void load(T* a, const T* p) { a[0] = __ldg(p); }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NR, int VEC>
__global__ void __launch_bounds__(kStreamThreads)
bsr_stream_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                  const T* __restrict__ X, T* __restrict__ Y, int64_t nrows,
                  int kb, int bs) {
  const int64_t row =
      (int64_t)blockIdx.x * (kStreamThreads / 32) + threadIdx.x / 32;
  if (row >= nrows) return;
  const int lane = threadIdx.x % 32;
  const int64_t i = row / bs;
  const int r = (int)(row % bs);
  const int lines = (bs + 32 * VEC - 1) / (32 * VEC);  // a block row's
  const int total = kb * lines;

  T acc[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) acc[j] = T(0);
  for (int e0 = 0; e0 < total; e0 += kStreamBatch) {
    T a[kStreamBatch][VEC], x[kStreamBatch][VEC * NR];
#pragma unroll
    for (int u = 0; u < kStreamBatch; ++u) {
      const int e = e0 + u, k = e / lines;
      const int c = (e % lines) * 32 * VEC + lane * VEC;
      if (e < total && c < bs) {
        const int bc = __ldg(bcols + i * kb + k);
        Vec<T, VEC>::load(a[u], blocks + ((i * kb + k) * bs + r) * bs + c);
        // X[bc * bs + c + v][j] for v < VEC, j < NR: VEC * NR elements in a
        // row, loaded VEC at a time
        const T* xs = X + ((int64_t)bc * bs + c) * NR;
#pragma unroll
        for (int q = 0; q < NR; ++q)
          Vec<T, VEC>::load(x[u] + q * VEC, xs + q * VEC);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) a[u][v] = T(0);
#pragma unroll
        for (int v = 0; v < VEC * NR; ++v) x[u][v] = T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kStreamBatch; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[j] += a[u][v] * x[u][v * NR + j];
  }
  T mine = T(0);
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const T s = warp_sum(acc[j]);
    if (lane == j) mine = s;
  }
  if (lane < NR) Y[row * NR + lane] = mine;
}

// Yardstick, called by no solve: reads ``nbytes`` (a multiple of 16, the
// pointer 16-byte aligned) with 16-byte loads, four in flight a thread over
// a grid that fills the card, and stores the xor of what it read only when
// it equals ``sentinel``, so that no load is dropped.  chip_smoke.py times
// it over K7's blocks: the read rate that the streaming path can reach at
// that size and under that timer.
__global__ void __launch_bounds__(256)
read_rate_kernel(const uint4* __restrict__ p, int64_t n, unsigned* out,
                 unsigned sentinel) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  for (; e + 3 * stride < n; e += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(p + e + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; e < n; e += stride) {
    const uint4 v = __ldg(p + e);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == sentinel) *out = acc;
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
// K2: one triangular solve (I + strict T) X = B on a level schedule, B to X
// in one launch:
//   x[s] = B[in_rows[s]] (0 where in_rows[s] == n; slot nslots stays 0),
//   level by level x[s] -= sum_k vals[s, k] * x[cols[s, k]],
//   X[r] = x[out_slots[r]].
//
// Bound: bytes, B and X once and the strict factor's entries once (2 FLOP
// per entry and column); what holds it back is the chain of levels, each of
// which waits for the one before.  A launch per level costs ~3.6 us
// against ~0.05 us of bytes, so the levels are walked inside one launch,
// and the entry and exit gathers are fused into it.
//
// The columns of B are independent, so thread block j owns column j and
// walks every level with __syncthreads() between levels; no barrier between
// blocks.  Its slot vector x ([nslots + 1]) lives in shared memory where it
// fits (SMEM, chosen by ops/trsv.py:trsv_shape) and in a global scratch
// (L2-resident) otherwise.  On the H100, one column a block beat two and
// four, and beat a cooperative grid split over (slot, column) items at one
// right-hand side on every schedule of the frozen fixture (PERF.md).
//
// Slots of one level never depend on each other (chunks are level-aligned
// and the partial-sum slots of split rows sit in earlier sub-levels), so a
// level needs no order inside it.  The pad dependency (col == nslots) reads
// the zero sentinel slot, so no bounds test is needed.  A level is a chain
// of a load of its (col, val) rows, gathers of x, a reduction and a barrier,
// plus the bookkeeping every warp issues for it, idle or not; the kernel
// keeps both short:
// - the dependencies of one slot are split over a team of tps lanes
//   (tps * 4 >= K), four consecutive ones a lane, loaded as one 16-byte
//   line of cols and of vals where K is a multiple of 4 (a level's
//   scattered 4-byte loads, not its bytes, fill the SM's load pipe), and
//   reduced by full-warp shuffles (a partial mask per team is serialised);
// - each team's slot stride is fixed at the start (no division inside a
//   level), and slot indices are 32-bit (nslots + 1 < 2^31, checked by
//   the host);
// - with RING, the (col, val) rows of the next kRingDepth levels are
//   copied by the TMA (cp.async.bulk, one thread, an mbarrier per ring
//   slot) into a ring in shared memory, up to ``cap`` slots a level, while
//   the current level runs (they do not depend on x); slots past ``cap``
//   load from global memory.  The ring takes the shared memory x leaves
//   free, or, with x in global memory, at most kRingGlobalBytes, so that
//   L1 (which shares the SM's 256 KB with shared memory) keeps room for x:
//   on the H100 a ring of all 227 KB was 12% slower than none at 128
//   right-hand sides, and one of 128 KB the fastest of 0 to 227 KB at 1, 8
//   and 128 (level with none at 128).
constexpr int kTrsvThreads = 1024;
constexpr int kDepsPerLane = 4;  // dependencies a lane gathers per pass
constexpr int kGatherBatch = 8;  // entry / exit loads in flight a thread
constexpr int kRingDepth = 2;    // levels copied ahead into shared memory
constexpr int kRingSlots = kRingDepth + 1;
constexpr int kRingBarBytes = 32;  // the slots' mbarriers, 16-byte rounded
constexpr int kRingGlobalBytes = 128 * 1024;

// Four consecutive elements from a 16-byte aligned address (shared or
// global).
template <typename T>
struct Line;
template <>
struct Line<int> {
  __device__ static void load(int* a, const int* p) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  }
};
template <>
struct Line<float> {
  __device__ static void load(float* a, const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  }
};
template <>
struct Line<double> {
  __device__ static void load(double* a, const double* p) {
    const double2 q0 = reinterpret_cast<const double2*>(p)[0];
    const double2 q1 = reinterpret_cast<const double2*>(p)[1];
    a[0] = q0.x;
    a[1] = q0.y;
    a[2] = q1.x;
    a[3] = q1.y;
  }
};

template <typename T, bool SMEM, bool RING>
__global__ void __launch_bounds__(kTrsvThreads)
trsv_solve_kernel(const T* __restrict__ B, T* __restrict__ X,
                  const int* __restrict__ in_rows,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const int* __restrict__ out_slots,
                  const int64_t* __restrict__ level_slots, int nlev, int K,
                  int n, int nrhs, int nslots, int tps, int cap, int xbytes,
                  T* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j = blockIdx.x;  // this block's column
  T* x = SMEM ? reinterpret_cast<T*>(smem_raw)
              : scratch + (int64_t)blockIdx.x * (nslots + 1);
  // a team of tps lanes (a power of two up to 32, within one warp) shares
  // one slot
  const int st = threadIdx.x / tps, lt = threadIdx.x % tps;
  const int tstride = kTrsvThreads / tps;
  // the whole warp walks a level's slots together, as long as its first
  // team has one, so that the team reduction can name the full warp: a
  // shuffle with a different partial mask per team is serialised
  const int st_warp = (threadIdx.x & ~31) / tps;
  // ring of the next levels' (col, val) rows in shared memory, after x,
  // filled by the TMA: one thread asks for a level's two contiguous row
  // ranges, and the slot's mbarrier counts their bytes in
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(smem_raw + xbytes);
  int* ring_c = reinterpret_cast<int*>(smem_raw + xbytes + kRingBarBytes);
  T* ring_v = reinterpret_cast<T*>(ring_c + kRingSlots * cap * K);
  auto ring_copy = [&](int l) {  // thread 0 only
    if (l >= nlev) return;
    const int a = (int)level_slots[l];
    const int m = min(cap, (int)level_slots[l + 1] - a);
    const int q = l % kRingSlots;
    const unsigned cb = m * K * (unsigned)sizeof(int);
    const unsigned vb = m * K * (unsigned)sizeof(T);
    const unsigned bar = smem_u32(&ring_bar[q]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(cb + vb)
        : "memory");
    if (m > 0) {
      bulk_copy(ring_c + q * cap * K, cols + (int64_t)a * K, cb, bar);
      bulk_copy(ring_v + q * cap * K, vals + (int64_t)a * K, vb, bar);
    }
  };
  // level l's rows are the (l / kRingSlots)-th fill of its slot
  auto ring_wait = [&](int l) {
    mbar_wait(smem_u32(&ring_bar[l % kRingSlots]), (l / kRingSlots) & 1);
  };
  if constexpr (RING) {
    if (threadIdx.x == 0) {
      for (int q = 0; q < kRingSlots; ++q)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_u32(&ring_bar[q]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int l = 0; l < kRingDepth; ++l) ring_copy(l);
  }

  // entry gather, kGatherBatch independent loads at a time
  for (int sb = threadIdx.x; sb <= nslots; sb += kTrsvThreads * kGatherBatch) {
    int r[kGatherBatch];
    T v[kGatherBatch];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int s = sb + u * kTrsvThreads;
      r[u] = s < nslots ? in_rows[s] : n;
    }
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u)
      v[u] = r[u] < n ? B[(int64_t)r[u] * nrhs + j] : T(0);
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int s = sb + u * kTrsvThreads;
      if (s <= nslots) x[s] = v[u];
    }
  }
  __syncthreads();

  int s0 = (int)level_slots[0];
  int s1 = nlev > 0 ? (int)level_slots[1] : s0;
  for (int l = 0; l < nlev; ++l) {
    const int s2 = l + 2 <= nlev ? (int)level_slots[l + 2] : s1;
    if constexpr (RING) {
      if (threadIdx.x == 0) ring_copy(l + kRingDepth);
      ring_wait(l);
    }
    const int m = RING ? min(cap, s1 - s0) : 0;
    const int* rc = ring_c + (l % kRingSlots) * cap * K;
    const T* rv = ring_v + (l % kRingSlots) * cap * K;
    // with K a multiple of 4, lane lt takes dependencies [4 lt, 4 lt + 4)
    // of every 4 tps, one 16-byte line of cols and of vals; else lt, lt +
    // tps, lt + 2 tps, lt + 3 tps, so that a team's loads are contiguous
    auto gather = [&](const int* cs, const T* vs) {
      T acc = T(0);
      int c[kDepsPerLane];
      T v[kDepsPerLane];
      if (K % kDepsPerLane == 0) {
        for (int k0 = lt * kDepsPerLane; k0 < K; k0 += kDepsPerLane * tps) {
          Line<int>::load(c, cs + k0);
          Line<T>::load(v, vs + k0);
#pragma unroll
          for (int u = 0; u < kDepsPerLane; ++u) acc += v[u] * x[c[u]];
        }
        return acc;
      }
      for (int k0 = lt; k0 < K; k0 += kDepsPerLane * tps) {
#pragma unroll
        for (int u = 0; u < kDepsPerLane; ++u) {
          const int k = k0 + u * tps;
          c[u] = k < K ? cs[k] : nslots;  // the zero sentinel slot
          v[u] = k < K ? vs[k] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kDepsPerLane; ++u) acc += v[u] * x[c[u]];
      }
      return acc;
    };
    for (int q = 0; s0 + st_warp + q * tstride < s1; ++q) {
      const int s = s0 + st + q * tstride;
      const bool live = s < s1;
      const int i = s - s0;
      T acc = T(0);
      if (live && i < m) {
        acc = gather(rc + i * K, rv + i * K);
      } else if (live) {
        acc = gather(cols + (int64_t)s * K, vals + (int64_t)s * K);
      }
      for (int o = tps / 2; o > 0; o /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && lt == 0) x[s] -= acc;
    }
    __syncthreads();
    s0 = s1;
    s1 = s2;
  }

  // exit gather, kGatherBatch independent loads at a time
  for (int rb = threadIdx.x; rb < n; rb += kTrsvThreads * kGatherBatch) {
    int o[kGatherBatch];
    T v[kGatherBatch];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int r = rb + u * kTrsvThreads;
      o[u] = r < n ? out_slots[r] : nslots;
    }
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) v[u] = x[o[u]];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const int r = rb + u * kTrsvThreads;
      if (r < n) X[(int64_t)r * nrhs + j] = v[u];
    }
  }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <typename M, int VEC, typename T = typename M::T>
int bsr_mma(const T* blocks, const int* bcols, const T* X, T* Y, int nbr,
            int kb, int bs, int nrhs, cudaStream_t stream) {
  using S = TileShape<M>;
  static int granted = 0;
  const cudaError_t err =
      allow_smem(bsr_mma_kernel<M, VEC>, S::kSmemBytes, granted);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (bs + kTileM - 1) / kTileM;
  const int col_tiles = (nrhs + kTileN - 1) / kTileN;
  bsr_mma_kernel<M, VEC>
      <<<(unsigned)((int64_t)nbr * row_tiles * col_tiles), kTileThreads,
         S::kSmemBytes, stream>>>(blocks, bcols, X, Y, kb, bs, nrhs,
                                  row_tiles, col_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int NR, int VEC>
int bsr_stream(const T* blocks, const int* bcols, const T* X, T* Y, int nbr,
               int kb, int bs, cudaStream_t stream) {
  const int64_t nrows = (int64_t)nbr * bs;
  constexpr int kRows = kStreamThreads / 32;
  bsr_stream_kernel<T, NR, VEC>
      <<<(unsigned)((nrows + kRows - 1) / kRows), kStreamThreads, 0,
         stream>>>(blocks, bcols, X, Y, nrows, kb, bs);
  return (int)cudaGetLastError();
}

// path 0: tensor cores (M: MmaF64 or MmaTf32x3); path 1: streaming, nrhs <=
// 2.  vec != 0: bs, the blocks and X pointers (and on path 0 nrhs) are
// 16-byte aligned.
template <typename M, typename T = typename M::T>
int bsr_spmv(const T* blocks, const int* bcols, const T* X, T* Y, int nbr,
             int kb, int bs, int nrhs, int path, int vec, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 0)
    return vec ? bsr_mma<M, V>(blocks, bcols, X, Y, nbr, kb, bs, nrhs, s)
               : bsr_mma<M, 1>(blocks, bcols, X, Y, nbr, kb, bs, nrhs, s);
  if (nrhs > 2) return (int)cudaErrorInvalidValue;
  if (nrhs == 1)
    return vec ? bsr_stream<T, 1, V>(blocks, bcols, X, Y, nbr, kb, bs, s)
               : bsr_stream<T, 1, 1>(blocks, bcols, X, Y, nbr, kb, bs, s);
  return vec ? bsr_stream<T, 2, V>(blocks, bcols, X, Y, nbr, kb, bs, s)
             : bsr_stream<T, 2, 1>(blocks, bcols, X, Y, nbr, kb, bs, s);
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

template <typename T, bool SMEM, bool RING>
int trsv_launch(const T* B, T* X, const int* in_rows, const int* cols,
                const T* vals, const int* out_slots,
                const int64_t* level_slots, int nlev, int K, int n, int nrhs,
                int ns, int tps, int cap, int xbytes, T* scratch,
                cudaStream_t s) {
  const int smem =
      xbytes + (RING ? kRingBarBytes + cap * kRingSlots * K *
                                           (int)(sizeof(int) + sizeof(T))
                     : 0);
  static int granted = 0;
  const cudaError_t err =
      allow_smem(trsv_solve_kernel<T, SMEM, RING>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  trsv_solve_kernel<T, SMEM, RING><<<(unsigned)nrhs, kTrsvThreads, smem, s>>>(
      B, X, in_rows, cols, vals, out_slots, level_slots, nlev, K, n, nrhs, ns,
      tps, cap, xbytes, scratch);
  return (int)cudaGetLastError();
}

// One block a column.  x in shared memory when scratch is null, else in
// scratch (nrhs * (nslots + 1) elements).  The ring holds up to the widest
// level (max_level slots; 0: no ring) in the shared memory x leaves, or in
// kRingGlobalBytes with x in scratch.  level_slots is a DEVICE array of
// nlev + 1 slot offsets.
template <typename T>
int trsv_solve(const T* B, T* X, const int* in_rows, const int* cols,
               const T* vals, const int* out_slots,
               const int64_t* level_slots, int nlev, int K, int n, int nrhs,
               int64_t nslots, int max_level, T* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int tps = 1;
  while (tps < 32 && tps * kDepsPerLane < K) tps *= 2;
  if (nslots + 1 >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const int ns = (int)nslots;
  const bool smem = scratch == nullptr;
  const int64_t x64 = smem ? ((int64_t)ns + 1) * sizeof(T) : 0;
  if (x64 > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int xbytes = (int)((x64 + 15) / 16 * 16);
  const int room = (smem ? kMaxSmem - xbytes : kRingGlobalBytes) -
                   kRingBarBytes;
  const int per_slot = kRingSlots * K * (int)(sizeof(int) + sizeof(T));
  // no ring when the schedule's levels are not whole lines or x leaves no
  // room for one
  const int cap =
      max(0, min(room / per_slot / 8 * 8, (max_level + 7) / 8 * 8));
#define TRSV_LAUNCH(SMEM, RING)                                               \
  return trsv_launch<T, SMEM, RING>(B, X, in_rows, cols, vals, out_slots,     \
                                    level_slots, nlev, K, n, nrhs, ns, tps,   \
                                    cap, xbytes, scratch, s)
  if (smem) {
    if (cap > 0) TRSV_LAUNCH(true, true);
    TRSV_LAUNCH(true, false);
  }
  if (cap > 0) TRSV_LAUNCH(false, true);
  TRSV_LAUNCH(false, false);
#undef TRSV_LAUNCH
}

}  // namespace

extern "C" {

const char* hifir_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The yardstick: read ``nbytes`` at ``p`` once (see read_rate_kernel).
int read_rate(const void* p, int64_t nbytes, unsigned* out,
              unsigned sentinel, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  read_rate_kernel<<<(unsigned)(sms * 8), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(p), nbytes / 16, out, sentinel);
  return (int)cudaGetLastError();
}

#define HIFIR_DEFINE(SUFFIX, T, M)                                            \
  int bsr_spmv_##SUFFIX(const T* blocks, const int* bcols, const T* X, T* Y, \
                        int nbr, int kb, int bs, int nrhs, int path, int vec, \
                        void* stream) {                                       \
    return bsr_spmv<M>(blocks, bcols, X, Y, nbr, kb, bs, nrhs, path, vec,    \
                       stream);                                               \
  }                                                                           \
  int sell_spmv_##SUFFIX(const int* idx, const T* val,                       \
                         const int64_t* row_ptr, const int* row_len,         \
                         int k_uniform, int64_t nrows, int nrhs, int ncols,  \
                         const T* X, T* Y, void* stream) {                   \
    return sell_spmv<T>(idx, val, row_ptr, row_len, k_uniform, nrows, nrhs,  \
                        ncols, X, Y, stream);                                \
  }                                                                           \
  int trsv_solve_##SUFFIX(const T* B, T* X, const int* in_rows,              \
                          const int* cols, const T* vals,                    \
                          const int* out_slots, const int64_t* level_slots,  \
                          int nlev, int K, int n, int nrhs, int64_t nslots,  \
                          int max_level, T* scratch, void* stream) {         \
    return trsv_solve<T>(B, X, in_rows, cols, vals, out_slots, level_slots,  \
                         nlev, K, n, nrhs, nslots, max_level, scratch,       \
                         stream);                                             \
  }

HIFIR_DEFINE(f32, float, MmaTf32x3)
HIFIR_DEFINE(f64, double, MmaF64)

#undef HIFIR_DEFINE

}  // extern "C"
