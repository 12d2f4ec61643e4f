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
//                  (XLA-compiled gathers) and its callers' C - A X (and the
//                  products' C + A X)
// K2  trsv_solve   replaces hifir_tpu/ops/trsv.py:trsv_apply_mrhs
//                  (TrsvSchedule branch: entry gather, lax.scan over chunks,
//                  exit gather)
//
// K10a chunk_fma  replaces the chunk step of the distributed level-scheduled
//                  triangular solves, hifir_tpu/parallel/trsv_halo.py:
//                  halo_op_kernel, prec_sharded.py:ag_op_kernel and
//                  trsv_sharded.py:_kernel (x[own] -= sum vals * x[cols])
//      chunk_sweep K10a redesigned: the same solves' whole chunk loop
//                  (lax.scan over the chunks, the exchange legs inside) in
//                  one cluster launch, for the ranks of one device
//      chunk_peer  the same loop over several groups of ranks (several
//                  cards, or several groups of one): a cluster a group, one
//                  launch a card, the legs stored through peer pointers and
//                  the steps ordered by flags across the groups
// K10b schur_partial replaces hifir_tpu/parallel/schur.py:_partial_kernel
//                  (one ring step of the Schur SpGEMM: candidates, sort by
//                  column, runs of equal columns summed)
// K8  qrcp         replaces hifir_tpu/small_scale/qrcp_device.py:qrcp_device
//                  (the dense tail's pivoted QR, a lax.fori_loop in one
//                  jax.jit): the whole loop in one cooperative launch
//
// K1 and K2 come in f32, f64, c64 and c128; K7 in f32 and f64 only, as the
// TPU kernel it replaces (Mosaic has no complex type); K10a and K10b in f32
// and f64, as the distribution they serve (real only in the JAX package),
// and K8 in f32 and f64, as the JAX sweep (its column norms are real only).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>

// ---------------------------------------------------------------------------
// Complex values, stored as torch stores them: the real and the imaginary
// part interleaved, the pair aligned to its size (8 bytes for c64, 16 for
// c128), so that a kernel reads a torch tensor's memory as it is.  The
// kernels' arithmetic goes through madd, ldg, shfl and shfl_xor, which are
// the plain operations for a real type: the real instances compile as
// before.  The type lives outside the anonymous namespace: an entry point
// whose parameters had a type of internal linkage would not be exported.

namespace hifir {

template <typename R>
struct alignas(2 * sizeof(R)) Cplx {
  R re, im;
  Cplx() = default;
  __host__ __device__ constexpr Cplx(R r, R i = R(0)) : re(r), im(i) {}
};

}  // namespace hifir

namespace {

using hifir::Cplx;
using C64 = Cplx<float>;
using C128 = Cplx<double>;

// the real type of a value type: the sign of K1 and the parts of a complex
template <typename T>
struct RealOf {
  using type = T;
};
template <typename R>
struct RealOf<Cplx<R>> {
  using type = R;
};
template <typename T>
using Real = typename RealOf<T>::type;

template <typename R>
__device__ __forceinline__ Cplx<R> operator+(Cplx<R> a, Cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ Cplx<R>& operator+=(Cplx<R>& a, Cplx<R> b) {
  a.re += b.re;
  a.im += b.im;
  return a;
}
template <typename R>
__device__ __forceinline__ Cplx<R>& operator-=(Cplx<R>& a, Cplx<R> b) {
  a.re -= b.re;
  a.im -= b.im;
  return a;
}
template <typename R>
__device__ __forceinline__ Cplx<R> operator*(R s, Cplx<R> a) {
  return {s * a.re, s * a.im};
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// acc += a * x: one FMA for a real type, four for a complex one
template <typename T>
__device__ __forceinline__ void madd(T& acc, T a, T x) {
  acc += a * x;
}
template <typename R>
__device__ __forceinline__ void madd(Cplx<R>& acc, Cplx<R> a, Cplx<R> x) {
  acc.re = fma_rn(a.re, x.re, acc.re);
  acc.re = fma_rn(-a.im, x.im, acc.re);
  acc.im = fma_rn(a.re, x.im, acc.im);
  acc.im = fma_rn(a.im, x.re, acc.im);
}

// a load through the read-only cache (a complex one as one 8- or 16-byte
// load)
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  return __ldg(p);
}
__device__ __forceinline__ C64 ldg(const C64* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}
__device__ __forceinline__ C128 ldg(const C128* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return {v.x, v.y};
}

// full-warp shuffles; a complex value moves as its two parts
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename R>
__device__ __forceinline__ Cplx<R> shfl(Cplx<R> v, int src) {
  return {__shfl_sync(0xffffffffu, v.re, src),
          __shfl_sync(0xffffffffu, v.im, src)};
}
template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ Cplx<R> shfl_xor(Cplx<R> v, int o) {
  return {__shfl_xor_sync(0xffffffffu, v.re, o),
          __shfl_xor_sync(0xffffffffu, v.im, o)};
}

constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

constexpr int kMaxDevices = 16;  // cards a process keeps records for

// What a kernel's dynamic shared-memory limit was raised to, a card at a
// time: a function attribute belongs to the current device's context.
struct Granted {
  int bytes[kMaxDevices] = {};
};

// Raise a kernel's dynamic shared-memory limit on the current device to
// ``bytes`` (needed above 48 KB) the first time a launch there needs it;
// ``granted`` is the kernel's own record of what was set.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, Granted& granted) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= granted.bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted.bytes[dev] = bytes;
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
// K1: sliced-ELL times dense with a fused epilogue, out = C + sign A X with
// sign -1 or +1 (out = A X without C), every row-length bucket in one launch.
//
// Replaces hifir_tpu/ops/spmv.py:167 (ell_matvec_mrhs, XLA-compiled
// gathers) together with the subtraction each of its callers makes after
// it: hifir_tpu/alg/prec.py:579,593 (b - E x1, b - F x_tail) and :649,664
// (their adjoints with F^H and E^H), hifir_tpu/ops/trsv.py:176 (the blocked
// inverse's seg - Off_b x) and hifir_tpu/solvers/gmres.py:199 (the
// refinement residual b - A x); with sign +1, the sums of the products M x
// and M^H x, hifir_tpu/alg/prec.py:727-734,764-771 (z + U z, E w + y).
//
// Bound: bytes.  Each entry (index and value) is read once and used for
// nrhs multiply-adds against a gathered row of X, 2 FLOP per 4 or 8 bytes
// of X (8 real FLOP per 8 or 16 bytes in c64 and c128): far below the
// card's balance point.  The least traffic is the
// entries, the distinct rows of X they read, and the rows of C read and of
// out written; in place, only the rows that have entries.
//
// Design.  The JAX version gathered, multiplied and reduced bucket by
// bucket, concatenated the buckets, gathered the rows back into order, and
// its caller subtracted in a second pass.  Here the packer's tables walk
// the concatenation by position p: order[p] is the row there, pos_ptr[p]
// its first flat entry and pos_nnz[p] its true entry count (pads trail, so
// the walk stops at the last real entry).  Rows without entries take the
// first positions, so an in-place launch (out == C) starts at position
// ``first`` == their count and neither reads nor writes them; an
// out-of-place launch starts at 0 and writes them as C (or 0).  Indexing is
// 32-bit (the wrapper checks the sizes) and nothing in the loops divides.
// Two shapes, chosen by the host from nrhs:
//
// - wide (nrhs not in {1, 2, 4, 8}): one warp a row and chunk of 32 VEC
//   columns (grid y), so that f64 at 128 right-hand sides runs two warps a
//   row whose gathers are in flight together.  Lanes run across columns
//   VEC at a time with 16-byte loads and stores (float4, double2, two
//   complex64 values or one complex128; an f32 X row of 128 columns is one
//   warp-wide load, and c128 at 128 right-hand sides runs four warps a
//   row).  The row's (index, value)
//   pairs are read once a warp, one lane an entry, and broadcast by
//   shuffle; a lane loads the X rows of up to 32 entries (BATCH) before its
//   first multiply-add, so that the gathers of a row are in flight
//   together; C's row is loaded before them, and out's row is written once.
// - narrow (nrhs in {1, 2, 4, 8}): a group of G lanes a row (G a power of
//   two that covers the operator's longest row, at most 32), 32 / G rows a
//   warp.  Lane l of a group takes entries l, l + G, ... of its row, so that
//   the warp's index and value loads are contiguous; it gathers its nrhs
//   columns of X, and a shuffle reduction inside the group sums them.
//
// Complex operands take the same shapes with VEC = 16 / sizeof(T) (2 for
// c64, 1 for c128); a multiply-add is four FMAs and the sign stays a real
// +-1, so that C + sign A X is exact in the sign either way.
//
// C and out may be one array (in place); X never overlaps out (the wrapper
// checks), so X alone is read through the read-only cache.  order ==
// nullptr means a uniform ELL: row p at p * k_uniform, k_uniform slots,
// pads (index == ncols) skipped by a bounds test.
constexpr int kK1Threads = 256;

// VEC consecutive elements, 16-byte aligned when VEC > 1: ldg through the
// read-only cache (X), ld and st plain (C and out, which may alias).
template <typename T, int VEC>
struct K1Vec;
template <>
struct K1Vec<float, 4> {
  __device__ __forceinline__ static void ldg(float* a, const float* p) {
    set(a, __ldg(reinterpret_cast<const float4*>(p)));
  }
  __device__ __forceinline__ static void ld(float* a, const float* p) {
    set(a, *reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void st(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
  __device__ __forceinline__ static void set(float* a, float4 v) {
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
};
template <>
struct K1Vec<double, 2> {
  __device__ __forceinline__ static void ldg(double* a, const double* p) {
    set(a, __ldg(reinterpret_cast<const double2*>(p)));
  }
  __device__ __forceinline__ static void ld(double* a, const double* p) {
    set(a, *reinterpret_cast<const double2*>(p));
  }
  __device__ __forceinline__ static void st(double* p, const double* a) {
    *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
  }
  __device__ __forceinline__ static void set(double* a, double2 v) {
    a[0] = v.x;
    a[1] = v.y;
  }
};
// two complex64 values in one 16-byte line; a complex128 value is a line
// of its own (the VEC == 1 form below, whose loads are 16 bytes wide)
template <>
struct K1Vec<C64, 2> {
  __device__ __forceinline__ static void ldg(C64* a, const C64* p) {
    set(a, __ldg(reinterpret_cast<const float4*>(p)));
  }
  __device__ __forceinline__ static void ld(C64* a, const C64* p) {
    set(a, *reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void st(C64* p, const C64* a) {
    *reinterpret_cast<float4*>(p) =
        make_float4(a[0].re, a[0].im, a[1].re, a[1].im);
  }
  __device__ __forceinline__ static void set(C64* a, float4 v) {
    a[0] = C64(v.x, v.y);
    a[1] = C64(v.z, v.w);
  }
};
template <typename T>
struct K1Vec<T, 1> {
  __device__ __forceinline__ static void ldg(T* a, const T* p) {
    a[0] = ::ldg(p);
  }
  __device__ __forceinline__ static void ld(T* a, const T* p) { a[0] = *p; }
  __device__ __forceinline__ static void st(T* p, const T* a) { *p = a[0]; }
};

// The row table of position p.
__device__ __forceinline__ void k1_row(const int* __restrict__ order,
                                       const int* __restrict__ pos_ptr,
                                       const int* __restrict__ pos_nnz,
                                       int k_uniform, int p, int& row,
                                       int& ptr, int& nnz) {
  if (order != nullptr) {
    row = __ldg(order + p);
    ptr = __ldg(pos_ptr + p);
    nnz = __ldg(pos_nnz + p);
  } else {
    row = p;
    ptr = p * k_uniform;
    nnz = k_uniform;
  }
}

// BATCH: the X rows a lane loads before it multiplies, the longest row of
// the operator rounded up to 4, 8, 16 or 32 (the host's choice), so that
// the gathers of a row of up to 32 entries go out at once while an
// operator of short rows keeps its registers few and its resident warps
// many.
template <typename T, int VEC, int BATCH>
__global__ void __launch_bounds__(kK1Threads)
sell_wide_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                 const int* __restrict__ order,
                 const int* __restrict__ pos_ptr,
                 const int* __restrict__ pos_nnz, int k_uniform, int first,
                 int npos, int nrhs, int ncols, const T* __restrict__ X,
                 const T* C, T* out, Real<T> sign) {
  const int p = first + blockIdx.x * (kK1Threads / 32) + threadIdx.x / 32;
  if (p >= npos) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  int row, ptr, nnz;
  k1_row(order, pos_ptr, pos_nnz, k_uniform, p, row, ptr, nnz);
  const int rbase = row * nrhs;
  // this warp's chunk of 32 * VEC columns (blockIdx.y)
  const int j = blockIdx.y * 32 * VEC + lane * VEC;
  const bool live = j < nrhs;  // nrhs % VEC == 0 (the host checks)
  // C's row does not depend on the entries: its load goes out first
  T acc[VEC], cv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = cv[v] = T(0);
  if (live && C != nullptr) K1Vec<T, VEC>::ld(cv, C + rbase + j);
  for (int k0 = 0; k0 < nnz; k0 += 32) {
    int mc = ncols;
    T mv = T(0);
    if (k0 + lane < nnz) {
      mc = __ldg(idx + ptr + k0 + lane);
      mv = ldg(val + ptr + k0 + lane);
    }
    const int kn = min(32, nnz - k0);
    for (int kb = 0; kb < kn; kb += BATCH) {
      T a[BATCH], x[BATCH][VEC];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        a[u] = T(0);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[u][v] = T(0);
        if (kb + u < kn) {  // the same for the whole warp
          const int c = __shfl_sync(0xffffffffu, mc, kb + u);
          a[u] = shfl(mv, kb + u);
          if (live && c < ncols)
            K1Vec<T, VEC>::ldg(x[u], X + c * nrhs + j);
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) madd(acc[v], a[u], x[u][v]);
    }
  }
  if (!live) return;
  if (C != nullptr) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = cv[v] + sign * acc[v];
  }
  K1Vec<T, VEC>::st(out + rbase + j, acc);
}

// NR elements of an X row: 16-byte loads where NR fills whole lines (X is
// 16-byte aligned then; the host checks), else one element at a time.
template <typename T, int NR>
__device__ __forceinline__ void k1_load_row(T* a, const T* p) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (NR % V == 0) {
#pragma unroll
    for (int q = 0; q < NR / V; ++q) K1Vec<T, V>::ldg(a + q * V, p + q * V);
  } else {
#pragma unroll
    for (int q = 0; q < NR; ++q) a[q] = ldg(p + q);
  }
}

template <typename T, int NR>
__global__ void __launch_bounds__(kK1Threads)
sell_narrow_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                   const int* __restrict__ order,
                   const int* __restrict__ pos_ptr,
                   const int* __restrict__ pos_nnz, int k_uniform, int first,
                   int npos, int ncols, int lg, const T* __restrict__ X,
                   const T* C, T* out, Real<T> sign) {
  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * (kK1Threads / 32) + threadIdx.x / 32;
  const int p0 = first + (warp << (5 - lg));  // 2^(5 - lg) rows a warp
  if (p0 >= npos) return;  // the whole warp
  const int G = 1 << lg;
  const int gl = lane & (G - 1);
  const int p = p0 + (lane >> lg);
  const bool live = p < npos;
  int row = 0, ptr = 0, nnz = 0;
  if (live) k1_row(order, pos_ptr, pos_nnz, k_uniform, p, row, ptr, nnz);
  // lane gl of the group writes columns gl, gl + G, ...; their C goes out
  // before the entries' loads
  T acc[NR], cv[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    acc[q] = cv[q] = T(0);
    if (live && C != nullptr && (q & (G - 1)) == gl) cv[q] = C[row * NR + q];
  }
  for (int k = gl; k < nnz; k += G) {
    const int c = __ldg(idx + ptr + k);
    const T v = ldg(val + ptr + k);
    if (c < ncols) {
      T x[NR];
      k1_load_row<T, NR>(x, X + c * NR);
#pragma unroll
      for (int q = 0; q < NR; ++q) madd(acc[q], v, x[q]);
    }
  }
  // every lane of the warp takes part; a group's lanes only meet each other
  for (int o = G / 2; o > 0; o /= 2)
#pragma unroll
    for (int q = 0; q < NR; ++q) acc[q] += shfl_xor(acc[q], o);
  if (!live) return;
#pragma unroll
  for (int q = 0; q < NR; ++q)
    if ((q & (G - 1)) == gl)
      out[row * NR + q] = C != nullptr ? cv[q] + sign * acc[q] : acc[q];
}

// ---------------------------------------------------------------------------
// K2: one triangular solve (I + strict T) X = B on a level schedule, B to X
// in one launch:
//   x[s] = B[in_rows[s]] (0 where in_rows[s] == n; slot nslots stays 0),
//   level by level x[s] -= sum_k vals[s, k] * x[cols[s, k]],
//   X[r] = x[out_slots[r]].
//
// Bound: bytes, B and X once and the strict factor's entries once (2 FLOP
// per entry and column, 8 real FLOP in complex); what holds it back is the
// chain of levels, each of
// which waits for the one before.  A launch per level costs ~3.6 us
// against ~0.05 us of bytes, so the levels are walked inside one launch,
// and the entry and exit gathers are fused into it.
//
// The columns of B are independent.  In the column form thread block j
// owns column j and walks every level with __syncthreads() between levels;
// no barrier between blocks.  Its slot vector x ([nslots + 1]) lives in
// shared memory where it fits (SMEM, chosen by ops/trsv.py:trsv_shape; a
// complex slot is 8 or 16 bytes, so about 14.5K c128 slots fit the 227 KB)
// and in a global scratch otherwise.  Where x fits, one column a block beat
// two and four on the H100, and beat a cooperative grid split over (slot,
// column) items at one right-hand side, on every schedule of the frozen
// fixture (PERF.md): a tile there multiplies the shared memory x takes.
//
// The tile form (G > 1), where x is global, there are several columns and
// the levels are wide (ops/trsv.py:trsv_tile): a cluster of C CTAs owns a
// tile of G columns, at most one 32-byte sector of x a slot (8 f32, 4 f64
// and c64, 2 c128; the last tile masked).  x is laid out [tile][slot][G],
// so a dependency's gather moves G columns in one or two vector loads and
// each (col, val) entry is loaded once for the tile; the cluster's CTAs
// split each level's slots (runs of whole 16-byte lines of rows, each CTA
// with its own ring) and meet at a cluster barrier (arrive.release,
// wait.acquire) between levels, reading x with ld.global.cg.  Why: with a
// block a column and x global, every block re-read the whole factor and
// the blocks' traffic slowed each other's passes (the 1M factor's pass at
// 64 columns took 1.85x the single column's).  A tile on one block put G
// columns' gathers through one SM's L1 and lost (3.5x slower at 8
// columns): the column form's neighbouring lanes share sectors, a tile's
// do not.  Spread over a cluster it won: the launch aims at about 64 CTAs,
// and on the 1M factor at 64 columns a pass fell from 3.31 to 2.09 us
// (PERF.md).  Each column's sum keeps the column form's order and shuffle
// tree, so a tile's columns equal the column form's bit for bit.
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
constexpr int kTrsvMaxCluster = 8;  // CTAs of a tile's (portable) cluster

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
template <>
struct Line<C64> {  // 32 bytes: two 16-byte loads
  __device__ static void load(C64* a, const C64* p) {
    const float4 q0 = reinterpret_cast<const float4*>(p)[0];
    const float4 q1 = reinterpret_cast<const float4*>(p)[1];
    a[0] = C64(q0.x, q0.y);
    a[1] = C64(q0.z, q0.w);
    a[2] = C64(q1.x, q1.y);
    a[3] = C64(q1.z, q1.w);
  }
};
template <>
struct Line<C128> {  // 64 bytes: four 16-byte loads
  __device__ static void load(C128* a, const C128* p) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const double2 q = reinterpret_cast<const double2*>(p)[u];
      a[u] = C128(q.x, q.y);
    }
  }
};

// A tile's slot of x: G consecutive elements from an address aligned to
// their G * sizeof(T) bytes (8, 16 or 32: one or two vector accesses); G ==
// 1 is the column form's one element.  The tile form's loads bypass L1
// (ld.global.cg): the cluster's other CTAs write x during the launch.
template <typename T, int G>
__device__ __forceinline__ void sector_load(T (&a)[G], const T* p) {
  constexpr int kBytes = G * (int)sizeof(T);
  if constexpr (G == 1) {
    a[0] = *p;
  } else if constexpr (kBytes == 8) {
    const uint2 q = __ldcg(reinterpret_cast<const uint2*>(p));
    memcpy(&a[0], &q, 8);
  } else if constexpr (kBytes == 16) {
    const uint4 q = __ldcg(reinterpret_cast<const uint4*>(p));
    memcpy(&a[0], &q, 16);
  } else {
    static_assert(kBytes == 32, "a tile's slot is at most one sector");
    const uint4 q0 = __ldcg(reinterpret_cast<const uint4*>(p));
    const uint4 q1 = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
    memcpy(&a[0], &q0, 16);
    memcpy(&a[G / 2], &q1, 16);
  }
}
template <typename T, int G>
__device__ __forceinline__ void sector_store(T* p, const T (&a)[G]) {
  constexpr int kBytes = G * (int)sizeof(T);
  if constexpr (G == 1) {
    *p = a[0];
  } else if constexpr (kBytes == 8) {
    uint2 q;
    memcpy(&q, &a[0], 8);
    *reinterpret_cast<uint2*>(p) = q;
  } else if constexpr (kBytes == 16) {
    uint4 q;
    memcpy(&q, &a[0], 16);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    uint4 q0, q1;
    memcpy(&q0, &a[0], 16);
    memcpy(&q1, &a[G / 2], 16);
    reinterpret_cast<uint4*>(p)[0] = q0;
    reinterpret_cast<uint4*>(p)[1] = q1;
  }
}

// G == 1: the column form, block j owns column j.  G > 1: the tile form,
// launched as clusters of ncta CTAs; cluster t owns columns [t G, t G + G)
// and its CTAs split each level's slots (and the entry and exit gathers)
// and meet at a cluster barrier between levels.
template <typename T, bool SMEM, bool RING, int G>
__global__ void __launch_bounds__(kTrsvThreads)
trsv_solve_kernel(const T* __restrict__ B, T* __restrict__ X,
                  const int* __restrict__ in_rows,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const int* __restrict__ out_slots,
                  const int64_t* __restrict__ level_slots, int nlev, int K,
                  int n, int nrhs, int nslots, int tps, int cap, int xbytes,
                  int ncta, T* scratch) {
  constexpr bool kTiled = G > 1;
  static_assert(!kTiled || !SMEM, "a tile keeps x in global memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = kTiled ? ncta : 1;  // the CTAs that share x
  const int rank = kTiled ? (int)blockIdx.x % ncta : 0;
  const int tile = kTiled ? (int)blockIdx.x / ncta : (int)blockIdx.x;
  const int j0 = tile * G;  // the first column of this block's x
  // slot s of x is x[s * G, s * G + G): column j0 + g at g
  T* x = SMEM ? reinterpret_cast<T*>(smem_raw)
              : scratch + (int64_t)tile * (nslots + 1) * G;
  // this CTA's share [a, b) of the slots [s0, s1): all of them in the
  // column form, a run of whole 16-byte lines of each CTA's rows in the
  // tile form
  auto share = [&](int s0, int s1, int& a, int& b) {
    if constexpr (kTiled) {
      const int per = ((s1 - s0 + nb - 1) / nb + 7) & ~7;
      a = min(s1, s0 + rank * per);
      b = min(s1, a + per);
    } else {
      a = s0;
      b = s1;
    }
  };
  // every write of x before every read of the next level, across the
  // cluster in the tile form
  auto level_barrier = [&]() {
    if constexpr (kTiled) {
      asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    } else {
      __syncthreads();
    }
  };
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
    int a, b;
    share((int)level_slots[l], (int)level_slots[l + 1], a, b);
    const int m = min(cap, b - a);
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

  // entry gather, kGatherBatch independent loads at a time (a tile's G
  // columns of a row count as G of them), the cluster's CTAs taking turns
  // by runs of kBatch * kTrsvThreads slots; the last tile's columns past
  // nrhs stay 0
  constexpr int kBatch = G >= kGatherBatch ? 1 : kGatherBatch / G;
  constexpr int kRun = kTrsvThreads * kBatch;
  for (int sb = rank * kRun + threadIdx.x; sb <= nslots; sb += nb * kRun) {
    int r[kBatch];
    T v[kBatch][G];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = sb + u * kTrsvThreads;
      r[u] = s < nslots ? in_rows[s] : n;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[u][g] = r[u] < n && j0 + g < nrhs
                      ? B[(int64_t)r[u] * nrhs + j0 + g]
                      : T(0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = sb + u * kTrsvThreads;
      if (s <= nslots) sector_store(x + (int64_t)s * G, v[u]);
    }
  }
  level_barrier();

  int s0 = (int)level_slots[0];
  int s1 = nlev > 0 ? (int)level_slots[1] : s0;
  for (int l = 0; l < nlev; ++l) {
    const int s2 = l + 2 <= nlev ? (int)level_slots[l + 2] : s1;
    if constexpr (RING) {
      if (threadIdx.x == 0) ring_copy(l + kRingDepth);
      ring_wait(l);
    }
    int a, b;
    share(s0, s1, a, b);
    const int m = RING ? min(cap, b - a) : 0;
    const int* rc = ring_c + (l % kRingSlots) * cap * K;
    const T* rv = ring_v + (l % kRingSlots) * cap * K;
    // with K a multiple of 4, lane lt takes dependencies [4 lt, 4 lt + 4)
    // of every 4 tps, one 16-byte line of cols and of vals; else lt, lt +
    // tps, lt + 2 tps, lt + 3 tps, so that a team's loads are contiguous.
    // Each entry is applied to the tile's G columns, each column's sum in
    // the column form's order
    auto gather = [&](const int* cs, const T* vs, T(&acc)[G]) {
      int c[kDepsPerLane];
      T v[kDepsPerLane];
      if (K % kDepsPerLane == 0) {
        for (int k0 = lt * kDepsPerLane; k0 < K; k0 += kDepsPerLane * tps) {
          Line<int>::load(c, cs + k0);
          Line<T>::load(v, vs + k0);
#pragma unroll
          for (int u = 0; u < kDepsPerLane; ++u) {
            T xs[G];
            sector_load(xs, x + (int64_t)c[u] * G);
#pragma unroll
            for (int g = 0; g < G; ++g) madd(acc[g], v[u], xs[g]);
          }
        }
        return;
      }
      for (int k0 = lt; k0 < K; k0 += kDepsPerLane * tps) {
#pragma unroll
        for (int u = 0; u < kDepsPerLane; ++u) {
          const int k = k0 + u * tps;
          c[u] = k < K ? cs[k] : nslots;  // the zero sentinel slot
          v[u] = k < K ? vs[k] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kDepsPerLane; ++u) {
          T xs[G];
          sector_load(xs, x + (int64_t)c[u] * G);
#pragma unroll
          for (int g = 0; g < G; ++g) madd(acc[g], v[u], xs[g]);
        }
      }
    };
    for (int q = 0; a + st_warp + q * tstride < b; ++q) {
      const int s = a + st + q * tstride;
      const bool live = s < b;
      const int i = s - a;
      T acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = T(0);
      if (live && i < m) {
        gather(rc + i * K, rv + i * K, acc);
      } else if (live) {
        gather(cols + (int64_t)s * K, vals + (int64_t)s * K, acc);
      }
      for (int o = tps / 2; o > 0; o /= 2)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += shfl_xor(acc[g], o);
      if (live && lt == 0) {
        T xs[G];
        sector_load(xs, x + (int64_t)s * G);
#pragma unroll
        for (int g = 0; g < G; ++g) xs[g] -= acc[g];
        sector_store(x + (int64_t)s * G, xs);
      }
    }
    level_barrier();
    s0 = s1;
    s1 = s2;
  }

  // exit gather, kGatherBatch independent loads at a time
  for (int rb = rank * kRun + threadIdx.x; rb < n; rb += nb * kRun) {
    int o[kBatch];
    T v[kBatch][G];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = rb + u * kTrsvThreads;
      o[u] = r < n ? out_slots[r] : nslots;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) sector_load(v[u], x + (int64_t)o[u] * G);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = rb + u * kTrsvThreads;
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (r < n && j0 + g < nrhs) X[(int64_t)r * nrhs + j0 + g] = v[u][g];
    }
  }
}

template <typename M, int VEC, typename T = typename M::T>
int bsr_mma(const T* blocks, const int* bcols, const T* X, T* Y, int nbr,
            int kb, int bs, int nrhs, cudaStream_t stream) {
  using S = TileShape<M>;
  static Granted granted;
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

template <typename T, int NR>
int sell_narrow(const int* idx, const T* val, const int* order,
                const int* pos_ptr, const int* pos_nnz, int k_uniform,
                int first, int npos, int ncols, int lg, const T* X,
                const T* C, T* out, Real<T> sign, cudaStream_t s) {
  const int64_t warps = ((int64_t)(npos - first) + (32 >> lg) - 1) >> (5 - lg);
  constexpr int kWarps = kK1Threads / 32;
  sell_narrow_kernel<T, NR>
      <<<(unsigned)((warps + kWarps - 1) / kWarps), kK1Threads, 0, s>>>(
          idx, val, order, pos_ptr, pos_nnz, k_uniform, first, npos, ncols,
          lg, X, C, out, sign);
  return (int)cudaGetLastError();
}

// out = C + sign A X (A X when C is null; sign is -1 or +1, exact either
// way) over positions [first, npos): first is
// 0, or the count of rows without entries when out == C.  order, pos_ptr
// and pos_nnz are null for a uniform ELL.  max_nnz: the longest row.  vec:
// X, C and out are 16-byte aligned and nrhs is a multiple of 16 bytes of
// elements (the wide shape's 16-byte path); the narrow shape needs X
// 16-byte aligned where nrhs fills whole lines.
template <typename T>
int sell_spmv(const int* idx, const T* val, const int* order,
              const int* pos_ptr, const int* pos_nnz, int k_uniform,
              int first, int npos, int max_nnz, int nrhs, int ncols,
              const T* X, const T* C, T* out, int sign, int vec,
              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (sign != 1 && sign != -1) return (int)cudaErrorInvalidValue;
  if (first >= npos || nrhs <= 0) return (int)cudaSuccess;
  const Real<T> sg = (Real<T>)sign;
  int lg = 0;
  while (lg < 5 && (1 << lg) < max_nnz) ++lg;
#define SELL_NARROW(NR)                                                       \
  return sell_narrow<T, NR>(idx, val, order, pos_ptr, pos_nnz, k_uniform,     \
                            first, npos, ncols, lg, X, C, out, sg, s)
  switch (nrhs) {
    case 1: SELL_NARROW(1);
    case 2: SELL_NARROW(2);
    case 4: SELL_NARROW(4);
    case 8: SELL_NARROW(8);
    default: break;
  }
#undef SELL_NARROW
  constexpr int kWarps = kK1Threads / 32;
  constexpr int V = 16 / sizeof(T);
  const int vec_cols = 32 * (vec ? V : 1);  // the columns of one warp
  const dim3 blocks((unsigned)((npos - first + kWarps - 1) / kWarps),
                    (unsigned)((nrhs + vec_cols - 1) / vec_cols));
#define SELL_WIDE(VEC, BATCH)                                                 \
  sell_wide_kernel<T, VEC, BATCH><<<blocks, kK1Threads, 0, s>>>(              \
      idx, val, order, pos_ptr, pos_nnz, k_uniform, first, npos, nrhs, ncols, \
      X, C, out, sg)
#define SELL_WIDE_BATCH(VEC)    \
  if (max_nnz <= 4)             \
    SELL_WIDE(VEC, 4);          \
  else if (max_nnz <= 8)        \
    SELL_WIDE(VEC, 8);          \
  else if (max_nnz <= 16)       \
    SELL_WIDE(VEC, 16);         \
  else                          \
    SELL_WIDE(VEC, 32)
  if (vec) {
    SELL_WIDE_BATCH(V);
  } else {
    SELL_WIDE_BATCH(1);
  }
#undef SELL_WIDE_BATCH
#undef SELL_WIDE
  return (int)cudaGetLastError();
}

template <typename T, bool SMEM, bool RING, int G>
int trsv_launch(const T* B, T* X, const int* in_rows, const int* cols,
                const T* vals, const int* out_slots,
                const int64_t* level_slots, int nlev, int K, int n, int nrhs,
                int ns, int tps, int cap, int xbytes, int ncta, T* scratch,
                cudaStream_t s) {
  const int smem =
      xbytes + (RING ? kRingBarBytes + cap * kRingSlots * K *
                                           (int)(sizeof(int) + sizeof(T))
                     : 0);
  auto kernel = trsv_solve_kernel<T, SMEM, RING, G>;
  static Granted granted;
  cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (nrhs + G - 1) / G;
  if constexpr (G == 1) {
    kernel<<<(unsigned)tiles, kTrsvThreads, smem, s>>>(
        B, X, in_rows, cols, vals, out_slots, level_slots, nlev, K, n, nrhs,
        ns, tps, cap, xbytes, 1, scratch);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * ncta));
    cfg.blockDim = dim3((unsigned)kTrsvThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, B, X, in_rows, cols, vals,
                             out_slots, level_slots, nlev, K, n, nrhs, ns,
                             tps, cap, xbytes, ncta, scratch);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// One block a column (tile == 1, ncta == 1), or, with x in scratch, a
// cluster of ncta <= 8 blocks a tile of ``tile`` columns (a power of two
// up to 32 / sizeof(T): at most one 32-byte sector of x a slot; the last
// tile masked).  x in shared memory when scratch is null, else in scratch
// (ceil(nrhs / tile) * tile * (nslots + 1) elements).  The ring
// holds up to the widest level (max_level slots; 0: no ring) in the shared
// memory x leaves, or in kRingGlobalBytes with x in scratch.  level_slots
// is a DEVICE array of nlev + 1 slot offsets.
template <typename T>
int trsv_solve(const T* B, T* X, const int* in_rows, const int* cols,
               const T* vals, const int* out_slots,
               const int64_t* level_slots, int nlev, int K, int n, int nrhs,
               int64_t nslots, int max_level, int tile, int ncta,
               T* scratch, void* stream) {
  constexpr int kTile = 32 / sizeof(T);
  const cudaStream_t s = (cudaStream_t)stream;
  int tps = 1;
  while (tps < 32 && tps * kDepsPerLane < K) tps *= 2;
  if (nslots + 1 >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const int ns = (int)nslots;
  const bool smem = scratch == nullptr;
  if (tile < 1 || tile > kTile || (tile & (tile - 1)) || (tile > 1 && smem))
    return (int)cudaErrorInvalidValue;
  if (ncta < 1 || ncta > kTrsvMaxCluster || (tile == 1 && ncta != 1))
    return (int)cudaErrorInvalidValue;
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
#define TRSV_LAUNCH(SMEM, RING, G)                                            \
  return trsv_launch<T, SMEM, RING, G>(B, X, in_rows, cols, vals, out_slots,  \
                                       level_slots, nlev, K, n, nrhs, ns,     \
                                       tps, cap, xbytes, ncta, scratch, s)
  if (smem) {
    if (cap > 0) TRSV_LAUNCH(true, true, 1);
    TRSV_LAUNCH(true, false, 1);
  }
  if (tile == 2) {
    if (cap > 0) TRSV_LAUNCH(false, true, 2);
    TRSV_LAUNCH(false, false, 2);
  }
  if constexpr (kTile >= 4) {
    if (tile == 4) {
      if (cap > 0) TRSV_LAUNCH(false, true, 4);
      TRSV_LAUNCH(false, false, 4);
    }
  }
  if constexpr (kTile >= 8) {
    if (tile == 8) {
      if (cap > 0) TRSV_LAUNCH(false, true, 8);
      TRSV_LAUNCH(false, false, 8);
    }
  }
  if (cap > 0) TRSV_LAUNCH(false, true, 1);
  TRSV_LAUNCH(false, false, 1);
#undef TRSV_LAUNCH
}


// ---------------------------------------------------------------------------
// K10a: one chunk of a distributed level-scheduled triangular solve, for
// every rank of a device in one launch.  Rank r's working vector is row r
// of x (row stride xs); its slot j of the chunk is
// x[r][out_off + r * out_step + j] -= sum_k vals[r][j][k] * x[r][cols[r][j][k]]
// (cols and vals of rank r start at r * cvs, row-major (cloc, K)), and,
// with a package buffer, pkg[r][j] gets the slot's new value (what the
// tiled all_gather sends, as the JAX kernel's ``cur - contrib``).  The
// dependencies lie in earlier chunks (dependency levels are padded to chunk
// boundaries), so no slot reads a slot of its own chunk.  Padded entries
// point at a zero slot with value 0.
//
// Bound: bytes (each dependency reads an index, a value and one x entry
// for two FLOP).  Design: a thread a slot, the dependency loop in
// registers; the chunk is small (C / D slots a rank), so the launch and
// the dependent-load latency dominate, not the bytes.

constexpr int kChunkThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kChunkThreads)
chunk_fma_kernel(T* x, int64_t xs, int out_off, int out_step,
                 const int* __restrict__ cols, const T* __restrict__ vals,
                 int64_t cvs, int nranks, int cloc, int K, T* pkg) {
  const int64_t t = (int64_t)blockIdx.x * kChunkThreads + threadIdx.x;
  if (t >= (int64_t)nranks * cloc) return;
  const int r = (int)(t / cloc), j = (int)(t % cloc);
  T* xr = x + r * xs;
  const int* c = cols + r * cvs + (int64_t)j * K;
  const T* v = vals + r * cvs + (int64_t)j * K;
  T s = T(0);
  for (int k = 0; k < K; ++k) s = fma_rn(__ldg(v + k), xr[__ldg(c + k)], s);
  T* o = xr + out_off + (int64_t)r * out_step + j;
  const T y = *o - s;
  *o = y;
  if (pkg != nullptr) pkg[(int64_t)r * cloc + j] = y;
}

template <typename T>
int chunk_fma(T* x, int64_t xs, int out_off, int out_step, const int* cols,
              const T* vals, int64_t cvs, int nranks, int cloc, int K,
              T* pkg, void* stream) {
  const int64_t total = (int64_t)nranks * cloc;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + kChunkThreads - 1) /
                                     kChunkThreads);
  chunk_fma_kernel<T><<<blocks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      x, xs, out_off, out_step, cols, vals, cvs, nranks, cloc, K, pkg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10a redesigned, the chunk sweep: one launch runs a distributed triangular
// factor's whole chunk loop (the JAX package's lax.scan over the chunks,
// with the exchange legs inside it) for the R ranks of one device.  Rank
// r's working vector is row r of x (row stride xs).  Per chunk c, rank r
// computes its cloc slots as chunk_fma does,
//   y[j] = x[r][own + j] - sum_k vals[j][k] * x[r][cols[j][k]]
// (k = 0..K-1 by fma, K10a's order), and sends them:
// - all_gather form (desc null): own = c * chunk + r * cloc, and y[j] goes
//   to x[q][own + j] for every rank q (the tiled all_gather);
// - halo form: own = c * cloc, y[j] goes to x[r][own + j]; then its legs
//   (the chunk's record: off_l, Wl, off_r, Wr, off_ag, Wag) take the values
//   at rank r's send coordinates: the first Wl to rank r + 1 at off_l, the
//   next Wr to rank r - 1 at off_r, the last Wag to every rank at
//   off_ag + r * Wag.  Edge ranks with no sender keep the zeros their halo
//   region starts with (the caller's precondition).
// A chunk's (cloc, K) cols and vals of every rank are one block of the flat
// operands (rank r's at coff + r * cloc * K; all_gather form coff = c * R *
// cloc * K, halo form coff and K = K_c from the chunk's record), and rank
// r's send coordinates the (W = Wl + Wr + Wag) run at soff + r * W of
// sends.  Records (halo form): kSweepRec int64 a chunk, (coff, K_c, soff,
// off_l, Wl, off_r, Wr, off_ag, Wag, 0).
//
// Bound: the chain of dependent chunk steps, not bytes: a step moves ~6-12
// KB a rank, and each needs every rank's previous step.  Design, one link
// of the chain made short:
// - one thread block cluster, one CTA a rank (several past 16 ranks); the
//   steps are separated by one cluster barrier (arrive.release,
//   wait.acquire), no launch;
// - a rank's cols, vals, send coordinates and record do not depend on x:
//   the TMA copies them S - 1 chunks ahead into a ring in shared memory
//   (an mbarrier a stage), so a step's only global reads are x's;
// - the CTA's last warp is the producer: it computes nothing, arrives at
//   the cluster barrier at once and issues the ring's refill while the
//   other warps step, so the refill is off the chain (issued by a
//   computing thread between its arrive and wait, it lengthened every
//   step; PERF.md section 6);
// - x and its halo stay in global memory (L2 resident at the main path's
//   sizes) and are read with ld.global.cg: other CTAs write them during the
//   launch, so neither L1 nor the read-only path may serve them;
// - the halo legs read this chunk's values from shared memory, where the
//   step also left them.
// A span of a flat operand is copied as the 16-byte lines that cover it;
// the host leaves 16 bytes of slack after each operand and 16-byte aligns
// each chunk's block, so a copy never leaves the allocation.
//
// The peer sweep (PEER): the same loop when the rows axis's ranks lie in G
// groups (the JAX package's multi-chip scan, whose ppermute and all_gather
// run chip to chip; the per-chunk K10a, with the host issuing a launch a
// group and the copies every step, is bound by the host).  A cluster a
// group, as above; the groups' slot vectors are reached through the table
// of base pointers (a peer pointer for a group on another card, with peer
// access enabled), so a step writes its values straight into the
// receiving ranks' vectors: every rank's copy (all_gather form), and in
// the halo form the legs of boundary ranks whose neighbour lies in
// another group and the Wag leg to every rank.  After its cluster barrier
// each group's leader releases "chunk c done" into every other group's
// flag slot (one fence.acq_rel.sys, then st.relaxed.sys a slot: the
// release pattern; a st.release.sys after the fence repeated the fence,
// ~1.9 us a step on the H100, tools/probe_peer_step.py; the value epoch <<
// 32 | c + 1, monotone over launches, so nothing is reset), and a thread
// of each CTA acquires every other group's slot (ld.acquire.sys) before
// the CTA reads x again.  One extra round, epoch << 32, comes before the
// first step (a group writes into vectors only once their card has made
// them), and the round after the last step keeps every group until all
// writes into it have landed.  Groups that share a card run in one launch
// of one cluster each (their co-residency checked first); groups on other
// cards in a launch a card, all issued before the host waits.  Bound: the
// chain again, now with one flag handoff a step (through L2 on one card,
// over NVLink across cards).
// The epoch lives in device memory, one counter a card, so that the
// launch's host arguments are the same at every call and a launch captured
// in a CUDA graph replays right (a value passed by the host would be
// frozen at the capture, and a replay's waits would pass at once against
// the flags of the launch before it).  ``peer_epoch_kernel``, one thread
// launched just before the sweep on the same stream, adds one to it; every
// CTA of the sweep reads it at entry, after the bump in stream order.  Of
// the two designs that keep the host arguments fixed (this bump, or an
// epoch derived in the kernel from a flag slot that only its own group
// writes) the bump needs no change to the flag layout and no reasoning
// about which CTA may write the next value while others still read it;
// it costs one launch of one thread a card.  Eager calls and replays bump
// the same counter in stream order, so the flags stay monotone in any
// interleaving of the two, and every card's counter moves once a factor
// application, which keeps the cards' epochs equal.

constexpr int kSweepMaxCluster = 16;  // CTAs of a non-portable cluster
constexpr int kSweepPortable = 8;     // CTAs of a portable cluster
// at most 512 threads a CTA, so that a thread may hold 128 registers: a
// value spilled to local memory is read back from L2 after the barrier's
// L1 invalidation, on the chain (built for 1024 threads, the f32 kernel
// took 32 registers and spilled, and its step was slower than f64's)
constexpr int kSweepMaxThreads = 512;
constexpr int kSweepRec = 10;         // int64 fields of a chunk's record
constexpr int kSweepRecBytes = kSweepRec * 8;  // 80: whole 16-byte lines
constexpr int kSweepBatch = 8;        // x loads in flight a slot
constexpr int kPeerMaxGroups = 16;    // groups in a peer sweep's table
// a wait for another group that has not ended in 30 s traps
constexpr unsigned long long kPeerWaitNs = 30000000000ull;

__host__ __device__ inline int64_t round16(int64_t b) {
  return (b + 15) / 16 * 16;
}

// Shared memory of a sweep CTA: the stages' mbarriers, then the ring (a
// stage: the record (halo), then each of the CTA's ranks' cols, vals and
// send coordinates), then the CTA's new values (halo).
struct SweepLayout {
  int64_t cbytes, vbytes, sbytes, stage, bars, ring, ys, total;
};

__host__ __device__ inline SweepLayout sweep_layout(int rpc, int cloc,
                                                    int kmax, int wmax,
                                                    int es, bool halo,
                                                    int stages) {
  SweepLayout L;
  L.cbytes = round16((int64_t)cloc * kmax * 4) + 16;
  L.vbytes = round16((int64_t)cloc * kmax * es) + 16;
  L.sbytes = halo ? round16((int64_t)wmax * 8) + 16 : 0;
  L.stage = rpc * (L.cbytes + L.vbytes + L.sbytes) +
            (halo ? kSweepRecBytes : 0);
  L.bars = round16((int64_t)stages * 8);
  L.ring = stages * L.stage;
  L.ys = halo ? round16((int64_t)rpc * cloc * es) : 0;
  L.total = L.bars + L.ring + L.ys;
  return L;
}

inline int sweep_rpc(int R) {
  return (R + kSweepMaxCluster - 1) / kSweepMaxCluster;
}

// The CTA's threads: a thread a slot of a rank (up to kSweepMaxThreads -
// 32 at once), then the producer warp.
inline int sweep_threads(int cloc) {
  const int t = (cloc + 31) / 32 * 32;
  const int most = kSweepMaxThreads - 32;
  return (t < 64 ? 64 : t > most ? most : t) + 32;
}

__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_cg(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];\n" : "=d"(v) : "l"(p));
  return v;
}

// The 16-byte lines covering elements [a, a + n) of ``p``: their first
// address and byte count, and the offset of element a in them (elements).
template <typename E>
struct Span {
  uintptr_t lo;
  unsigned bytes;
  int shift;
  __device__ Span(const E* p, int64_t a, int64_t n) {
    const uintptr_t s = reinterpret_cast<uintptr_t>(p + a);
    const uintptr_t e = reinterpret_cast<uintptr_t>(p + a + n);
    lo = s & ~uintptr_t(15);
    bytes = n > 0 ? (unsigned)(((e + 15) & ~uintptr_t(15)) - lo) : 0u;
    shift = (int)((s - lo) / sizeof(E));
  }
};

// A chunk's record: read from global memory (the producer) or from its
// stage (every thread); the all_gather form computes it.
struct SweepChunk {
  int64_t coff, soff;
  int K, off_l, Wl, off_r, Wr, off_ag, Wag;
};

template <bool HALO>
__device__ __forceinline__ SweepChunk sweep_chunk(const int64_t* rec, int c,
                                                  int R, int cloc, int K) {
  SweepChunk d;
  if constexpr (HALO) {
    d.coff = rec[0];
    d.K = (int)rec[1];
    d.soff = rec[2];
    d.off_l = (int)rec[3];
    d.Wl = (int)rec[4];
    d.off_r = (int)rec[5];
    d.Wr = (int)rec[6];
    d.off_ag = (int)rec[7];
    d.Wag = (int)rec[8];
  } else {
    d.coff = (int64_t)c * R * cloc * K;
    d.K = K;
    d.soff = 0;
    d.off_l = d.Wl = d.off_r = d.Wr = d.off_ag = d.Wag = 0;
  }
  return d;
}

// The chunk loop's arguments, one __grid_constant__ parameter (read from
// the constant bank): the table of the groups of the rows axis in rank
// order, and the operands of the group each cluster of the launch runs.
// The one-group sweep is the table of one group.
template <typename T>
struct SweepArgs {
  T* x[kPeerMaxGroups];      // each group's slot vectors (row q of group h
                             // is rank lo[h] + q); a peer pointer on another
                             // card
  unsigned long long* flags[kPeerMaxGroups];  // each group's G flag slots
  int lo[kPeerMaxGroups + 1];  // group h holds ranks lo[h] .. lo[h + 1] - 1
  int G;                       // groups in the table
  int gid[kPeerMaxGroups];     // the group that cluster i of the launch runs
  const int* cols[kPeerMaxGroups];  // cluster i's group's packed operands
  const T* vals[kPeerMaxGroups];
  const int64_t* sends[kPeerMaxGroups];
  const int64_t* desc[kPeerMaxGroups];
  int64_t xs;                  // the rows' stride, every group's
  const unsigned long long* epoch;  // the card's counter (device memory),
                                    // above every earlier launch's once
                                    // bumped
  int ncta, rpc, nchunks, cloc, K, chunk, kmax, wmax, stages;
};

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

template <typename T, bool HALO, bool PEER>
__global__ void __launch_bounds__(kSweepMaxThreads, 1)
chunk_sweep_kernel(const __grid_constant__ SweepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ci = PEER ? (int)blockIdx.x / a.ncta : 0;  // the launch's cluster
  const int g = PEER ? a.gid[ci] : 0;                  // and its group
  const int G = PEER ? a.G : 1;
  const int lo = a.lo[g], R = a.lo[g + 1] - lo;  // the group's ranks
  const int D = PEER ? a.lo[G] : R;               // the rows axis
  const int* __restrict__ cols = a.cols[ci];
  const T* __restrict__ vals = a.vals[ci];
  const int64_t* __restrict__ sends = a.sends[ci];
  const int64_t* __restrict__ desc = a.desc[ci];
  T* x = a.x[g];
  const int64_t xs = a.xs;
  const int rpc = a.rpc, nchunks = a.nchunks, cloc = a.cloc, K = a.K,
            chunk = a.chunk, stages = a.stages;
  const SweepLayout lay =
      sweep_layout(rpc, cloc, a.kmax, a.wmax, (int)sizeof(T), HALO, stages);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  unsigned char* ring = smem_raw + lay.bars;
  T* ys = reinterpret_cast<T*>(ring + lay.ring);
  const int cta = PEER ? (int)blockIdx.x % a.ncta : (int)blockIdx.x;
  const int r0 = cta * rpc;         // this CTA's first rank in the group
  const int nr = min(rpc, R - r0);  // none in a smaller group's spare CTAs
  const int nw = blockDim.x - 32;   // the computing threads
  const bool producer = threadIdx.x >= nw;
  const bool issuer = threadIdx.x == nw;  // the producer warp's lane 0
  const int rec0 = HALO ? kSweepRecBytes : 0;
  auto rank_base = [&](unsigned char* st, int i) {
    return st + rec0 + i * (lay.cbytes + lay.vbytes + lay.sbytes);
  };
  // rank q's row: the group's own, or a neighbour group's (the legs)
  auto row = [&](int q) -> T* {
    if (!PEER || (q >= lo && q < lo + R)) return x + (int64_t)(q - lo) * xs;
    const int h = q < lo ? g - 1 : g + 1;
    return a.x[h] + (int64_t)(q - a.lo[h]) * xs;
  };
  // v into slot o of every rank's vector
  auto to_all = [&](int64_t o, T v) {
    for (int h = 0; h < G; ++h) {
      T* xh = PEER ? a.x[h] : x;
      const int nh = PEER ? a.lo[h + 1] - a.lo[h] : R;
      for (int p = 0; p < nh; ++p) xh[p * xs + o] = v;
    }
  };
  // the group tells every other group it reached v (its CTAs' writes,
  // ordered before by the cluster barrier, visible to the system first:
  // the fence and the strong stores after it are a release pattern), then
  // each CTA waits until every other group has reached v
  const bool leader = PEER && cta == 0 && threadIdx.x == 0;
  auto sync_groups = [&](unsigned long long v) {
    if (leader) {
      asm volatile("fence.acq_rel.sys;\n" ::: "memory");
      for (int h = 0; h < G; ++h)
        if (h != g) st_relaxed_sys(a.flags[h] + g, v);
    }
    if (threadIdx.x == 0) {
      const unsigned long long t0 = globaltimer_ns();
      for (int h = 0; h < G; ++h)
        while (h != g && ld_acquire_sys(a.flags[g] + h) < v)
          if (globaltimer_ns() - t0 > kPeerWaitNs) __trap();
    }
    __syncthreads();
  };

  // the issuer: copy chunk c (its record d) into stage q
  auto fill = [&](int c, int q, const SweepChunk& d) {
    unsigned char* st = ring + q * lay.stage;
    const unsigned b = smem_u32(&bar[q]);
    unsigned total = HALO ? kSweepRecBytes : 0;
    for (int i = 0; i < nr; ++i) {
      const int64_t a0 = d.coff + (int64_t)(r0 + i) * cloc * d.K;
      const int64_t n = (int64_t)cloc * d.K;
      total += Span<int>(cols, a0, n).bytes + Span<T>(vals, a0, n).bytes;
      if constexpr (HALO) {
        const int W = d.Wl + d.Wr + d.Wag;
        total += Span<int64_t>(sends, d.soff + (int64_t)(r0 + i) * W, W)
                     .bytes;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(total)
        : "memory");
    if constexpr (HALO)
      bulk_copy(st, desc + (int64_t)c * kSweepRec, kSweepRecBytes, b);
    for (int i = 0; i < nr; ++i) {
      unsigned char* rb = rank_base(st, i);
      const int64_t a0 = d.coff + (int64_t)(r0 + i) * cloc * d.K;
      const int64_t n = (int64_t)cloc * d.K;
      const Span<int> sc(cols, a0, n);
      const Span<T> sv(vals, a0, n);
      if (sc.bytes) bulk_copy(rb, (const void*)sc.lo, sc.bytes, b);
      if (sv.bytes)
        bulk_copy(rb + lay.cbytes, (const void*)sv.lo, sv.bytes, b);
      if constexpr (HALO) {
        const int W = d.Wl + d.Wr + d.Wag;
        const Span<int64_t> ss(sends, d.soff + (int64_t)(r0 + i) * W, W);
        if (ss.bytes)
          bulk_copy(rb + lay.cbytes + lay.vbytes, (const void*)ss.lo,
                    ss.bytes, b);
      }
    }
  };

  if (issuer) {
    for (int q = 0; q < stages; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bar[q]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (issuer)
    for (int c = 0; c < min(stages, nchunks); ++c)
      fill(c, c, sweep_chunk<HALO>(HALO ? desc + (int64_t)c * kSweepRec
                                        : nullptr,
                                   c, R, cloc, K));
  // the launch's epoch, bumped in stream order before the launch
  unsigned long long epoch = 0;
  if constexpr (PEER)
    epoch = *reinterpret_cast<const volatile unsigned long long*>(a.epoch);
  // every group's slot vectors are in place before any group writes them
  if constexpr (PEER) sync_groups(epoch << 32);

  for (int c = 0; c < nchunks; ++c) {
    // this iteration's refill: chunk c - 1 + stages into the stage of
    // chunk c - 1, which every thread has read (all passed the last wait)
    const int cn = c - 1 + stages;
    const bool refill = issuer && c >= 1 && cn < nchunks;
    const int q = c % stages;
    unsigned char* st = ring + q * lay.stage;
    SweepChunk d{};
    if (!producer) {
      mbar_wait(smem_u32(&bar[q]), (unsigned)((c / stages) & 1));
      d = sweep_chunk<HALO>(reinterpret_cast<const int64_t*>(st), c, R, cloc,
                            K);
    }
    const int Kc = d.K;
    for (int i = 0; i < nr && !producer; ++i) {
      const int r = r0 + i, rg = lo + r;
      unsigned char* rb = rank_base(st, i);
      const int64_t a0 = d.coff + (int64_t)r * cloc * Kc;
      const int* sc = reinterpret_cast<const int*>(rb) +
                      Span<int>(cols, a0, 0).shift;
      const T* sv = reinterpret_cast<const T*>(rb + lay.cbytes) +
                    Span<T>(vals, a0, 0).shift;
      T* xr = x + r * xs;
      const int own = HALO ? c * cloc : c * chunk + rg * cloc;
      for (int j = threadIdx.x; j < cloc; j += nw) {
        const int* cj = sc + j * Kc;
        const T* vj = sv + j * Kc;
        T acc = T(0);
        for (int k0 = 0; k0 < Kc; k0 += kSweepBatch) {
          T xv[kSweepBatch];
#pragma unroll
          for (int u = 0; u < kSweepBatch; ++u)
            xv[u] = k0 + u < Kc ? ld_cg(xr + cj[k0 + u]) : T(0);
#pragma unroll
          for (int u = 0; u < kSweepBatch; ++u)
            if (k0 + u < Kc) acc = fma_rn(vj[k0 + u], xv[u], acc);
        }
        const T y = ld_cg(xr + own + j) - acc;
        if constexpr (HALO) {
          xr[own + j] = y;
          ys[i * cloc + j] = y;
        } else {
          to_all(own + j, y);
        }
      }
    }
    if constexpr (HALO) {
      __syncthreads();  // the legs read the CTA's new values
      const int W = d.Wl + d.Wr + d.Wag;
      const int own = c * cloc;
      for (int i = 0; i < nr && !producer; ++i) {
        const int r = r0 + i, rg = lo + r;
        const int64_t b0 = d.soff + (int64_t)r * W;
        const int64_t* ss =
            reinterpret_cast<const int64_t*>(rank_base(st, i) + lay.cbytes +
                                             lay.vbytes) +
            Span<int64_t>(sends, b0, 0).shift;
        const T* xr = x + r * xs;
        for (int w = threadIdx.x; w < W; w += nw) {
          const int64_t s = ss[w];
          const T v = s >= own && s < own + cloc ? ys[i * cloc + (s - own)]
                                                 : ld_cg(xr + s);
          if (w < d.Wl) {
            if (rg + 1 < D) row(rg + 1)[d.off_l + w] = v;
          } else if (w < d.Wl + d.Wr) {
            if (rg >= 1) row(rg - 1)[d.off_r + (w - d.Wl)] = v;
          } else {
            to_all(d.off_ag + (int64_t)rg * d.Wag + (w - d.Wl - d.Wr), v);
          }
        }
      }
    }
    if (PEER || c + 1 < nchunks) {
      // every CTA's writes of this chunk before any CTA's next reads (and,
      // across groups, before the leader's release)
      asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
      if (refill)
        fill(cn, cn % stages,
             sweep_chunk<HALO>(HALO ? desc + (int64_t)cn * kSweepRec
                                    : nullptr,
                               cn, R, cloc, K));
      asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    }
    // after the last chunk too: no group leaves while another may still
    // write its vectors
    if constexpr (PEER) sync_groups((epoch << 32) | (unsigned)(c + 1));
  }
}

// One thread: the card's peer-sweep epoch, plus one (see above).
__global__ void peer_epoch_kernel(unsigned long long* epoch) { *epoch += 1; }

// The co-resident clusters of one launch shape on one card, as
// cudaOccupancyMaxActiveClusters gave them the first time the shape was
// launched there; later launches of the shape (a capture's among them)
// read the record and make no query.
struct ClusterFit {
  const void* kernel;
  int dev, ncta, threads, smem, fit;
};
constexpr int kClusterFits = 64;

template <typename Kernel>
cudaError_t cluster_fit(Kernel kernel, int dev, cudaLaunchConfig_t& cfg,
                        int ncta, int* fit) {
  static ClusterFit seen[kClusterFits];
  static int nseen = 0;
  const void* k = reinterpret_cast<const void*>(kernel);
  const int threads = (int)cfg.blockDim.x, smem = (int)cfg.dynamicSmemBytes;
  for (int i = 0; i < nseen; ++i)
    if (seen[i].kernel == k && seen[i].dev == dev && seen[i].ncta == ncta &&
        seen[i].threads == threads && seen[i].smem == smem) {
      *fit = seen[i].fit;
      return cudaSuccess;
    }
  cudaError_t err = cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
  if (err == cudaSuccess && nseen < kClusterFits)
    seen[nseen++] = {k, dev, ncta, threads, smem, *fit};
  return err;
}

// The launch of one or several clusters of ``ncta`` CTAs, each running a
// group of ``a``'s table; the co-residency of the clusters is checked
// first where they wait on each other (several).  The function attributes
// are set and the occupancy asked once a card and shape (at the first
// call, an eager one or a graph's warm-up), so that a launch under stream
// capture makes the launch alone.
template <typename T>
int sweep_launch(SweepArgs<T>& a, int nclusters, bool halo, bool peer,
                 void* stream) {
  const SweepLayout lay = sweep_layout(a.rpc, a.cloc, a.kmax, a.wmax,
                                       (int)sizeof(T), halo, a.stages);
  if (a.stages < 2 || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int smem = (int)lay.total;
  auto kernel = halo ? (peer ? chunk_sweep_kernel<T, true, true>
                             : chunk_sweep_kernel<T, true, false>)
                     : (peer ? chunk_sweep_kernel<T, false, true>
                             : chunk_sweep_kernel<T, false, false>);
  static Granted granted[4];
  cudaError_t err = allow_smem(kernel, smem, granted[2 * halo + peer]);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool nonportable[4][kMaxDevices];
  if (a.ncta > kSweepPortable && !nonportable[2 * halo + peer][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    nonportable[2 * halo + peer][dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nclusters * a.ncta));
  cfg.blockDim = dim3((unsigned)sweep_threads(a.cloc));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (nclusters > 1) {
    // a cluster that waits for one that cannot be resident never ends
    int fit = 0;
    err = cluster_fit(kernel, dev, cfg, a.ncta, &fit);
    if (err != cudaSuccess) return (int)err;
    if (fit < nclusters) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int chunk_sweep(T* x, int64_t xs, int R, int nchunks, int cloc, int K,
                int chunk, const int* cols, const T* vals,
                const int64_t* sends, const int64_t* desc, int kmax, int wmax,
                int stages, void* stream) {
  if (nchunks == 0 || R == 0 || cloc == 0) return (int)cudaSuccess;
  const bool halo = desc != nullptr;
  SweepArgs<T> a = {};
  a.x[0] = x;
  a.lo[1] = R;
  a.G = 1;
  a.cols[0] = cols;
  a.vals[0] = vals;
  a.sends[0] = sends;
  a.desc[0] = desc;
  a.xs = xs;
  a.rpc = sweep_rpc(R);
  a.ncta = (R + a.rpc - 1) / a.rpc;
  a.nchunks = nchunks;
  a.cloc = cloc;
  a.K = K;
  a.chunk = chunk;
  a.kmax = halo ? kmax : K;  // the widest chunk's fan-in
  a.wmax = wmax;
  a.stages = stages;
  return sweep_launch(a, 1, halo, false, stream);
}

// Peer access from the current card to every other card of the table (a
// kernel's stores into another card's memory need it), once a pair: the
// first call on a card (eager, or a graph's warm-up) enables it, and a
// launch under stream capture finds every pair in the table.
inline cudaError_t enable_peers(const int* cards, int G) {
  static bool enabled[kMaxDevices][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int h = 0; h < G; ++h) {
    const int c = cards[h];
    if (c == dev) continue;
    if (dev < 0 || dev >= kMaxDevices || c < 0 || c >= kMaxDevices)
      return cudaErrorInvalidDevice;
    if (enabled[dev][c]) continue;
    err = cudaDeviceEnablePeerAccess(c, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // not a fault: clear it
      err = cudaSuccess;
    }
    if (err != cudaSuccess) return err;
    enabled[dev][c] = true;
  }
  return cudaSuccess;
}

// The peer sweep on the current card: one cluster for each of the ``nloc``
// groups ``gids`` of the G-group table that live on it.  ``xptr``,
// ``flagptr`` and ``cards`` hold every group's slot vectors, flag slots and
// card, ``lo`` the groups' first ranks and the rank count, and the
// operand pointers the local groups' (host arrays).  ``epoch`` is the
// card's counter in device memory: the call bumps it (one thread, on
// ``stream``) and then launches the sweep, which reads it.
template <typename T>
int chunk_peer(int G, const int64_t* xptr, const int64_t* flagptr,
               const int* lo, const int* cards, int64_t xs, int nloc,
               const int* gids, const int64_t* colptr, const int64_t* valptr,
               const int64_t* sendptr, const int64_t* descptr, int nchunks,
               int cloc, int K, int chunk, int kmax, int wmax, int stages,
               int halo, unsigned long long* epoch, void* stream) {
  if (G < 1 || G > kPeerMaxGroups || nloc < 1 || nloc > G ||
      epoch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (nchunks == 0 || cloc == 0) return (int)cudaSuccess;
  cudaError_t err = enable_peers(cards, G);
  if (err != cudaSuccess) return (int)err;
  SweepArgs<T> a = {};
  a.G = G;
  for (int h = 0; h < G; ++h) {
    a.x[h] = reinterpret_cast<T*>(xptr[h]);
    a.flags[h] = reinterpret_cast<unsigned long long*>(flagptr[h]);
  }
  for (int h = 0; h <= G; ++h) a.lo[h] = lo[h];
  int rmax = 0;
  for (int i = 0; i < nloc; ++i) {
    const int h = gids[i];
    if (h < 0 || h >= G || lo[h + 1] <= lo[h])
      return (int)cudaErrorInvalidValue;
    rmax = std::max(rmax, lo[h + 1] - lo[h]);
    a.gid[i] = h;
    a.cols[i] = reinterpret_cast<const int*>(colptr[i]);
    a.vals[i] = reinterpret_cast<const T*>(valptr[i]);
    a.sends[i] = reinterpret_cast<const int64_t*>(sendptr[i]);
    a.desc[i] = reinterpret_cast<const int64_t*>(descptr[i]);
  }
  a.xs = xs;
  a.epoch = epoch;
  a.rpc = sweep_rpc(rmax);
  a.ncta = (rmax + a.rpc - 1) / a.rpc;
  a.nchunks = nchunks;
  a.cloc = cloc;
  a.K = K;
  a.chunk = chunk;
  a.kmax = halo ? kmax : K;
  a.wmax = wmax;
  a.stages = stages;
  peer_epoch_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(epoch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sweep_launch(a, nloc, halo != 0, true, stream);
}

// ---------------------------------------------------------------------------
// K10b: one ring step of the distributed Schur SpGEMM; replaces
// hifir_tpu/parallel/schur.py:_partial_kernel.  Row r of the local L_E
// blocks (rank r / nb, whose U_F panel starts at uf + rank * ufs and whose
// d at d + rank * ds) forms its W = KL * KU candidates
// (uf_idx[l][b], -(le_val[a] * d[l]) * uf_val[l][b]) for l = le_idx[r][a]
// (the sentinel row m of the panel holds column cb), sorts them by column
// and writes, at the position of the last entry of each run of equal
// columns below cb, (column, sum of the run), and (cb, 0) elsewhere.
//
// Bound: bytes, as chip_smoke.py:k10b_row counts them: the masked (rows, W)
// output that the JAX interface fixes, (4 + itemsize) bytes a position,
// and the gathers (each live L_E entry, each U_F row and d entry that a
// live entry references, once a rank); 0.0043 ms at convdiff2d(128)'s
// level 0 in f64.  The first version (a block a row, a bitonic sort in
// shared memory of 36 rounds each closed by __syncthreads, a serial walk
// over each run) spent its time in that barrier chain, not in bytes.
// Design: the W candidates, padded to P = 2^p with a key above every column
// (INT_MAX; cb + 1 in the warp tier), so that the first W sorted positions
// hold the real ones, V a thread in registers; a bitonic network whose stages within a thread are
// register compare-exchanges and across a warp's lanes __shfl_xor; the run
// sums a segmented scan (in the thread, across lanes by shuffles, across
// warps through shared memory, with a carry); the results staged in shared
// memory so that consecutive threads store consecutive positions.  Every
// row of a launch has the same W, so the host picks the tier once a launch
// (parallel/schur.py:schur_plan):
// - warp, P <= 512 and (cb + 2) P <= 2^31: a warp a row, 8 rows a CTA,
//   V = P / 32; the sort moves one word a pair (the column times P plus
//   the position; the values wait in shared memory), every stage unrolled
//   at compile time; no barrier;
// - block, P <= 8192 (and a row of the warp tier's width whose cb is too
//   large to pack): a CTA of P / 16 threads a row, V = 16; only the
//   stages across warps go through shared memory, each closed by a barrier
//   (6 of the network's 78 at P = 4096);
// - global, P > 8192: CTAs striding over the rows, each with P pairs of
//   global scratch; 8192-pair tiles sorted as in the block tier, alternately
//   ascending and descending, then each merge's stages across tiles on the
//   scratch and those within a tile as in the block tier, then the run sums
//   tile by tile with the carry.  No W is refused.
// No atomics: the sorted order follows from the input order alone, and a
// run is summed in it (the scan's association, not the JAX kernel's
// difference of cumulative sums), so the same inputs give the same bits.
// Columns and masks depend only on the sorted keys and equal the JAX
// kernel's.

constexpr int kSchurV = 16;                          // pairs a thread, at most
constexpr int kSchurWarpMax = 32 * kSchurV;          // the warp tier's P
constexpr int kSchurTile = 8192;  // the block tier's widest P, a global tile
constexpr int kSchurTileThreads = kSchurTile / kSchurV;
constexpr int kSchurRowsPerCta = 8;                  // the warp tier
// the tiers, as the host numbers them ("warp", "block", "global")
constexpr int kSchurWarp = 0;
constexpr int kSchurBlock = 1;
constexpr int kSchurGlobal = 2;

template <typename T>
struct SchurArgs {
  const int* le_idx;
  const T* le_val;
  const T* d;
  int64_t ds;
  const int* uf_idx;
  const T* uf_val;
  int64_t ufs;
  int64_t rows;
  int nb, KL, KU, W, cb;
  unsigned ku_magic;  // ceil(2^32 / KU) where w / KU = umulhi(w, it), else 0
  int* out_c;
  T* out_v;
};

// A shared-memory index with a word of padding every 32: a thread's V
// consecutive pairs and a warp's 32 consecutive ones meet no bank conflict.
__host__ __device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int o) {
  return __shfl_up_sync(0xffffffffu, v, o);
}

// Candidate w of row r; a pad (w >= W) has key INT_MAX and value 0.
template <typename T>
__device__ __forceinline__ void schur_candidate(const SchurArgs<T>& a,
                                                int64_t r, int w, int& key,
                                                T& val) {
  key = INT_MAX;
  val = T(0);
  if (w < a.W) {
    const int64_t rank = r / a.nb;
    const int ai = a.ku_magic ? (int)__umulhi((unsigned)w, a.ku_magic)
                              : w / a.KU;
    const int b = w - ai * a.KU;
    const int l = __ldg(a.le_idx + r * a.KL + ai);
    const T ld = __ldg(a.le_val + r * a.KL + ai) * __ldg(a.d + rank * a.ds + l);
    const int64_t u = rank * a.ufs + (int64_t)l * a.KU + b;
    key = __ldg(a.uf_idx + u);
    val = -(ld * __ldg(a.uf_val + u));
  }
}

template <typename T>
__device__ __forceinline__ void schur_cswap(int& ka, T& va, int& kb, T& vb,
                                            bool asc) {
  if (asc ? ka > kb : ka < kb) {
    const int k = ka;
    ka = kb;
    kb = k;
    const T v = va;
    va = vb;
    vb = v;
  }
}

// The warp tier's bitonic sort of the 32 V distinct keys of a warp (key
// v of lane l at position l V + v), ascending, every stage unrolled at
// compile time: j < V within a lane, j >= V across lanes by __shfl_xor.
template <int V>
__device__ __forceinline__ void schur_warp_sort(int (&key)[V], int lane) {
  constexpr int LP = 5 + (V >= 2) + (V >= 4) + (V >= 8) + (V >= 16);
#pragma unroll
  for (int lk = 1; lk <= LP; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= V) {
        // partner lane ^ j / V; the lower lane keeps the smaller key where
        // ascending
        const int m = j / V;
        const bool less = (((lane * V) & k) == 0) == ((lane & m) == 0);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int pk = __shfl_xor_sync(0xffffffffu, key[v], m);
          key[v] = less ? min(key[v], pk) : max(key[v], pk);
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (v & j) continue;
          const bool asc = (((lane * V) & k) | (v & k)) == 0;
          const int lo = min(key[v], key[v | j]);
          const int hi = max(key[v], key[v | j]);
          key[v] = asc ? lo : hi;
          key[v | j] = asc ? hi : lo;
        }
      }
    }
  }
}

// The bitonic network's stages (k, j) for k = k0 .. k1 and j = min(k / 2,
// j1) .. 1 (powers of two) on the NT V pairs at row positions base + t V +
// v, V a thread in registers on entry and on exit; ascending where
// (position & k) == 0.  j < V: within a thread; V <= j < 32 V: across a
// warp's lanes; j >= 32 V: through shared memory (sk, sv), each stage
// closed by a barrier.  Ties never swap, so the order is a function of the
// input order.
template <typename T, int V>
__device__ __forceinline__ void schur_bitonic(int (&key)[V], T (&val)[V],
                                              int* sk, T* sv, int t, int NT,
                                              int base, int k0, int k1,
                                              int j1) {
  const int lane = t & 31;
  for (int k = k0; k <= k1; k <<= 1) {
    int j = min(k >> 1, j1);
    if (j >= 32 * V) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sk[pad32(t * V + v)] = key[v];
        sv[pad32(t * V + v)] = val[v];
      }
      __syncthreads();
      for (; j >= 32 * V; j >>= 1) {
        for (int q = t; q < NT * V / 2; q += NT) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const int pi = pad32(i), pp = pad32(i | j);
          int ka = sk[pi], kb = sk[pp];
          if (((base + i) & k) == 0 ? ka > kb : ka < kb) {
            sk[pi] = kb;
            sk[pp] = ka;
            const T x = sv[pi];
            sv[pi] = sv[pp];
            sv[pp] = x;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        key[v] = sk[pad32(t * V + v)];
        val[v] = sv[pad32(t * V + v)];
      }
      __syncthreads();
    }
    for (; j >= V; j >>= 1) {
      // partner lane ^ j / V, same register; the lower lane keeps the
      // smaller key where ascending
      const int m = j / V;
      const bool less = (((base + t * V) & k) == 0) == ((lane & m) == 0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int pk = __shfl_xor_sync(0xffffffffu, key[v], m);
        const T pv = shfl_xor(val[v], m);
        if (less ? pk < key[v] : pk > key[v]) {
          key[v] = pk;
          val[v] = pv;
        }
      }
    }
#pragma unroll
    for (int jj = V / 2; jj > 0; jj >>= 1) {
      if (jj <= j) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if ((v & jj) == 0)
            schur_cswap(key[v], val[v], key[v | jj], val[v | jj],
                        ((base + t * V + v) & k) == 0);
      }
    }
  }
}

// The runs of the sorted pairs at row positions base + t V + v (V a thread,
// NT threads): head and last flags against the neighbours (``prev``, the
// key before position base; ``next``, the key after the last one), an
// inclusive segmented scan in ``val`` (in the thread, across lanes by
// shuffles and, BLOCK, across warps through ``wk`` and ``ws``, starting
// from ``carry``, the sum of a run that continues from before base), and at
// each position below W (column, sum) where a run below cb ends, (cb, 0)
// elsewhere, into oc and ov (the row's outputs), staged through sk and sv.
// Returns the scan's value at the last position (the next tile's carry).
template <typename T, int V, bool BLOCK>
__device__ __forceinline__ T schur_runs(const int (&key)[V], T (&val)[V],
                                        int prev, T carry, int next, int t,
                                        int NT, int base, int W, int cb,
                                        int* sk, T* sv, int* wk, T* ws,
                                        int* oc, T* ov) {
  const int lane = t & 31, warp = t >> 5;
  int pk = __shfl_up_sync(0xffffffffu, key[V - 1], 1);
  int nk = __shfl_down_sync(0xffffffffu, key[0], 1);
  if constexpr (BLOCK) {
    if (lane == 0) wk[warp] = key[0];
    if (lane == 31) wk[32 + warp] = key[V - 1];
    __syncthreads();
    if (lane == 0) pk = warp ? wk[32 + warp - 1] : prev;
    if (lane == 31) nk = t + 1 < NT ? wk[warp + 1] : next;
  } else {
    if (lane == 0) pk = prev;
    if (lane == 31) nk = next;
  }
  unsigned heads = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (key[v] != (v ? key[v - 1] : pk))
      heads |= 1u << v;
    else if (v)
      val[v] = val[v - 1] + val[v];
  }
  // (has a head, sum since the last head) scanned over the warp's lanes
  bool f = heads != 0;
  T x = val[V - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool fo = __shfl_up_sync(0xffffffffu, (int)f, o);
    const T xo = shfl_up(x, o);
    if (lane >= o) {
      if (!f) x = xo + x;
      f = f || fo;
    }
  }
  const bool ef = __shfl_up_sync(0xffffffffu, (int)f, 1);
  const T ex = shfl_up(x, 1);
  // the sum before the warp: the carry, then the earlier warps in order
  T c = carry;
  if constexpr (BLOCK) {
    if (lane == 31) {
      wk[64 + warp] = f;
      ws[warp] = x;
    }
    __syncthreads();
    for (int w = 0; w < warp; ++w) c = wk[64 + w] ? ws[w] : c + ws[w];
  }
  const T e = lane == 0 ? c : (ef ? ex : c + ex);
  bool seen = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    seen = seen || ((heads >> v) & 1u);
    if (!seen) val[v] = e + val[v];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool keep = key[v] != (v + 1 < V ? key[v + 1] : nk) && key[v] < cb;
    sk[pad32(t * V + v)] = keep ? key[v] : cb;
    sv[pad32(t * V + v)] = keep ? val[v] : T(0);
  }
  T out = T(0);
  if constexpr (BLOCK) {
    if (t == NT - 1) ws[32] = val[V - 1];
    __syncthreads();
    out = ws[32];
  } else {
    __syncwarp();
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = u * NT + t;
    if (base + i < W) {
      oc[base + i] = sk[pad32(i)];
      ov[base + i] = sv[pad32(i)];
    }
  }
  if constexpr (BLOCK)
    __syncthreads();
  else
    __syncwarp();
  return out;
}

// The warp tier: a warp a row, P = 32 V.  The sort moves one word a pair,
// the column times P plus the candidate's position (pads: cb + 1; the host
// takes this tier only where (cb + 2) P <= 2^31), the values waiting in
// shared memory by position; so equal columns keep their input order.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kSchurRowsPerCta)
schur_warp_kernel(SchurArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = 32 * V, np = 33 * V;  // np: pad32 of P positions
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kSchurRowsPerCta + warp;
  if (r >= a.rows) return;
  int* sk = reinterpret_cast<int*>(smem_raw) + warp * np;
  T* sv = reinterpret_cast<T*>(smem_raw +
                               round16((int64_t)kSchurRowsPerCta * np * 4)) +
          warp * np;
  int key[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int w = u * 32 + lane;
    int c;
    T x;
    schur_candidate(a, r, w, c, x);
    sv[pad32(w)] = x;
    key[u] = (w < a.W ? c : a.cb + 1) * P + w;
  }
  schur_warp_sort<V>(key, lane);
  __syncwarp();
  T val[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    val[v] = sv[pad32(key[v] % P)];
    key[v] /= P;
  }
  __syncwarp();
  schur_runs<T, V, false>(key, val, INT_MIN, T(0), INT_MAX, lane, 32, 0, a.W,
                          a.cb, sk, sv, nullptr, nullptr,
                          a.out_c + r * a.W, a.out_v + r * a.W);
}

__host__ __device__ inline int64_t schur_warp_smem(int V, int es) {
  return round16((int64_t)kSchurRowsPerCta * 33 * V * 4) +
         (int64_t)kSchurRowsPerCta * 33 * V * es;
}

// The staging of n pairs, then the warps' first keys, last keys and flags
// (3 x 32 ints) and sums (32, and the tile's last)
__host__ __device__ inline int64_t schur_block_smem(int n, int es) {
  return round16((int64_t)pad32(n) * 4) + round16((int64_t)pad32(n) * es) +
         round16(96 * 4) + round16(33 * (int64_t)es);
}

// A tile's NT V pairs between global memory (gk, gv) and the registers
// (position t V + v), through sk and sv, so that consecutive threads touch
// consecutive addresses.
template <typename T, int V>
__device__ __forceinline__ void schur_tile_load(const int* gk, const T* gv,
                                                int (&key)[V], T (&val)[V],
                                                int* sk, T* sv, int t,
                                                int NT) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    sk[pad32(u * NT + t)] = gk[u * NT + t];
    sv[pad32(u * NT + t)] = gv[u * NT + t];
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    key[v] = sk[pad32(t * V + v)];
    val[v] = sv[pad32(t * V + v)];
  }
  __syncthreads();
}
template <typename T, int V>
__device__ __forceinline__ void schur_tile_store(int* gk, T* gv,
                                                 const int (&key)[V],
                                                 const T (&val)[V], int* sk,
                                                 T* sv, int t, int NT) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sk[pad32(t * V + v)] = key[v];
    sv[pad32(t * V + v)] = val[v];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < V; ++u) {
    gk[u * NT + t] = sk[pad32(u * NT + t)];
    gv[u * NT + t] = sv[pad32(u * NT + t)];
  }
  __syncthreads();
}

// The block tier (P == blockDim.x * 16: a CTA a row) and, GLOBAL, the
// global tier (P > 8192: tiles of 8192 pairs, the CTA's rows r =
// blockIdx.x + gridDim.x i, its P pairs of scratch at scratch + blockIdx.x
// P (4 + sizeof(T)) bytes); two instances, so that each holds only its own
// path's registers.
template <typename T, bool GLOBAL>
__global__ void __launch_bounds__(kSchurTileThreads)
schur_block_kernel(SchurArgs<T> a, int P, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = kSchurV;
  const int t = threadIdx.x, NT = blockDim.x, n = NT * V;
  unsigned char* p = smem_raw;
  int* sk = reinterpret_cast<int*>(p);
  p += round16((int64_t)pad32(n) * 4);
  T* sv = reinterpret_cast<T*>(p);
  p += round16((int64_t)pad32(n) * sizeof(T));
  int* wk = reinterpret_cast<int*>(p);
  T* ws = reinterpret_cast<T*>(p + round16(96 * 4));
  int key[V];
  T val[V];
  if constexpr (!GLOBAL) {
    const int64_t r = blockIdx.x;
#pragma unroll
    for (int u = 0; u < V; ++u)
      schur_candidate(a, r, u * NT + t, key[u], val[u]);
    schur_bitonic<T, V>(key, val, sk, sv, t, NT, 0, 2, n, n);
    schur_runs<T, V, true>(key, val, INT_MIN, T(0), INT_MAX, t, NT, 0, a.W,
                           a.cb, sk, sv, wk, ws, a.out_c + r * a.W,
                           a.out_v + r * a.W);
    return;
  }
  const int tiles = P / n;
  int* gk = reinterpret_cast<int*>(scratch + (int64_t)blockIdx.x * P *
                                                 (4 + (int64_t)sizeof(T)));
  T* gv = reinterpret_cast<T*>(gk + P);
  for (int64_t r = blockIdx.x; r < a.rows; r += gridDim.x) {
    // the tiles sorted, alternately ascending and descending
    for (int tl = 0; tl < tiles; ++tl) {
      const int base = tl * n;
#pragma unroll
      for (int u = 0; u < V; ++u)
        schur_candidate(a, r, base + u * NT + t, key[u], val[u]);
      schur_bitonic<T, V>(key, val, sk, sv, t, NT, base, 2, n, n);
      schur_tile_store(gk + base, gv + base, key, val, sk, sv, t, NT);
    }
    __syncthreads();
    // the merges: stages across tiles on the scratch, then within tiles
    for (int k = 2 * n; k <= P; k <<= 1) {
      for (int j = k >> 1; j >= n; j >>= 1) {
        for (int q = t; q < P / 2; q += NT) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1)), ip = i | j;
          const int ka = gk[i], kb = gk[ip];
          if ((i & k) == 0 ? ka > kb : ka < kb) {
            gk[i] = kb;
            gk[ip] = ka;
            const T x = gv[i];
            gv[i] = gv[ip];
            gv[ip] = x;
          }
        }
        __syncthreads();
      }
      for (int tl = 0; tl < tiles; ++tl) {
        const int base = tl * n;
        schur_tile_load(gk + base, gv + base, key, val, sk, sv, t, NT);
        schur_bitonic<T, V>(key, val, sk, sv, t, NT, base, k, k, n / 2);
        schur_tile_store(gk + base, gv + base, key, val, sk, sv, t, NT);
      }
      __syncthreads();
    }
    // the runs, tile by tile, with the carry
    T carry = T(0);
    for (int tl = 0; tl < tiles; ++tl) {
      const int base = tl * n;
      schur_tile_load(gk + base, gv + base, key, val, sk, sv, t, NT);
      const int prev = tl ? gk[base - 1] : INT_MIN;
      const int next = tl + 1 < tiles ? gk[base + n] : INT_MAX;
      carry = schur_runs<T, V, true>(key, val, prev, carry, next, t, NT,
                                     base, a.W, a.cb, sk, sv, wk, ws,
                                     a.out_c + r * a.W, a.out_v + r * a.W);
    }
  }
}

template <typename T, int V>
int schur_warp_launch(const SchurArgs<T>& a, cudaStream_t stream) {
  const int smem = (int)schur_warp_smem(V, (int)sizeof(T));
  static Granted granted;
  const cudaError_t err = allow_smem(schur_warp_kernel<T, V>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.rows + kSchurRowsPerCta - 1) / kSchurRowsPerCta;
  schur_warp_kernel<T, V><<<(unsigned)grid, 32 * kSchurRowsPerCta, smem,
                            stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch of the tier the host chose: ``P`` the padded width (a power of
// two >= W within the tier's range), ``grid`` and ``scratch`` (grid P (4 +
// sizeof(T)) bytes) the global tier's.
template <typename T>
int schur_partial(const int* le_idx, const T* le_val, const T* d, int64_t ds,
                  const int* uf_idx, const T* uf_val, int64_t ufs, int rows,
                  int nb, int KL, int KU, int cb, int tier, int P, int grid,
                  unsigned char* scratch, int* out_c, T* out_v,
                  void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  const int64_t W = (int64_t)KL * KU;
  if (P < 1 || (P & (P - 1)) != 0 || P < W) return (int)cudaErrorInvalidValue;
  // w / KU as a multiply-high, exact while W KU < 2^32
  const unsigned magic =
      KU > 1 && W * KU < ((int64_t)1 << 32)
          ? (unsigned)((((uint64_t)1 << 32) + KU - 1) / KU)
          : 0u;
  const SchurArgs<T> a{le_idx, le_val, d,  ds, uf_idx, uf_val, ufs, rows,
                       nb,     KL,     KU, (int)W, cb, magic, out_c, out_v};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tier == kSchurWarp) {
    if ((int64_t)(cb + 2) * P > ((int64_t)1 << 31))
      return (int)cudaErrorInvalidValue;
    switch (P) {
      case 32: return schur_warp_launch<T, 1>(a, s);
      case 64: return schur_warp_launch<T, 2>(a, s);
      case 128: return schur_warp_launch<T, 4>(a, s);
      case 256: return schur_warp_launch<T, 8>(a, s);
      case 512: return schur_warp_launch<T, 16>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool global = tier == kSchurGlobal;
  if (!(tier == kSchurBlock && P >= kSchurWarpMax && P <= kSchurTile) &&
      !(global && P > kSchurTile && grid > 0 && scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const int n = global ? kSchurTile : P;
  const int smem = (int)schur_block_smem(n, (int)sizeof(T));
  static Granted granted[2];
  const cudaError_t err =
      global ? allow_smem(schur_block_kernel<T, true>, smem, granted[1])
             : allow_smem(schur_block_kernel<T, false>, smem, granted[0]);
  if (err != cudaSuccess) return (int)err;
  if (global)
    schur_block_kernel<T, true><<<(unsigned)grid, n / kSchurV, smem, s>>>(
        a, P, scratch);
  else
    schur_block_kernel<T, false><<<(unsigned)rows, n / kSchurV, smem, s>>>(
        a, P, scratch);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K8: Householder QR with column pivoting of a dense n x n A, A[:, piv] =
// Q R, in one cooperative launch.  Replaces
// hifir_tpu/small_scale/qrcp_device.py:qrcp_device (a lax.fori_loop of n
// steps in one jax.jit) and computes what it computes: greedy pivoting on
// the downdated, clamped column norms (ties to the lowest column position),
// the reflector alpha = -sign(x_k or 1) sigma with v normalised (left as it
// is when |v| = 0), the annihilated entries set to exactly 0 and the
// diagonal to exactly alpha, norms2 = max(norms2 - R[k, :]^2, 0).
//
// Bound: A read once and Q and R written once are microseconds, and so are
// the (8/3) n^3 FLOP at the tails' sizes; what sets the time is the chain
// of n dependent steps.  Design: one grid of co-resident CTAs (the host
// sizes it from the occupancy and refuses a grid that cannot be) and one
// grid barrier a step.
// - CTA g owns physical columns [g cpc, (g + 1) cpc) of R and the same rows
//   of Q.  R's update R_j -= 2 v (v^T R_j) is local to a column and Q's
//   q_i -= 2 (q_i . v) v^T to a row, so once v is known a step needs no
//   other CTA's data.  Only rows >= k of the trailing columns of R and
//   columns >= k of Q change at step k (v is zero above row k, and v^T R_j
//   is exactly 0 for a pivoted column j), so a step touches only those.
// - Columns never move: every CTA keeps the same logical -> physical map
//   (and its inverse) in shared memory and swaps it as the loop swaps
//   columns; R is written through the map at the end.
// - After its updates a CTA publishes one candidate: its trailing column of
//   largest norm (ties to the lowest logical position), the norm, the
//   position and the column's rows below the next diagonal, in a double
//   buffer of the step's parity.  After the grid barrier every CTA reduces
//   the candidates the same way (so the first maximal position wins, as
//   argmax picks it), reads the winning column and builds v redundantly:
//   one barrier a step.  Data that other CTAs wrote in the launch is read
//   with ld.global.cg, never through the read-only path.
// - Three layouts; the host picks the first whose shared memory fits
//   (small_scale/qrcp_device.py:qrcp_layout) and qrcp_plan checks it.
//   kQrcpShared: the slabs of R and Q in shared memory (n up to about 1200
//   in f64 on 132 SMs).  kQrcpGlobal: the slabs in global memory (R in a
//   scratch copy, column-major, and Q in place), where L2 holds them
//   while they fit.  kQrcpGlobalX (n from 14465 in f64, 19313 in f32 on
//   132 SMs): x, the map and its inverse too, each CTA its own copy in a
//   global scratch that only it reads and writes, so that ordinary loads
//   after __syncthreads see its writes; shared memory then holds only the
//   CTA's norms and the warps' partial sums, and no n is refused for it.

constexpr int kQrcpThreads = 512;
constexpr int kQrcpWarps = kQrcpThreads / 32;

__device__ __forceinline__ int ld_cg(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float((int)0xff800000u);
}
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double((long long)0xfff0000000000000ULL);
}

// The pivot order: the larger norm first, a NaN above every number (as
// argmax takes it), then the lower logical position.  A total order on
// distinct positions, so every lane and every CTA reduces to the same one.
template <typename T>
__device__ __forceinline__ bool qrcp_before(T v, int p, T bv, int bp) {
  if (v != v) return bv == bv || p < bp;  // v is a NaN
  if (bv != bv) return false;
  return v > bv || (v == bv && p < bp);
}

// A lane's share of a . b over i = i0, i0 + 32, ... < n, one FMA chain in
// that order, and y[i] -= 2 (x[i] w) over the same i.  U > 1 starts U
// strides' loads before their arithmetic (the compiler cannot move a load
// above a store that may alias it): kQrcpGlobalX's columns stream from
// device memory, where that more than doubled the step's rate, while at
// the sizes whose columns stay in L2 it was slower, so only kQrcpGlobalX
// takes it.  The sums and products are the same either way.
template <int U, typename T>
__device__ __forceinline__ T qrcp_dot(const T* a, const T* b, int i, int n) {
  T w = T(0);
  for (; i + 32 * (U - 1) < n && U > 1; i += 32 * U) {
    T av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = a[i + 32 * u];
      bv[u] = b[i + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) w = fma_rn(av[u], bv[u], w);
  }
  for (; i < n; i += 32) w = fma_rn(a[i], b[i], w);
  return w;
}
template <int U, typename T>
__device__ __forceinline__ void qrcp_update(T* y, const T* x, T w, int i,
                                            int n) {
  for (; i + 32 * (U - 1) < n && U > 1; i += 32 * U) {
    T xv[U], yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xv[u] = x[i + 32 * u];
      yv[u] = y[i + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) y[i + 32 * u] = yv[u] - T(2) * (xv[u] * w);
  }
  for (; i < n; i += 32) y[i] = y[i] - T(2) * (x[i] * w);
}

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// The layouts of qrcp_kernel, as the host names them ("shared", "global",
// "global_x")
constexpr int kQrcpShared = 0;
constexpr int kQrcpGlobal = 1;
constexpr int kQrcpGlobalX = 2;

// x (then v), the map and its inverse: n values and two int arrays of n,
// in shared memory or (kQrcpGlobalX) in each CTA's part of the scratch
__host__ __device__ inline int64_t qrcp_vec_bytes(int n, int es) {
  return round16((int64_t)n * es) + 2 * round16((int64_t)n * 4);
}

// Dynamic shared memory of a CTA: the norms of its columns, the warps'
// partial sums and x_k, then (not kQrcpGlobalX) x, the map and its
// inverse, then (kQrcpShared) the R slab (cpc columns of n) and the Q slab
// (cpc rows of n).  small_scale/qrcp_device.py:qrcp_smem computes the same.
__host__ __device__ inline int64_t qrcp_smem(int n, int cpc, int es,
                                             int layout) {
  int64_t b = round16((int64_t)cpc * es) +
              round16((int64_t)(kQrcpWarps + 1) * es);
  if (layout != kQrcpGlobalX) b += qrcp_vec_bytes(n, es);
  if (layout == kQrcpShared) b += 2 * round16((int64_t)cpc * n * es);
  return b;
}

template <typename T, int LAYOUT>
__global__ void __launch_bounds__(kQrcpThreads, 1)
qrcp_kernel(const T* __restrict__ A, int n, int cpc, T* Q, T* R,
            int64_t* piv, T* rt, unsigned char* vec, T* cand_col,
            T* cand_norm, int* cand_pos) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = g * cpc;
  const int nc = max(0, min(cpc, n - c0));
  const int es = (int)sizeof(T);
  constexpr int U = LAYOUT == kQrcpGlobalX ? 4 : 1;  // see qrcp_dot
  unsigned char* p = smem_raw;
  T* nrm = reinterpret_cast<T*>(p);
  p += round16((int64_t)cpc * es);
  T* part = reinterpret_cast<T*>(p);   // kQrcpWarps partial sums, then x_k
  p += round16((int64_t)(kQrcpWarps + 1) * es);
  // x, map and inv: here, or this CTA's part of the global scratch
  unsigned char* q = LAYOUT == kQrcpGlobalX
                         ? vec + (int64_t)g * qrcp_vec_bytes(n, es)
                         : p;
  T* xs = reinterpret_cast<T*>(q);
  q += round16((int64_t)n * es);
  int* map = reinterpret_cast<int*>(q);
  q += round16((int64_t)n * 4);
  int* inv = reinterpret_cast<int*>(q);
  q += round16((int64_t)n * 4);
  T* Rs;  // R slab, column-major: Rs[cl * n + i] = R[i, c0 + cl]
  T* Qs;  // Q slab, row-major: Qs[rl * n + l] = Q[c0 + rl, l]
  if constexpr (LAYOUT == kQrcpShared) {
    Rs = reinterpret_cast<T*>(q);
    Qs = Rs + round16((int64_t)cpc * n * es) / es;
  } else {
    Rs = rt + (int64_t)c0 * n;
    Qs = Q + (int64_t)c0 * n;
  }

  // the candidate of this CTA for step kn: its column of largest norm among
  // those at logical positions >= kn, its rows kn.. into the buffer of
  // kn's parity (every thread finds the same one)
  auto publish = [&](int kn) {
    T best = neg_inf<T>();
    int bpos = INT_MAX, bcl = -1;
    for (int cl = 0; cl < nc; ++cl) {
      const int pos = inv[c0 + cl];
      if (pos >= kn && qrcp_before(nrm[cl], pos, best, bpos)) {
        best = nrm[cl];
        bpos = pos;
        bcl = cl;
      }
    }
    const int64_t slot = (int64_t)(kn & 1) * G + g;
    if (tid == 0) {
      cand_norm[slot] = best;
      cand_pos[slot] = bpos;
    }
    if (bcl >= 0) {
      const T* src = Rs + (int64_t)bcl * n;
      T* dst = cand_col + slot * n;
      for (int i = kn + tid; i < n; i += kQrcpThreads) dst[i] = src[i];
    }
  };

  for (int i = tid; i < n; i += kQrcpThreads) map[i] = inv[i] = i;
  for (int64_t e = tid; e < (int64_t)n * nc; e += kQrcpThreads) {
    const int i = (int)(e / nc), cl = (int)(e % nc);
    Rs[(int64_t)cl * n + i] = A[(int64_t)i * n + c0 + cl];
  }
  for (int64_t e = tid; e < (int64_t)n * nc; e += kQrcpThreads)
    Qs[e] = e % n == c0 + e / n ? T(1) : T(0);
  __syncthreads();
  for (int cl = warp; cl < nc; cl += kQrcpWarps) {
    const T* col = Rs + (int64_t)cl * n;
    T s = T(0);
    for (int i = lane; i < n; i += 32) s = fma_rn(col[i], col[i], s);
    s = warp_sum(s);
    if (lane == 0) nrm[cl] = s;
  }
  __syncthreads();
  publish(0);
  grid.sync();

  for (int k = 0; k < n; ++k) {
    // the pivot: the first of the CTAs' candidates in pivot order (each
    // warp reduces them itself)
    const int64_t base = (int64_t)(k & 1) * G;
    T best = neg_inf<T>();
    int bpos = INT_MAX, bg = 0;
    for (int h = lane; h < G; h += 32) {
      const T v = ld_cg(cand_norm + base + h);
      const int pos = ld_cg(cand_pos + base + h);
      if (qrcp_before(v, pos, best, bpos)) {
        best = v;
        bpos = pos;
        bg = h;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      const T v = shfl_xor(best, o);
      const int pos = shfl_xor(bpos, o), h = shfl_xor(bg, o);
      if (qrcp_before(v, pos, best, bpos)) {
        best = v;
        bpos = pos;
        bg = h;
      }
    }
    const int j = bpos;      // logical position of the pivot
    const int c = map[j];    // its physical column
    const int a = map[k];    // the column it trades places with
    // x = the pivot column from row k; the sum of squares below row k
    const T* x = cand_col + (base + bg) * n;
    T s = T(0);
    for (int i = k + tid; i < n; i += kQrcpThreads) {
      const T xv = ld_cg(x + i);
      xs[i] = xv;
      if (i > k) s = fma_rn(xv, xv, s);
      else part[kQrcpWarps] = xv;
    }
    s = warp_sum(s);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    T s1 = T(0);
#pragma unroll
    for (int w = 0; w < kQrcpWarps; ++w) s1 += part[w];
    const T xk = part[kQrcpWarps];
    const T sigma = sqrt_rn(fma_rn(xk, xk, s1));
    const T alpha = xk < T(0) ? sigma : -sigma;
    const T vk = xk - alpha;
    const T vn = sqrt_rn(fma_rn(vk, vk, s1));
    for (int i = k + tid; i < n; i += kQrcpThreads) {
      const T xv = i == k ? vk : xs[i];
      xs[i] = vn > T(0) ? xv / vn : xv;
    }
    if (tid == 0) {
      map[k] = c;
      map[j] = a;
      inv[c] = k;
      inv[a] = j;
    }
    __syncthreads();
    // a warp a task: the CTA's trailing columns of R, then its rows of Q
    for (int t = warp; t < 2 * nc; t += kQrcpWarps) {
      if (t < nc) {
        T* col = Rs + (int64_t)t * n;
        if (c0 + t == c) {  // the pivot: its diagonal and zeros below it
          for (int i = k + lane; i < n; i += 32)
            col[i] = i == k ? alpha : T(0);
          continue;
        }
        if (inv[c0 + t] < k) continue;  // pivoted at an earlier step
        const T w = warp_sum(qrcp_dot<U>(xs, col, k + lane, n));
        qrcp_update<U>(col, xs, w, k + lane, n);
        __syncwarp();
        if (lane == 0) {
          const T d = nrm[t] - col[k] * col[k];
          nrm[t] = d < T(0) ? T(0) : d;
        }
      } else {
        T* row = Qs + (int64_t)(t - nc) * n;
        const T w = warp_sum(qrcp_dot<U>(row, xs, k + lane, n));
        qrcp_update<U>(row, xs, w, k + lane, n);
      }
    }
    __syncthreads();
    if (k + 1 < n) {
      publish(k + 1);
      grid.sync();
    }
  }

  // R through the map (zeros below the diagonal), Q's rows, the pivots
  for (int64_t e = tid; e < (int64_t)n * nc; e += kQrcpThreads) {
    const int i = (int)(e / nc), cl = (int)(e % nc);
    const int pos = inv[c0 + cl];
    R[(int64_t)i * n + pos] = i <= pos ? Rs[(int64_t)cl * n + i] : T(0);
  }
  if constexpr (LAYOUT == kQrcpShared)
    for (int64_t e = tid; e < (int64_t)n * nc; e += kQrcpThreads)
      Q[(int64_t)c0 * n + e] = Qs[e];
  if (g == 0)
    for (int i = tid; i < n; i += kQrcpThreads) piv[i] = map[i];
}

template <typename T>
const void* qrcp_entry(int layout) {
  return layout == kQrcpShared   ? (const void*)qrcp_kernel<T, kQrcpShared>
         : layout == kQrcpGlobal ? (const void*)qrcp_kernel<T, kQrcpGlobal>
                                 : (const void*)qrcp_kernel<T, kQrcpGlobalX>;
}

// The launch plan of an n x n QRCP at ``cpc`` columns a CTA in ``layout``,
// both chosen by the host (small_scale/qrcp_device.py:qrcp_layout): out =
// {grid, dynamic shared memory}.  Refuses a layout whose shared memory
// exceeds kMaxSmem (cudaErrorInvalidValue) and a grid that cannot be
// co-resident (cudaErrorCooperativeLaunchTooLarge), never shrinks it.
template <typename T>
int qrcp_plan(int n, int cpc, int layout, int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || cpc < 1 || cpc > n || layout < kQrcpShared ||
      layout > kQrcpGlobalX)
    return (int)cudaErrorInvalidValue;
  const int G = (n + cpc - 1) / cpc;
  const int64_t smem = qrcp_smem(n, cpc, (int)sizeof(T), layout);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* kernel = qrcp_entry<T>(layout);
  static Granted granted[3];
  err = allow_smem(kernel, (int)smem, granted[layout]);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kQrcpThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)per_sm * sms < G)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  out[0] = G;
  out[1] = (int)smem;
  return (int)cudaSuccess;
}

template <typename T>
int qrcp(const T* A, int n, int cpc, int layout, int grid, T* Q, T* R,
         int64_t* piv, T* rt, unsigned char* vec, T* cand_col, T* cand_norm,
         int* cand_pos, void* stream) {
  int plan[2];
  const int err = qrcp_plan<T>(n, cpc, layout, plan);
  if (err != (int)cudaSuccess) return err;
  // the scratch was sized for ``grid`` CTAs; the global layouts need R's
  // scratch copy, kQrcpGlobalX the CTAs' x, map and inv
  if (plan[0] != grid || (layout != kQrcpShared && rt == nullptr) ||
      (layout == kQrcpGlobalX && vec == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&A,   (void*)&n,        (void*)&cpc,
                  (void*)&Q,   (void*)&R,        (void*)&piv,
                  (void*)&rt,  (void*)&vec,      (void*)&cand_col,
                  (void*)&cand_norm, (void*)&cand_pos};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      qrcp_entry<T>(layout), dim3((unsigned)grid), dim3(kQrcpThreads), args,
      (size_t)plan[1], (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hifir_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The dynamic shared memory a block may hold; the host checks a kernel's
// need against it before the launch (K8's layout, the chunk sweep's ring).
int hifir_max_smem() { return kMaxSmem; }

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

#define HIFIR_DEFINE_BSR(SUFFIX, T, M)                                        \
  int bsr_spmv_##SUFFIX(const T* blocks, const int* bcols, const T* X, T* Y, \
                        int nbr, int kb, int bs, int nrhs, int path, int vec, \
                        void* stream) {                                       \
    return bsr_spmv<M>(blocks, bcols, X, Y, nbr, kb, bs, nrhs, path, vec,    \
                       stream);                                               \
  }
#define HIFIR_DEFINE(SUFFIX, T)                                               \
  int sell_spmv_##SUFFIX(const int* idx, const T* val, const int* order,     \
                         const int* pos_ptr, const int* pos_nnz,             \
                         int k_uniform, int first, int npos, int max_nnz,    \
                         int nrhs, int ncols, const T* X, const T* C,        \
                         T* out, int sign, int vec, void* stream) {          \
    return sell_spmv<T>(idx, val, order, pos_ptr, pos_nnz, k_uniform, first, \
                        npos, max_nnz, nrhs, ncols, X, C, out, sign, vec,    \
                        stream);                                              \
  }                                                                           \
  int trsv_solve_##SUFFIX(const T* B, T* X, const int* in_rows,              \
                          const int* cols, const T* vals,                    \
                          const int* out_slots, const int64_t* level_slots,  \
                          int nlev, int K, int n, int nrhs, int64_t nslots,  \
                          int max_level, int tile, int ncta, T* scratch,     \
                          void* stream) {                                     \
    return trsv_solve<T>(B, X, in_rows, cols, vals, out_slots, level_slots,  \
                         nlev, K, n, nrhs, nslots, max_level, tile, ncta,    \
                         scratch, stream);                                    \
  }

#define HIFIR_DEFINE_DIST(SUFFIX, T)                                          \
  int chunk_fma_##SUFFIX(T* x, int64_t xs, int out_off, int out_step,        \
                         const int* cols, const T* vals, int64_t cvs,        \
                         int nranks, int cloc, int K, T* pkg,                \
                         void* stream) {                                      \
    return chunk_fma<T>(x, xs, out_off, out_step, cols, vals, cvs, nranks,   \
                        cloc, K, pkg, stream);                                \
  }                                                                           \
  int chunk_sweep_##SUFFIX(T* x, int64_t xs, int R, int nchunks, int cloc,   \
                           int K, int chunk, const int* cols, const T* vals, \
                           const int64_t* sends, const int64_t* desc,        \
                           int kmax, int wmax, int stages, void* stream) {   \
    return chunk_sweep<T>(x, xs, R, nchunks, cloc, K, chunk, cols, vals,     \
                          sends, desc, kmax, wmax, stages, stream);          \
  }                                                                           \
  int chunk_peer_##SUFFIX(int G, const int64_t* xptr, const int64_t* flagptr, \
                          const int* lo, const int* cards, int64_t xs,       \
                          int nloc, const int* gids, const int64_t* colptr,  \
                          const int64_t* valptr, const int64_t* sendptr,     \
                          const int64_t* descptr, int nchunks, int cloc,     \
                          int K, int chunk, int kmax, int wmax, int stages,  \
                          int halo, unsigned long long* epoch,               \
                          void* stream) {                                     \
    return chunk_peer<T>(G, xptr, flagptr, lo, cards, xs, nloc, gids, colptr, \
                         valptr, sendptr, descptr, nchunks, cloc, K, chunk,   \
                         kmax, wmax, stages, halo, epoch, stream);           \
  }                                                                           \
  int schur_partial_##SUFFIX(const int* le_idx, const T* le_val, const T* d, \
                             int64_t ds, const int* uf_idx, const T* uf_val, \
                             int64_t ufs, int rows, int nb, int KL, int KU,  \
                             int cb, int tier, int P, int grid,              \
                             unsigned char* scratch, int* out_c, T* out_v,   \
                             void* stream) {                                  \
    return schur_partial<T>(le_idx, le_val, d, ds, uf_idx, uf_val, ufs, rows, \
                            nb, KL, KU, cb, tier, P, grid, scratch, out_c,    \
                            out_v, stream);                                   \
  }

// The shared memory a chunk sweep's CTA needs (the host checks it against
// hifir_max_smem before it builds a sweep, and picks the ring's stages; a
// peer sweep's R is its largest group's).
int64_t chunk_sweep_smem(int R, int cloc, int kmax, int wmax, int es,
                         int halo, int stages) {
  return sweep_layout(sweep_rpc(R), cloc, kmax, wmax, es, halo != 0, stages)
      .total;
}

// K10a and K10b are real only, as the distribution they serve
HIFIR_DEFINE_DIST(f32, float)
HIFIR_DEFINE_DIST(f64, double)

#define HIFIR_DEFINE_QRCP(SUFFIX, T)                                          \
  int qrcp_plan_##SUFFIX(int n, int cpc, int layout, int* out) {             \
    return qrcp_plan<T>(n, cpc, layout, out);                                 \
  }                                                                           \
  int qrcp_##SUFFIX(const T* A, int n, int cpc, int layout, int grid, T* Q,  \
                    T* R, int64_t* piv, T* rt, unsigned char* vec,           \
                    T* cand_col, T* cand_norm, int* cand_pos,                \
                    void* stream) {                                           \
    return qrcp<T>(A, n, cpc, layout, grid, Q, R, piv, rt, vec, cand_col,    \
                   cand_norm, cand_pos, stream);                              \
  }

// K8 is real only, as the JAX sweep
HIFIR_DEFINE_QRCP(f32, float)
HIFIR_DEFINE_QRCP(f64, double)

// K7 is real only, as the TPU kernel it replaces; K1 and K2 take complex
HIFIR_DEFINE_BSR(f32, float, MmaTf32x3)
HIFIR_DEFINE_BSR(f64, double, MmaF64)
HIFIR_DEFINE(f32, float)
HIFIR_DEFINE(f64, double)
HIFIR_DEFINE(c64, C64)
HIFIR_DEFINE(c128, C128)

#undef HIFIR_DEFINE
#undef HIFIR_DEFINE_BSR
#undef HIFIR_DEFINE_DIST
#undef HIFIR_DEFINE_QRCP

}  // extern "C"
