// Standalone replay bench for the native Crout level kernel.
//
// The port's copy of hifir_tpu/native/bench/bench_crout.cpp, linked against
// the port's native host library (native/src).  Reads the raw input dump
// produced by HT_DUMP_CROUT (see hifir_tpu_torch/pre/_native.py:crout; the
// same byte format as the JAX package's hook) and calls ht_crout on it
// `reps` times,
// printing wall time per rep.  Because the build host's speed swings 2-3x
// between machine phases, kernel variants must be compared by interleaving
// them INSIDE one process run (alternate A/B per rep) — this program is the
// harness for that.
//
// Build:  hifir_tpu_torch.native.build.build_bench_crout() (prints nothing;
//         returns the executable's path under build/hifir_tpu_torch/native)
// Usage:  bench_crout <dumpfile> [reps]
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

using i64 = long long;
using i32 = int;

extern "C" {
void *ht_crout(i64 n, i64 m2, const i64 *Ap, const i32 *Ai, const double *Av,
               const double *d0, double kappa_d, double kappa, double tau_L,
               double tau_U, double alpha_L, double alpha_U,
               const i64 *row_ref, const i64 *col_ref, double schur_aL,
               double schur_aU, int symmetric);
void ht_res_free(void *h);
i64 ht_res_m(void *h);
i64 ht_res_nnz(void *h, int what);
}

int main(int argc, char **argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <dumpfile> [reps]\n", argv[0]);
    return 1;
  }
  const int reps = argc > 2 ? std::atoi(argv[2]) : 3;
  FILE *f = std::fopen(argv[1], "rb");
  if (!f) { std::perror("open"); return 1; }
  i64 hdr[4];
  double pars[8];
  if (std::fread(hdr, sizeof(i64), 4, f) != 4) return 2;
  if (std::fread(pars, sizeof(double), 8, f) != 8) return 2;
  const i64 n = hdr[0], m2 = hdr[1], nnz = hdr[2];
  const int sym = (int)hdr[3];
  // pars file order (from _native.crout's `pars` tuple):
  // kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U, schur_aL, schur_aU
  const double kappa_d = pars[0], kappa = pars[1], tau_U = pars[2],
               tau_L = pars[3], alpha_L = pars[4], alpha_U = pars[5],
               schur_aL = pars[6], schur_aU = pars[7];
  std::vector<i64> Ap(n + 1), row_ref(n), col_ref(n);
  std::vector<i32> Ai(nnz);
  std::vector<double> Av(nnz), d0(m2);
  if (std::fread(Ap.data(), sizeof(i64), n + 1, f) != (size_t)(n + 1))
    return 2;
  if (std::fread(Ai.data(), sizeof(i32), nnz, f) != (size_t)nnz) return 2;
  if (std::fread(Av.data(), sizeof(double), nnz, f) != (size_t)nnz) return 2;
  if (std::fread(d0.data(), sizeof(double), m2, f) != (size_t)m2) return 2;
  if (std::fread(row_ref.data(), sizeof(i64), n, f) != (size_t)n) return 2;
  if (std::fread(col_ref.data(), sizeof(i64), n, f) != (size_t)n) return 2;
  std::fclose(f);
  std::printf("n=%lld m2=%lld nnz=%lld sym=%d kappa=%g tau=%g/%g alpha=%g/%g\n",
              n, m2, nnz, sym, kappa, tau_L, tau_U, alpha_L, alpha_U);
  for (int r = 0; r < reps; ++r) {
    auto t0 = std::chrono::steady_clock::now();
    void *h = ht_crout(n, m2, Ap.data(), Ai.data(), Av.data(), d0.data(),
                       kappa_d, kappa, tau_L, tau_U, alpha_L, alpha_U,
                       row_ref.data(), col_ref.data(), schur_aL, schur_aU,
                       sym);
    auto t1 = std::chrono::steady_clock::now();
    std::printf("rep %d crout %.3f s m=%lld nnzL=%lld nnzU=%lld nnzS=%lld\n",
                r, std::chrono::duration<double>(t1 - t0).count(),
                ht_res_m(h), ht_res_nnz(h, 0), ht_res_nnz(h, 1),
                ht_res_nnz(h, 2));
    std::fflush(stdout);
    ht_res_free(h);
  }
  return 0;
}
