/*
 * libhifir_tpu — compiled C ABI for the hifir_tpu_torch framework.
 *
 * The port's copy of hifir_tpu/native/capi/libhifir_tpu.h: the same file
 * name and the same lhf* symbols, so that a C program written against the
 * JAX package's shim compiles unchanged against this one.
 *
 * Behavioral-parity surface for the reference C runtime library
 * (libhifir/include/libhifir.h:97-1282): handle-based sparse
 * matrices and HIF preconditioners in four precisions (d/s/z/c) plus the
 * mixed-precision appliers (sd, cz), a double[] parameter array addressed by
 * the LHF_* enum, the four apply operation modes, and MatrixMarket IO.
 *
 * Implementation: this library embeds a CPython interpreter and dispatches
 * to hifir_tpu_torch.capi (the Python parity layer); the numerics run in the
 * framework's native host kernels.  The interpreter imports torch, so set
 * LHF_PYTHON to the python executable of the environment whose
 * site-packages hold torch and numpy (default: $VIRTUAL_ENV/bin/python3,
 * then /usr/local/bin/python3, then /usr/bin/python3, the first that
 * exists), and PYTHONPATH to the checkout if the package is not installed.
 * Build it with hifir_tpu_torch.native.build.build_capi().
 *
 * Callable from C, Fortran (ISO_C_BINDING), or any FFI.
 */
#ifndef LIBHIFIR_TPU_H
#define LIBHIFIR_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int32_t LhfInt;      /* index type of sparse matrices */
typedef int64_t LhfIndPtr;   /* row/column start pointer type */

/* parameter array positions (ref libhifir.h:97-116) */
enum {
  LHF_DROPTOL_L = 0,
  LHF_DROPTOL_U,
  LHF_COND_D,
  LHF_COND,
  LHF_ALPHA_L,
  LHF_ALPHA_U,
  LHF_VERBOSE,
  LHF_REORDER,
  LHF_SYMMPRELVLS,
  LHF_THREADS,
  LHF_RRQR_COND,
  LHF_PIVOT,
  LHF_BETA,
  LHF_ISSYMM,
  LHF_NOPRE,
  LHF_NZP_THRES,
  LHF_DENSE_THRES,
  LHF_NUMBER_PARAMS
};

enum {
  LHF_VERBOSE_NULL = 0,
  LHF_VERBOSE_INFO = 1,
  LHF_VERBOSE_PRE = 2,
  LHF_VERBOSE_FAC = 4,
  LHF_VERBOSE_PRE_TIME = 8,
  LHF_VERBOSE_MEM = 16
};

enum { LHF_REORDER_OFF = 0, LHF_REORDER_AUTO, LHF_REORDER_AMD, LHF_REORDER_RCM };
enum { LHF_PIVOTING_OFF = 0, LHF_PIVOTING_ON, LHF_PIVOTING_AUTO };

typedef enum LhfStatus {
  LHF_SUCCESS = 0,
  LHF_NULL_OBJ,
  LHF_MISMATCHED_SIZES,
  LHF_BAD_PREC,
  LHF_HIFIR_ERROR
} LhfStatus;

typedef enum LhfOperationType {
  LHF_S = 0, /* x = M^{-1} b (optionally with inner iterative refinement) */
  LHF_SH,    /* x = M^{-H} b */
  LHF_M,     /* x = M b */
  LHF_MH     /* x = M^{H} b */
} LhfOperationType;

#define LHF_DEFAULT_RANK (-2)

typedef struct LhfdMatrix* LhfdMatrixHdl;
typedef struct LhfsMatrix* LhfsMatrixHdl;
typedef struct LhfzMatrix* LhfzMatrixHdl;
typedef struct LhfcMatrix* LhfcMatrixHdl;
typedef struct LhfdHif* LhfdHifHdl;
typedef struct LhfsHif* LhfsHifHdl;
typedef struct LhfzHif* LhfzHifHdl;
typedef struct LhfcHif* LhfcHifHdl;

/* ---- library-wide ---- */
LhfStatus lhfSetDefaultParams(double params[]);

/* unified parameter helpers (ref libhifir.h:270-286) */
LhfStatus lhfSetDroptol(const double droptol, double params[]);
LhfStatus lhfSetAlpha(const double alpha, double params[]);
LhfStatus lhfSetKappa(const double kappa, double params[]);

/* toggle hifir_tpu_torch warnings (ref libhifir.h:245-250) */
void lhfEnableWarning(void);
void lhfDisableWarning(void);
void lhfGetVersions(int versions[3]);
const char* lhfGetErrorMsg(void);
/* Explicit interpreter lifecycle (optional: every entry point initializes
 * lazily).  lhfFinalize releases the embedded interpreter. */
LhfStatus lhfInitialize(void);
LhfStatus lhfFinalize(void);

/* ---- MatrixMarket IO ---- */
LhfStatus lhfQueryMmFile(const char* fname, int* is_sparse, int* is_real,
                         size_t* nrows, size_t* ncols, size_t* nnz);

/* ---- double precision ---- */
LhfdMatrixHdl lhfdCreateMatrix(int is_rowmajor, size_t n,
                               const LhfIndPtr* indptr, const LhfInt* indices,
                               const double* vals);
LhfStatus lhfdWrapMatrix(LhfdMatrixHdl mat, const size_t n,
                        const LhfIndPtr* indptr, const LhfInt* indices,
                        const double* vals);
LhfStatus lhfdDestroyMatrix(LhfdMatrixHdl mat);
size_t lhfdGetMatrixSize(const LhfdMatrixHdl mat);
size_t lhfdGetMatrixNnz(const LhfdMatrixHdl mat);
LhfStatus lhfdReadSparse(const char* fname, LhfdMatrixHdl mat);
LhfStatus lhfdReadVector(const char* fname, size_t n, double* v);

LhfdHifHdl lhfdCreate(const LhfdMatrixHdl A, const LhfdMatrixHdl S,
                      const double params[]);
LhfStatus lhfdDestroy(LhfdHifHdl hif);
LhfStatus lhfdSetup(LhfdHifHdl hif, const LhfdMatrixHdl A,
                    const LhfdMatrixHdl S, const double params[]);
LhfStatus lhfdUpdate(LhfdHifHdl hif, const LhfdMatrixHdl A);
LhfStatus lhfdRefactorize(LhfdHifHdl hif, const LhfdMatrixHdl S,
                          const double params[]);
LhfStatus lhfdApply(const LhfdHifHdl hif, LhfOperationType op,
                    const double* b, int nirs, const double* betas, int rank,
                    double* x, int* ir_status);
LhfStatus lhfdSolve(const LhfdHifHdl hif, const double* b, double* x);
/* extension over the reference ABI: batched multi-RHS M-solve; B and X are
   nrhs consecutive length-n vectors (column-major n x nrhs) */
LhfStatus lhfdSolveMrhs(const LhfdHifHdl hif, const double* B, int nrhs,
                       double* X);
LhfStatus lhfdGetStats(const LhfdHifHdl hif, size_t stats[9]);
size_t lhfdGetNnz(const LhfdHifHdl hif);
size_t lhfdGetLevels(const LhfdHifHdl hif);
size_t lhfdGetSchurSize(const LhfdHifHdl hif);
size_t lhfdGetSchurRank(const LhfdHifHdl hif);

/* ---- single precision ---- */
LhfsMatrixHdl lhfsCreateMatrix(int is_rowmajor, size_t n,
                               const LhfIndPtr* indptr, const LhfInt* indices,
                               const float* vals);
LhfStatus lhfsWrapMatrix(LhfsMatrixHdl mat, const size_t n,
                        const LhfIndPtr* indptr, const LhfInt* indices,
                        const float* vals);
LhfStatus lhfsDestroyMatrix(LhfsMatrixHdl mat);
size_t lhfsGetMatrixSize(const LhfsMatrixHdl mat);
size_t lhfsGetMatrixNnz(const LhfsMatrixHdl mat);
LhfStatus lhfsReadSparse(const char* fname, LhfsMatrixHdl mat);
LhfStatus lhfsReadVector(const char* fname, size_t n, float* v);

LhfsHifHdl lhfsCreate(const LhfsMatrixHdl A, const LhfsMatrixHdl S,
                      const double params[]);
LhfStatus lhfsDestroy(LhfsHifHdl hif);
LhfStatus lhfsSetup(LhfsHifHdl hif, const LhfsMatrixHdl A,
                    const LhfsMatrixHdl S, const double params[]);
LhfStatus lhfsUpdate(LhfsHifHdl hif, const LhfsMatrixHdl A);
LhfStatus lhfsRefactorize(LhfsHifHdl hif, const LhfsMatrixHdl S,
                          const double params[]);
LhfStatus lhfsApply(const LhfsHifHdl hif, LhfOperationType op, const float* b,
                    int nirs, const double* betas, int rank, float* x,
                    int* ir_status);
LhfStatus lhfsSolve(const LhfsHifHdl hif, const float* b, float* x);
/* extension over the reference ABI: batched multi-RHS M-solve; B and X are
   nrhs consecutive length-n vectors (column-major n x nrhs) */
LhfStatus lhfsSolveMrhs(const LhfsHifHdl hif, const float* B, int nrhs,
                       float* X);
LhfStatus lhfsGetStats(const LhfsHifHdl hif, size_t stats[9]);
size_t lhfsGetNnz(const LhfsHifHdl hif);
size_t lhfsGetLevels(const LhfsHifHdl hif);
size_t lhfsGetSchurSize(const LhfsHifHdl hif);
size_t lhfsGetSchurRank(const LhfsHifHdl hif);

/* ---- double-precision complex (interleaved re/im, C99 layout) ---- */
LhfzMatrixHdl lhfzCreateMatrix(int is_rowmajor, size_t n,
                               const LhfIndPtr* indptr, const LhfInt* indices,
                               const double* vals);
LhfStatus lhfzWrapMatrix(LhfzMatrixHdl mat, const size_t n,
                        const LhfIndPtr* indptr, const LhfInt* indices,
                        const double* vals);
LhfStatus lhfzDestroyMatrix(LhfzMatrixHdl mat);
size_t lhfzGetMatrixSize(const LhfzMatrixHdl mat);
size_t lhfzGetMatrixNnz(const LhfzMatrixHdl mat);
LhfStatus lhfzReadSparse(const char* fname, LhfzMatrixHdl mat);
LhfStatus lhfzReadVector(const char* fname, size_t n, double* v);

LhfzHifHdl lhfzCreate(const LhfzMatrixHdl A, const LhfzMatrixHdl S,
                      const double params[]);
LhfStatus lhfzDestroy(LhfzHifHdl hif);
LhfStatus lhfzSetup(LhfzHifHdl hif, const LhfzMatrixHdl A,
                    const LhfzMatrixHdl S, const double params[]);
LhfStatus lhfzUpdate(LhfzHifHdl hif, const LhfzMatrixHdl A);
LhfStatus lhfzRefactorize(LhfzHifHdl hif, const LhfzMatrixHdl S,
                          const double params[]);
LhfStatus lhfzApply(const LhfzHifHdl hif, LhfOperationType op,
                    const double* b, int nirs, const double* betas, int rank,
                    double* x, int* ir_status);
LhfStatus lhfzSolve(const LhfzHifHdl hif, const double* b, double* x);
/* extension over the reference ABI: batched multi-RHS M-solve; B and X are
   nrhs consecutive length-n vectors (column-major n x nrhs) */
LhfStatus lhfzSolveMrhs(const LhfzHifHdl hif, const double* B, int nrhs,
                       double* X);
LhfStatus lhfzGetStats(const LhfzHifHdl hif, size_t stats[9]);
size_t lhfzGetNnz(const LhfzHifHdl hif);
size_t lhfzGetLevels(const LhfzHifHdl hif);
size_t lhfzGetSchurSize(const LhfzHifHdl hif);
size_t lhfzGetSchurRank(const LhfzHifHdl hif);

/* ---- single-precision complex ---- */
LhfcMatrixHdl lhfcCreateMatrix(int is_rowmajor, size_t n,
                               const LhfIndPtr* indptr, const LhfInt* indices,
                               const float* vals);
LhfStatus lhfcWrapMatrix(LhfcMatrixHdl mat, const size_t n,
                        const LhfIndPtr* indptr, const LhfInt* indices,
                        const float* vals);
LhfStatus lhfcDestroyMatrix(LhfcMatrixHdl mat);
size_t lhfcGetMatrixSize(const LhfcMatrixHdl mat);
size_t lhfcGetMatrixNnz(const LhfcMatrixHdl mat);
LhfStatus lhfcReadSparse(const char* fname, LhfcMatrixHdl mat);
LhfStatus lhfcReadVector(const char* fname, size_t n, float* v);

LhfcHifHdl lhfcCreate(const LhfcMatrixHdl A, const LhfcMatrixHdl S,
                      const double params[]);
LhfStatus lhfcDestroy(LhfcHifHdl hif);
LhfStatus lhfcSetup(LhfcHifHdl hif, const LhfcMatrixHdl A,
                    const LhfcMatrixHdl S, const double params[]);
LhfStatus lhfcUpdate(LhfcHifHdl hif, const LhfcMatrixHdl A);
LhfStatus lhfcRefactorize(LhfcHifHdl hif, const LhfcMatrixHdl S,
                          const double params[]);
LhfStatus lhfcApply(const LhfcHifHdl hif, LhfOperationType op, const float* b,
                    int nirs, const double* betas, int rank, float* x,
                    int* ir_status);
LhfStatus lhfcSolve(const LhfcHifHdl hif, const float* b, float* x);
/* extension over the reference ABI: batched multi-RHS M-solve; B and X are
   nrhs consecutive length-n vectors (column-major n x nrhs) */
LhfStatus lhfcSolveMrhs(const LhfcHifHdl hif, const float* B, int nrhs,
                       float* X);
LhfStatus lhfcGetStats(const LhfcHifHdl hif, size_t stats[9]);
size_t lhfcGetNnz(const LhfcHifHdl hif);
size_t lhfcGetLevels(const LhfcHifHdl hif);
size_t lhfcGetSchurSize(const LhfcHifHdl hif);
size_t lhfcGetSchurRank(const LhfcHifHdl hif);

/* ---- mixed precision: single-precision M inside a double-precision system
 * (ref lhfsd*, libhifir.h:1231-1282) and complex counterpart (lhfcz*) ---- */
LhfStatus lhfsdUpdate(LhfsHifHdl hif, const LhfdMatrixHdl A);
LhfStatus lhfsdApply(const LhfsHifHdl hif, LhfOperationType op,
                     const double* b, int nirs, const double* betas, int rank,
                     double* x, int* ir_status);
LhfStatus lhfsdSolve(const LhfsHifHdl hif, const double* b, double* x);
LhfStatus lhfczUpdate(LhfcHifHdl hif, const LhfzMatrixHdl A);
LhfStatus lhfczApply(const LhfcHifHdl hif, LhfOperationType op,
                     const double* b, int nirs, const double* betas, int rank,
                     double* x, int* ir_status);
LhfStatus lhfczSolve(const LhfcHifHdl hif, const double* b, double* x);

#ifdef __cplusplus
}
#endif

#endif /* LIBHIFIR_TPU_H */
