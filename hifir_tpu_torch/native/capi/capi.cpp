// libhifir_tpu C ABI implementation for hifir_tpu_torch.
//
// The port's copy of hifir_tpu/native/capi/capi.cpp.  Parity surface for
// the reference compiled runtime (libhifir/src/libhifir.cpp): handle-based
// matrices + preconditioners in d/s/z/c precisions with mixed sd/cz
// appliers.  Instead of instantiating C++ templates per precision, this
// library embeds a CPython interpreter and dispatches to
// hifir_tpu_torch.capi_bridge, so C and Fortran callers get the framework's
// host factorize and solves behind a plain C ABI.  All Python calls are
// GIL-guarded; the interpreter starts lazily on first use (or explicitly
// via lhfInitialize).  The version triple comes from hifir_tpu_torch/
// version.py through the LHF_VERSION_* macros that native/build.py passes.

#include "libhifir_tpu.h"

#include <Python.h>

#include <cstdarg>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#if !defined(LHF_VERSION_MAJOR) || !defined(LHF_VERSION_MINOR) || \
    !defined(LHF_VERSION_PATCH)
#error "build with -DLHF_VERSION_{MAJOR,MINOR,PATCH} (native/build.py)"
#endif

namespace {

std::mutex g_mu;
PyObject* g_bridge = nullptr;
PyThreadState* g_main_ts = nullptr;
std::string g_err = "";

// resolve an executable name against PATH (PyConfig wants a real path for
// venv discovery: pyvenv.cfg lives next to the interpreter binary)
std::string resolve_python() {
  const char* env = std::getenv("LHF_PYTHON");
  if (env && *env) return env;
  // an activated virtual environment's interpreter first: the bridge
  // imports torch, which a system interpreter may lack
  const char* venv = std::getenv("VIRTUAL_ENV");
  if (venv && *venv) {
    const std::string exe = std::string(venv) + "/bin/python3";
    FILE* f = std::fopen(exe.c_str(), "rb");
    if (f) {
      std::fclose(f);
      return exe;
    }
  }
  const char* cands[] = {"/usr/local/bin/python3", "/usr/bin/python3"};
  for (const char* c : cands) {
    FILE* f = std::fopen(c, "rb");
    if (f) {
      std::fclose(f);
      return c;
    }
  }
  return "python3";
}

void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* msg = PyUnicode_AsUTF8(s);
      if (msg) g_err = msg;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

bool ensure_python() {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_bridge) return true;
  if (!Py_IsInitialized()) {
    PyConfig cfg;
    PyConfig_InitPythonConfig(&cfg);
    const std::string exe = resolve_python();
    PyConfig_SetBytesString(&cfg, &cfg.program_name, exe.c_str());
    PyStatus st = Py_InitializeFromConfig(&cfg);
    PyConfig_Clear(&cfg);
    if (PyStatus_Exception(st)) {
      g_err = st.err_msg ? st.err_msg : "python initialization failed";
      return false;
    }
    // release the GIL acquired by initialization; all entry points use
    // PyGILState_Ensure/Release pairs from here on
    g_main_ts = PyEval_SaveThread();
  }
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("hifir_tpu_torch.capi_bridge");
  if (!mod) {
    capture_py_error();
    PyErr_Clear();
    PyGILState_Release(gs);
    return false;
  }
  g_bridge = mod;  // owned forever
  PyGILState_Release(gs);
  return true;
}

// call a bridge function returning an int status / integer value
long long call_i(const char* fn, const char* fmt, ...) {
  if (!ensure_python()) return (long long)LHF_HIFIR_ERROR;
  PyGILState_STATE gs = PyGILState_Ensure();
  long long out = (long long)LHF_HIFIR_ERROR;
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (f) {
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    if (args) {
      PyObject* r = PyObject_CallObject(f, args);
      Py_DECREF(args);
      if (r) {
        if (PyLong_Check(r)) out = PyLong_AsLongLong(r);
        Py_DECREF(r);
      } else {
        capture_py_error();
        PyErr_Clear();
      }
    }
    Py_DECREF(f);
  } else {
    capture_py_error();
    PyErr_Clear();
  }
  PyGILState_Release(gs);
  return out;
}

size_t itemsize_of(int dtype) {
  switch (dtype) {
    case 0: return 8;   // f64
    case 1: return 4;   // f32
    case 2: return 16;  // c128
    default: return 8;  // c64
  }
}

struct MatrixAny {
  int dtype;     // 0 d, 1 s, 2 z, 3 c
  int rowmajor;
  int64_t n = 0;
  std::vector<LhfIndPtr> indptr;
  std::vector<LhfInt> indices;
  std::vector<unsigned char> vals;  // raw typed storage
  // zero-copy wrap mode (ref lhf?WrapMatrix / Array DATA_WRAP semantics,
  // ds/Array.hpp:60-62): the handle borrows the user's arrays, so a later
  // Setup reads their CURRENT contents
  bool wrapped = false;
  const LhfIndPtr* w_ip = nullptr;
  const LhfInt* w_ind = nullptr;
  const void* w_v = nullptr;
  const LhfIndPtr* ip() const {
    return wrapped ? w_ip : (indptr.empty() ? nullptr : indptr.data());
  }
  const LhfInt* ind() const {
    return wrapped ? w_ind : (indices.empty() ? nullptr : indices.data());
  }
  const void* v() const {
    return wrapped ? w_v : (vals.empty() ? nullptr : (const void*)vals.data());
  }
  int64_t nnz() const {
    const LhfIndPtr* p = ip();
    return p ? (int64_t)p[n] : 0;
  }
  void assign(size_t n_, const LhfIndPtr* ipp, const LhfInt* ind_,
              const void* v_) {
    wrapped = false;
    n = (int64_t)n_;
    if (ipp) {
      indptr.assign(ipp, ipp + n + 1);
      const size_t nz = (size_t)indptr.back();
      if (ind_) indices.assign(ind_, ind_ + nz);
      if (v_) {
        const unsigned char* b = (const unsigned char*)v_;
        vals.assign(b, b + nz * itemsize_of(dtype));
      }
    } else {
      indptr.assign(n + 1, 0);
    }
  }
  void wrap(size_t n_, const LhfIndPtr* ipp, const LhfInt* ind_,
            const void* v_) {
    wrapped = true;
    n = (int64_t)n_;
    w_ip = ipp;
    w_ind = ind_;
    w_v = v_;
    indptr.clear();
    indices.clear();
    vals.clear();
  }
};

struct HifAny {
  long long handle = -1;  // python-side capi handle
  int dtype;              // vector dtype code of the plain appliers
  int64_t n = 0;          // system size once set up
};

MatrixAny* make_matrix(int dtype, int is_rowmajor, size_t n,
                       const LhfIndPtr* indptr, const LhfInt* indices,
                       const void* vals) {
  auto* m = new MatrixAny();
  m->dtype = dtype;
  m->rowmajor = is_rowmajor;
  m->assign(n, indptr, indices, vals);
  return m;
}

const char* precision_of(int dtype) {
  // s/c store the factorization single-precision (ref HIF<float>); the
  // mixed appliers (sd/cz) reuse the same handle with double vectors
  return (dtype == 1 || dtype == 3) ? "single" : "double";
}

int setup_impl(HifAny* h, const MatrixAny* A, const MatrixAny* S,
               const double params[]);

HifAny* make_hif(int dtype, const MatrixAny* A, const MatrixAny* S,
                 const double params[]) {
  auto* h = new HifAny();
  h->dtype = dtype;
  h->handle = call_i("create", "(s)", precision_of(dtype));
  if (h->handle < 0) return h;  // error recorded
  if (A || S) {
    LhfStatus st = (LhfStatus)setup_impl(h, A, S, params);
    (void)st;  // reference lhf?Create has no status channel either
  }
  return h;
}

int setup_impl(HifAny* h, const MatrixAny* A, const MatrixAny* S,
               const double params[]) {
  if (!h || h->handle < 0) return LHF_NULL_OBJ;
  const MatrixAny* any = S ? S : A;
  if (!any) return LHF_NULL_OBJ;
  h->n = any->n;
  auto addr = [](const void* p) { return (long long)(intptr_t)p; };
  return (int)call_i(
      "setup", "(LLLLLLLLLLLiiL)", h->handle,
      (long long)(A ? A->n : 0), addr(A ? A->ip() : nullptr),
      addr(A ? A->ind() : nullptr),
      addr(A ? A->v() : nullptr), (long long)(A ? A->nnz() : 0),
      (long long)(S ? S->n : 0), addr(S ? S->ip() : nullptr),
      addr(S ? S->ind() : nullptr),
      addr(S ? S->v() : nullptr), (long long)(S ? S->nnz() : 0),
      any->rowmajor, any->dtype, addr(params));
}

int update_impl(HifAny* h, const MatrixAny* A) {
  if (!h || h->handle < 0 || !A) return LHF_NULL_OBJ;
  auto addr = [](const void* p) { return (long long)(intptr_t)p; };
  return (int)call_i("update", "(LLLLLLii)", h->handle, (long long)A->n,
                     addr(A->ip()), addr(A->ind()),
                     addr(A->v()), (long long)A->nnz(), A->rowmajor,
                     A->dtype);
}

int apply_impl(const HifAny* h, int op, const void* b, int nirs,
               const double* betas, int rank, void* x, int* ir_status,
               int vec_dtype) {
  if (!h || h->handle < 0) return LHF_NULL_OBJ;
  auto addr = [](const void* p) { return (long long)(intptr_t)p; };
  return (int)call_i("apply", "(LiLLiLiLLi)", h->handle, op, addr(b),
                     (long long)h->n, nirs, addr(betas), rank, addr(x),
                     addr(ir_status), vec_dtype);
}

int solve_mrhs_impl(const HifAny* h, const void* B, int nrhs, void* X,
                    int trans, int vec_dtype) {
  // extension over the reference ABI (its prec_solve_mrhs is C++-only,
  // ref prec_solve.hpp:428): B/X are nrhs consecutive length-n vectors
  // (column-major n x nrhs)
  if (!h || h->handle < 0) return LHF_NULL_OBJ;
  if (!B || !X || nrhs <= 0) return LHF_MISMATCHED_SIZES;
  auto addr = [](const void* p) { return (long long)(intptr_t)p; };
  return (int)call_i("solve_mrhs", "(LLLiiiLi)", h->handle, (long long)h->n,
                     addr(B), nrhs, trans, -2 /*LHF_DEFAULT_RANK*/, addr(X),
                     vec_dtype);
}

int stats_impl(const HifAny* h, size_t stats[9]) {
  if (!h || h->handle < 0) return LHF_NULL_OBJ;
  auto addr = [](const void* p) { return (long long)(intptr_t)p; };
  return (int)call_i("get_stats", "(LL)", h->handle, addr(stats));
}

size_t size_query(const HifAny* h, int what) {
  if (!h || h->handle < 0) return 0;
  long long v = call_i("get_size_query", "(Li)", h->handle, what);
  return v < 0 ? 0 : (size_t)v;
}

int read_sparse_impl(const char* fname, MatrixAny* m) {
  if (!m) return LHF_NULL_OBJ;
  if (!ensure_python()) return LHF_HIFIR_ERROR;
  PyGILState_STATE gs = PyGILState_Ensure();
  int status = LHF_HIFIR_ERROR;
  PyObject* r =
      PyObject_CallMethod(g_bridge, "read_sparse", "(si)", fname, m->dtype);
  if (r) {
    if (PyTuple_Check(r) && PyTuple_Size(r) == 4) {
      long long n = PyLong_AsLongLong(PyTuple_GetItem(r, 0));
      char* p = nullptr;
      Py_ssize_t len = 0;
      m->n = n;
      PyBytes_AsStringAndSize(PyTuple_GetItem(r, 1), &p, &len);
      m->indptr.assign((LhfIndPtr*)p, (LhfIndPtr*)(p + len));
      PyBytes_AsStringAndSize(PyTuple_GetItem(r, 2), &p, &len);
      m->indices.assign((LhfInt*)p, (LhfInt*)(p + len));
      PyBytes_AsStringAndSize(PyTuple_GetItem(r, 3), &p, &len);
      m->vals.assign((unsigned char*)p, (unsigned char*)p + len);
      m->rowmajor = 1;
      status = LHF_SUCCESS;
    } else if (PyLong_Check(r)) {
      status = (int)PyLong_AsLong(r);
    }
    Py_DECREF(r);
  } else {
    capture_py_error();
    PyErr_Clear();
  }
  PyGILState_Release(gs);
  return status;
}

}  // namespace

extern "C" {

LhfStatus lhfSetDefaultParams(double params[]) {
  return (LhfStatus)call_i("default_params", "(L)",
                           (long long)(intptr_t)params);
}

LhfStatus lhfSetDroptol(const double droptol, double params[]) {
  if (!params) return LHF_NULL_OBJ;
  params[LHF_DROPTOL_L] = params[LHF_DROPTOL_U] = droptol;
  return LHF_SUCCESS;
}

LhfStatus lhfSetAlpha(const double alpha, double params[]) {
  if (!params) return LHF_NULL_OBJ;
  params[LHF_ALPHA_L] = params[LHF_ALPHA_U] = alpha;
  return LHF_SUCCESS;
}

LhfStatus lhfSetKappa(const double kappa, double params[]) {
  if (!params) return LHF_NULL_OBJ;
  params[LHF_COND_D] = params[LHF_COND] = kappa;
  return LHF_SUCCESS;
}

void lhfEnableWarning(void) { (void)call_i("set_warning", "(i)", 1); }
void lhfDisableWarning(void) { (void)call_i("set_warning", "(i)", 0); }

void lhfGetVersions(int versions[3]) {
  versions[0] = LHF_VERSION_MAJOR;
  versions[1] = LHF_VERSION_MINOR;
  versions[2] = LHF_VERSION_PATCH;
}

const char* lhfGetErrorMsg(void) {
  if (!g_bridge) return g_err.c_str();
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_bridge, "get_error_msg", nullptr);
  if (r) {
    const char* msg = PyUnicode_AsUTF8(r);
    if (msg && *msg) g_err = msg;
    Py_DECREF(r);
  } else {
    PyErr_Clear();
  }
  PyGILState_Release(gs);
  return g_err.c_str();
}

LhfStatus lhfInitialize(void) {
  return ensure_python() ? LHF_SUCCESS : LHF_HIFIR_ERROR;
}

LhfStatus lhfFinalize(void) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!Py_IsInitialized()) return LHF_SUCCESS;
  if (g_main_ts) PyEval_RestoreThread(g_main_ts);
  Py_XDECREF(g_bridge);
  g_bridge = nullptr;
  g_main_ts = nullptr;
  return Py_FinalizeEx() == 0 ? LHF_SUCCESS : LHF_HIFIR_ERROR;
}

LhfStatus lhfQueryMmFile(const char* fname, int* is_sparse, int* is_real,
                         size_t* nrows, size_t* ncols, size_t* nnz) {
  int64_t out[5] = {0, 0, 0, 0, 0};
  int st = (int)call_i("query_mm_file", "(sL)", fname,
                       (long long)(intptr_t)out);
  if (st != LHF_SUCCESS) return (LhfStatus)st;
  if (is_sparse) *is_sparse = (int)out[0];
  if (is_real) *is_real = (int)out[1];
  if (nrows) *nrows = (size_t)out[2];
  if (ncols) *ncols = (size_t)out[3];
  if (nnz) *nnz = (size_t)out[4];
  return LHF_SUCCESS;
}

// X-macro instantiation of the four precisions.  tag: d/s/z/c; code: the
// bridge dtype code; ctype: the C scalar element type (complex passed as
// interleaved re/im pairs of the base real type).
#define LHF_DEFINE_PRECISION(tag, code, ctype)                                \
  Lhf##tag##MatrixHdl lhf##tag##CreateMatrix(                                 \
      int is_rowmajor, size_t n, const LhfIndPtr* indptr,                     \
      const LhfInt* indices, const ctype* vals) {                             \
    return (Lhf##tag##MatrixHdl)make_matrix(code, is_rowmajor, n, indptr,     \
                                            indices, vals);                   \
  }                                                                           \
  LhfStatus lhf##tag##WrapMatrix(Lhf##tag##MatrixHdl mat, const size_t n,    \
                                 const LhfIndPtr* indptr,                     \
                                 const LhfInt* indices, const ctype* vals) {  \
    /* zero-copy borrow (ref lhf?WrapMatrix): Setup reads the arrays'       \
       CURRENT contents at setup time */                                     \
    if (!mat || !indptr) return LHF_NULL_OBJ;                                \
    ((MatrixAny*)mat)->wrap(n, indptr, indices, vals);                       \
    return LHF_SUCCESS;                                                      \
  }                                                                           \
  LhfStatus lhf##tag##DestroyMatrix(Lhf##tag##MatrixHdl mat) {                \
    if (!mat) return LHF_NULL_OBJ;                                            \
    delete (MatrixAny*)mat;                                                   \
    return LHF_SUCCESS;                                                       \
  }                                                                           \
  size_t lhf##tag##GetMatrixSize(const Lhf##tag##MatrixHdl mat) {             \
    return mat ? (size_t)((const MatrixAny*)mat)->n : 0;                      \
  }                                                                           \
  size_t lhf##tag##GetMatrixNnz(const Lhf##tag##MatrixHdl mat) {              \
    return mat ? (size_t)((const MatrixAny*)mat)->nnz() : 0;                  \
  }                                                                           \
  LhfStatus lhf##tag##ReadSparse(const char* fname,                           \
                                 Lhf##tag##MatrixHdl mat) {                   \
    return (LhfStatus)read_sparse_impl(fname, (MatrixAny*)mat);               \
  }                                                                           \
  LhfStatus lhf##tag##ReadVector(const char* fname, size_t n, ctype* v) {     \
    return (LhfStatus)call_i("read_vector", "(sLLi)", fname, (long long)n,    \
                             (long long)(intptr_t)v, code);                   \
  }                                                                           \
  Lhf##tag##HifHdl lhf##tag##Create(const Lhf##tag##MatrixHdl A,              \
                                    const Lhf##tag##MatrixHdl S,              \
                                    const double params[]) {                  \
    return (Lhf##tag##HifHdl)make_hif(code, (const MatrixAny*)A,              \
                                      (const MatrixAny*)S, params);           \
  }                                                                           \
  LhfStatus lhf##tag##Destroy(Lhf##tag##HifHdl hif) {                         \
    if (!hif) return LHF_NULL_OBJ;                                            \
    HifAny* h = (HifAny*)hif;                                                 \
    if (h->handle >= 0) call_i("destroy", "(L)", h->handle);                  \
    delete h;                                                                 \
    return LHF_SUCCESS;                                                       \
  }                                                                           \
  LhfStatus lhf##tag##Setup(Lhf##tag##HifHdl hif, const Lhf##tag##MatrixHdl A,\
                            const Lhf##tag##MatrixHdl S,                      \
                            const double params[]) {                          \
    if (!A && !S) return LHF_NULL_OBJ;                                        \
    return (LhfStatus)setup_impl((HifAny*)hif, (const MatrixAny*)A,           \
                                 (const MatrixAny*)S, params);                \
  }                                                                           \
  LhfStatus lhf##tag##Update(Lhf##tag##HifHdl hif,                            \
                             const Lhf##tag##MatrixHdl A) {                   \
    return (LhfStatus)update_impl((HifAny*)hif, (const MatrixAny*)A);         \
  }                                                                           \
  LhfStatus lhf##tag##Refactorize(Lhf##tag##HifHdl hif,                       \
                                  const Lhf##tag##MatrixHdl S,                \
                                  const double params[]) {                    \
    return (LhfStatus)setup_impl((HifAny*)hif, nullptr,                       \
                                 (const MatrixAny*)S, params);                \
  }                                                                           \
  LhfStatus lhf##tag##Apply(const Lhf##tag##HifHdl hif, LhfOperationType op,  \
                            const ctype* b, int nirs, const double* betas,    \
                            int rank, ctype* x, int* ir_status) {             \
    return (LhfStatus)apply_impl((const HifAny*)hif, (int)op, b, nirs, betas, \
                                 rank, x, ir_status, code);                   \
  }                                                                           \
  LhfStatus lhf##tag##Solve(const Lhf##tag##HifHdl hif, const ctype* b,       \
                            ctype* x) {                                       \
    return lhf##tag##Apply(hif, LHF_S, b, 1, nullptr, LHF_DEFAULT_RANK, x,    \
                           nullptr);                                          \
  }                                                                           \
  LhfStatus lhf##tag##SolveMrhs(const Lhf##tag##HifHdl hif, const ctype* B,   \
                                int nrhs, ctype* X) {                         \
    return (LhfStatus)solve_mrhs_impl((const HifAny*)hif, B, nrhs, X, 0,     \
                                      code);                                 \
  }                                                                           \
  LhfStatus lhf##tag##GetStats(const Lhf##tag##HifHdl hif, size_t stats[9]) { \
    return (LhfStatus)stats_impl((const HifAny*)hif, stats);                  \
  }                                                                           \
  size_t lhf##tag##GetNnz(const Lhf##tag##HifHdl hif) {                       \
    return size_query((const HifAny*)hif, 0);                                 \
  }                                                                           \
  size_t lhf##tag##GetLevels(const Lhf##tag##HifHdl hif) {                    \
    return size_query((const HifAny*)hif, 1);                                 \
  }                                                                           \
  size_t lhf##tag##GetSchurSize(const Lhf##tag##HifHdl hif) {                 \
    return size_query((const HifAny*)hif, 2);                                 \
  }                                                                           \
  size_t lhf##tag##GetSchurRank(const Lhf##tag##HifHdl hif) {                 \
    return size_query((const HifAny*)hif, 3);                                 \
  }

LHF_DEFINE_PRECISION(d, 0, double)
LHF_DEFINE_PRECISION(s, 1, float)
LHF_DEFINE_PRECISION(z, 2, double)
LHF_DEFINE_PRECISION(c, 3, float)

#undef LHF_DEFINE_PRECISION

// mixed precision: single-precision preconditioner inside a double-precision
// system (ref lhfsd*/lhfcz*, libhifir.h:1231-1282).  The s/c handle already
// stores M in single precision; these entry points take double vectors and
// a double operator so iterative refinement accumulates in f64.
LhfStatus lhfsdUpdate(LhfsHifHdl hif, const LhfdMatrixHdl A) {
  return (LhfStatus)update_impl((HifAny*)hif, (const MatrixAny*)A);
}

LhfStatus lhfsdApply(const LhfsHifHdl hif, LhfOperationType op,
                     const double* b, int nirs, const double* betas, int rank,
                     double* x, int* ir_status) {
  return (LhfStatus)apply_impl((const HifAny*)hif, (int)op, b, nirs, betas,
                               rank, x, ir_status, /*vec f64*/ 0);
}

LhfStatus lhfsdSolve(const LhfsHifHdl hif, const double* b, double* x) {
  return lhfsdApply(hif, LHF_S, b, 1, nullptr, LHF_DEFAULT_RANK, x, nullptr);
}

LhfStatus lhfczUpdate(LhfcHifHdl hif, const LhfzMatrixHdl A) {
  return (LhfStatus)update_impl((HifAny*)hif, (const MatrixAny*)A);
}

LhfStatus lhfczApply(const LhfcHifHdl hif, LhfOperationType op,
                     const double* b, int nirs, const double* betas, int rank,
                     double* x, int* ir_status) {
  return (LhfStatus)apply_impl((const HifAny*)hif, (int)op, b, nirs, betas,
                               rank, x, ir_status, /*vec c128*/ 2);
}

LhfStatus lhfczSolve(const LhfcHifHdl hif, const double* b, double* x) {
  return lhfczApply(hif, LHF_S, b, 1, nullptr, LHF_DEFAULT_RANK, x, nullptr);
}

}  // extern "C"
