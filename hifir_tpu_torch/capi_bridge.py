"""In-process marshaling bridge for the compiled C ABI shim.

The port's copy of ``hifir_tpu/capi_bridge.py``, importing only the port.
The compiled library (``native/capi/capi.cpp``, built by
:func:`hifir_tpu_torch.native.build.build_capi`) embeds CPython and
calls the functions in this module with **raw addresses** (integers) of
C-side buffers; everything here wraps those addresses as numpy arrays with
``ctypes`` (zero-copy views) and forwards to :mod:`hifir_tpu_torch.capi`,
which is the behavioral-parity layer for the reference C library
(``libhifir/include/libhifir.h``).

Every function returns an ``LhfStatus`` integer (0 == success); exceptions
are caught and recorded for ``lhfGetErrorMsg``.
"""

from __future__ import annotations

import ctypes
import traceback

import numpy as np

from . import capi
from .options import Options

# LhfStatus codes (ref libhifir.h:146-153)
LHF_SUCCESS = 0
LHF_NULL_OBJ = 1
LHF_MISMATCHED_SIZES = 2
LHF_BAD_PREC = 3
LHF_HIFIR_ERROR = 4

# params array positions (ref libhifir.h:97-116) -> Options field names
_PARAM_FIELDS = (
    "tau_L", "tau_U", "kappa_d", "kappa", "alpha_L", "alpha_U", "verbose",
    "reorder", "symm_pre_lvls", "threads", "rrqr_cond", "pivot", "beta",
    "is_symm", "no_pre", "nzp_thres", "dense_thres",
)
NUMBER_PARAMS = len(_PARAM_FIELDS)

_DTYPES = {0: np.float64, 1: np.float32, 2: np.complex128, 3: np.complex64}

_last_error = ""


def get_error_msg() -> str:
    return _last_error


def _seterr(exc: BaseException) -> int:
    global _last_error
    _last_error = "".join(
        traceback.format_exception_only(type(exc), exc)).strip()
    return LHF_HIFIR_ERROR


def _view(addr: int, n: int, dtype) -> np.ndarray:
    """Zero-copy numpy view of a C buffer at ``addr`` (no ownership)."""
    dt = np.dtype(dtype)
    buf = (ctypes.c_byte * (n * dt.itemsize)).from_address(addr)
    return np.frombuffer(buf, dtype=dt)


def _params_to_options(params_addr: int) -> Options:
    opts = Options()
    if not params_addr:
        return opts
    p = _view(params_addr, NUMBER_PARAMS, np.float64)
    for i, name in enumerate(_PARAM_FIELDS):
        v = p[i]
        opts.set(name, float(v) if isinstance(getattr(opts, name), float)
                 else int(v))
    return opts


def default_params(params_addr: int) -> int:
    """Fill a C params array with the reference defaults
    (ref ``lhfSetDefaultParams``)."""
    try:
        p = _view(params_addr, NUMBER_PARAMS, np.float64)
        opts = Options()
        for i, name in enumerate(_PARAM_FIELDS):
            p[i] = float(getattr(opts, name))
        return LHF_SUCCESS
    except Exception as e:  # pragma: no cover
        return _seterr(e)


def _matrix_from_ptrs(n: int, indptr_addr: int, indices_addr: int,
                      vals_addr: int, nnz: int, is_rowmajor: int,
                      dtype_code: int):
    indptr = _view(indptr_addr, n + 1, np.int64).copy()
    indices = _view(indices_addr, nnz, np.int32).copy()
    vals = _view(vals_addr, nnz, _DTYPES[dtype_code]).copy()
    # single-precision handles (lhfs*/lhfc*) keep their native dtype end to
    # end: the host Crout/Schur kernels are instantiated for s/c (the
    # reference's HIF<float>, builder.hpp:589 + libhifir.cpp:595+)
    import scipy.sparse as sp
    if is_rowmajor:
        A = sp.csr_matrix((vals, indices, indptr), shape=(n, n))
    else:
        A = sp.csc_matrix((vals, indices, indptr), shape=(n, n)).tocsr()
    from .ds.csr import CSR
    return CSR.from_scipy(A)


def create(precision: str) -> int:
    try:
        return capi.create(precision=precision)
    except Exception as e:
        _seterr(e)
        return -1


def destroy(handle: int) -> int:
    try:
        capi.destroy(handle)
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def setup(handle: int, a_n: int, a_indptr: int, a_indices: int, a_vals: int,
          a_nnz: int, s_n: int, s_indptr: int, s_indices: int, s_vals: int,
          s_nnz: int, is_rowmajor: int, dtype_code: int,
          params_addr: int) -> int:
    """Attach A (IR operator) and S (sparsifier) and factorize S (or A when
    S is absent) — ref ``lhf?Create``/``lhf?Setup`` semantics
    (libhifir.h:611-642)."""
    try:
        st = capi._get(handle)
        if a_n:
            st["A"] = _matrix_from_ptrs(a_n, a_indptr, a_indices, a_vals,
                                        a_nnz, is_rowmajor, dtype_code)
        if s_n:
            st["S"] = _matrix_from_ptrs(s_n, s_indptr, s_indices, s_vals,
                                        s_nnz, is_rowmajor, dtype_code)
        capi.setup(handle, params=_params_to_options(params_addr))
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def update(handle: int, n: int, indptr: int, indices: int, vals: int,
           nnz: int, is_rowmajor: int, dtype_code: int) -> int:
    try:
        capi.update(handle, _matrix_from_ptrs(n, indptr, indices, vals, nnz,
                                              is_rowmajor, dtype_code))
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def apply(handle: int, op: int, b_addr: int, n: int, nirs: int,
          betas_addr: int, rank: int, x_addr: int, irstat_addr: int,
          dtype_code: int) -> int:
    """ref ``lhf?Apply`` (libhifir.h:685): op in {S, SH, M, MH}; nirs > 1
    runs inner iterative refinement, optionally beta-bounded."""
    try:
        dt = _DTYPES[dtype_code]
        b = _view(b_addr, n, dt)
        x = _view(x_addr, n, dt)
        betas = None
        if betas_addr:
            bv = _view(betas_addr, 2, np.float64)
            betas = (float(bv[0]), float(bv[1]))
        if rank == -2:  # LHF_DEFAULT_RANK
            rank = 0
        xr, iters, flag = capi.apply(handle, op, np.asarray(b), nirs=nirs,
                                     betas=betas, rank=rank)
        np.copyto(x, xr.astype(dt, copy=False))
        if irstat_addr:
            ir = _view(irstat_addr, 2, np.int32)
            ir[0] = iters
            ir[1] = flag
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def set_warning(on: int) -> int:
    """ref ``lhfEnableWarning``/``lhfDisableWarning`` (libhifir.h:245-250)."""
    try:
        from .utils.log import enable_warnings

        enable_warnings(bool(on))
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def solve_mrhs(handle: int, n: int, b_addr: int, nrhs: int, trans: int,
               rank: int, x_addr: int, dtype_code: int) -> int:
    """``lhf?SolveMrhs`` (extension; see capi.solve_mrhs): B and X are
    ``nrhs`` consecutive length-``n`` vectors (column-major n-by-nrhs)."""
    try:
        dt = _DTYPES[dtype_code]
        B = _view(b_addr, n * nrhs, dt).reshape(nrhs, n).T
        X = _view(x_addr, n * nrhs, dt).reshape(nrhs, n).T
        if rank == -2:  # LHF_DEFAULT_RANK
            rank = 0
        XR = capi.solve_mrhs(handle, np.ascontiguousarray(B),
                             trans=bool(trans), rank=rank)
        np.copyto(X, XR.astype(dt, copy=False))
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def get_stats(handle: int, stats_addr: int) -> int:
    """ref ``lhf?GetStats`` 9-slot layout (libhifir.h:716-735)."""
    try:
        out = _view(stats_addr, 9, np.uint64)
        s = capi.get_stats(handle)
        out[0] = capi.get_nnz(handle)
        out[1] = s[0]  # total deferrals
        out[2] = s[1]  # dynamic deferrals
        out[3] = s[4]  # total droppings
        out[4] = s[5]  # space droppings
        out[5] = capi.get_levels(handle)
        st = capi._get(handle)
        out[6] = st["M"].rank()
        out[7] = capi.get_schur_rank(handle)
        out[8] = capi.get_schur_size(handle)
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def get_size_query(handle: int, what: int) -> int:
    """what: 0 nnz, 1 levels, 2 schur size, 3 schur rank; -1 on error."""
    try:
        if what == 0:
            return capi.get_nnz(handle)
        if what == 1:
            return capi.get_levels(handle)
        if what == 2:
            return capi.get_schur_size(handle)
        if what == 3:
            return max(capi.get_schur_rank(handle), 0)
        return -1
    except Exception as e:
        _seterr(e)
        return -1


# ---- MatrixMarket IO (ref lhfQueryMmFile/lhf?ReadSparse/lhf?ReadVector) ----

def query_mm_file(fname: str, out_addr: int) -> int:
    """out: int64[5] = {is_sparse, is_real, nrows, ncols, nnz}."""
    try:
        from .utils import io as mmio
        out = _view(out_addr, 5, np.int64)
        info = mmio.query_mm(fname)
        out[0] = int(info["is_sparse"])
        out[1] = int(info["is_real"])
        out[2] = info["nrows"]
        out[3] = info["ncols"]
        out[4] = info["nnz"]
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)


def read_sparse(fname: str, dtype_code: int):
    """Returns (n, indptr_bytes, indices_bytes, vals_bytes) or status int."""
    try:
        from .utils import io as mmio
        A = mmio.read_mm(fname)
        vals = A.data.astype(_DTYPES[dtype_code], copy=False)
        return (int(A.nrows), A.indptr.astype(np.int64).tobytes(),
                A.indices.astype(np.int32).tobytes(), vals.tobytes())
    except Exception as e:
        return _seterr(e)


def read_vector(fname: str, n: int, v_addr: int, dtype_code: int) -> int:
    try:
        from .utils import io as mmio
        v = mmio.read_mm_vector(fname)
        if v.shape[0] != n:
            return LHF_MISMATCHED_SIZES
        dt = _DTYPES[dtype_code]
        np.copyto(_view(v_addr, n, dt), v.astype(dt, copy=False))
        return LHF_SUCCESS
    except Exception as e:
        return _seterr(e)
