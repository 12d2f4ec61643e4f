"""ctypes bridge to the port's native host library (``native/src``).

The port's copy of ``hifir_tpu/pre/_native.py``: serial matching (MC64),
orderings (AMD, RCM), permute-and-scale, the deferred Crout in s/d/c/z and
the pivoting Crout, the level scan and the host triangular solve, in C++
(the reference keeps the same algorithms in C++: ``pre/equilibrate.hpp``,
``pre/amd.hpp``, ``pre/rcm.hpp``, ``alg/factor.hpp``).
:func:`~hifir_tpu_torch.native.build.load_native` builds the library at
first use and raises if the build fails.  Every function returns what the
JAX package's does; the ones that return ``None`` without a library do so
only when :func:`_load` gives ``None``, which is how a caller (the tests,
``chip_smoke.py``'s fixture phases) runs the numpy anchors instead.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

_I64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL, name: str, restype, argtypes) -> bool:
    try:
        fn = getattr(lib, name)
    except AttributeError:
        return False
    fn.restype = restype
    fn.argtypes = argtypes
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library with its entry points bound (built at first
    use; a failed build raises)."""
    return _bound()


@functools.cache
def _bound() -> ctypes.CDLL:
    from ..native.build import load_native

    lib = load_native().lib
    c = ctypes.c_int64
    ok = _bind(lib, "ht_mc64", ctypes.c_int,
               [c, _I64, _I32, _F64, _I64, _F64, _F64])
    lib._has_amd = _bind(lib, "ht_amd", ctypes.c_int, [c, _I64, _I32, _I64])
    lib._has_rcm = _bind(lib, "ht_rcm", ctypes.c_int, [c, _I64, _I32, _I64])
    crout_sig = [c, c, _I64, _I32, _F64, _F64,
                 ctypes.c_double, ctypes.c_double, ctypes.c_double,
                 ctypes.c_double, ctypes.c_double, ctypes.c_double,
                 _I64, _I64, ctypes.c_double, ctypes.c_double, ctypes.c_int]
    crout_sig_s = ([c, c, _I64, _I32, _F32, _F32] + crout_sig[6:])
    lib._has_crout = _bind(lib, "ht_crout", ctypes.c_void_p, crout_sig)
    lib._has_crout_z = _bind(lib, "ht_crout_z", ctypes.c_void_p, crout_sig)
    lib._has_crout_s = _bind(lib, "ht_crout_s", ctypes.c_void_p, crout_sig_s)
    lib._has_crout_c = _bind(lib, "ht_crout_c", ctypes.c_void_p, crout_sig_s)
    pivot_sig = [c, c, _I64, _I32, _F64,
                 ctypes.c_double, ctypes.c_double, ctypes.c_double,
                 ctypes.c_double, ctypes.c_double, ctypes.c_double,
                 _I64, _I64, ctypes.c_double, ctypes.c_double,
                 ctypes.c_double]
    pivot_sig_s = [c, c, _I64, _I32, _F32] + pivot_sig[5:]
    lib._has_pivot = _bind(lib, "ht_crout_pivot", ctypes.c_void_p, pivot_sig)
    lib._has_pivot_z = _bind(lib, "ht_crout_pivot_z", ctypes.c_void_p,
                             pivot_sig)
    lib._has_pivot_s = _bind(lib, "ht_crout_pivot_s", ctypes.c_void_p,
                             pivot_sig_s)
    lib._has_pivot_c = _bind(lib, "ht_crout_pivot_c", ctypes.c_void_p,
                             pivot_sig_s)
    if lib._has_crout:
        _bind(lib, "ht_res_m", c, [ctypes.c_void_p])
        _bind(lib, "ht_res_nnz", c, [ctypes.c_void_p, ctypes.c_int])
        # vals buffer is typed by the handle's dtype -> opaque pointer
        _bind(lib, "ht_res_copy_mat", None,
              [ctypes.c_void_p, ctypes.c_int, _I64, _I32, ctypes.c_void_p])
        _bind(lib, "ht_res_copy_d", None, [ctypes.c_void_p, ctypes.c_void_p])
        _bind(lib, "ht_res_copy_ord", None, [ctypes.c_void_p, _I64])
        _bind(lib, "ht_res_copy_stats", None, [ctypes.c_void_p, _I64])
        _bind(lib, "ht_res_free", None, [ctypes.c_void_p])
        _bind(lib, "ht_res_ptrs", None,
              [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_void_p)])
        _bind(lib, "ht_res_take_mat", ctypes.c_void_p,
              [ctypes.c_void_p, ctypes.c_int])
        _bind(lib, "ht_mat_ptrs", None,
              [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_void_p)])
        _bind(lib, "ht_mat_free", None, [ctypes.c_void_p])
    lib._has_trsv = (
        _bind(lib, "ht_trsv_lower", None, [c, _I64, _I32, _F64, _F64]) and
        _bind(lib, "ht_trsv_upper", None, [c, _I64, _I32, _F64, _F64]))
    lib._has_trsv_mrhs = (
        _bind(lib, "ht_trsv_lower_mrhs", None, [c, _I64, _I32, _F64, _F64, c])
        and
        _bind(lib, "ht_trsv_upper_mrhs", None, [c, _I64, _I32, _F64, _F64, c]))
    lib._has_trsv_s = (
        _bind(lib, "ht_trsv_lower_s", None, [c, _I64, _I32, _F32, _F32]) and
        _bind(lib, "ht_trsv_upper_s", None, [c, _I64, _I32, _F32, _F32]))
    lib._has_trsv_mrhs_s = (
        _bind(lib, "ht_trsv_lower_mrhs_s", None,
              [c, _I64, _I32, _F32, _F32, c])
        and
        _bind(lib, "ht_trsv_upper_mrhs_s", None,
              [c, _I64, _I32, _F32, _F32, c]))
    if not ok:
        raise RuntimeError("the native library lacks ht_mc64")
    return lib


def available() -> bool:
    return _load() is not None


def has_crout() -> bool:
    lib = _load()
    return bool(lib is not None and getattr(lib, "_has_crout", False))


# numpy dtype -> (crout symbol attr, pivot symbol attr, scalar view dtype)
_DT_DISPATCH = {
    np.dtype(np.float64): ("ht_crout", "ht_crout_pivot", np.float64),
    np.dtype(np.complex128): ("ht_crout_z", "ht_crout_pivot_z", np.float64),
    np.dtype(np.float32): ("ht_crout_s", "ht_crout_pivot_s", np.float32),
    np.dtype(np.complex64): ("ht_crout_c", "ht_crout_pivot_c", np.float32),
}


def has_crout_dtype(dtype) -> bool:
    """Whether a native Crout kernel exists for this value dtype."""
    lib = _load()
    if lib is None:
        return False
    ent = _DT_DISPATCH.get(np.dtype(dtype))
    if ent is None:
        return False
    flag = "_has_" + ent[0][3:]   # ht_crout_s -> _has_crout_s
    return bool(getattr(lib, flag, False))


def has_pivot_dtype(dtype) -> bool:
    lib = _load()
    if lib is None:
        return False
    ent = _DT_DISPATCH.get(np.dtype(dtype))
    if ent is None:
        return False
    flag = {"ht_crout_pivot": "_has_pivot",
            "ht_crout_pivot_z": "_has_pivot_z",
            "ht_crout_pivot_s": "_has_pivot_s",
            "ht_crout_pivot_c": "_has_pivot_c"}[ent[1]]
    return bool(getattr(lib, flag, False))


class _MatHandle:
    """Keeps ONE exported matrix (moved out of a crout result via
    ht_res_take_mat) alive while its numpy views reference it."""

    __slots__ = ("_lib", "_h")

    def __init__(self, lib, h):
        self._lib, self._h = lib, h

    def __del__(self):  # pragma: no cover - interpreter shutdown ordering
        try:
            self._lib.ht_mat_free(self._h)
        except Exception:
            pass


def _wrap_native(addr, dtype, count, owner):
    """numpy view over a native buffer; `owner` is attached to the ctypes
    buffer object (which numpy keeps via .base) so the native memory
    outlives every view."""
    dtype = np.dtype(dtype)
    if count <= 0 or not addr:
        return np.empty(0, dtype=dtype)
    buf = (ctypes.c_byte * (count * dtype.itemsize)).from_address(addr)
    buf._owner = owner
    return np.frombuffer(buf, dtype=dtype)



def transpose(A) -> Optional[tuple]:
    """Native counting CSR->CSC transpose (columns sorted, O(nnz), no
    comparison sorts); returns (indptr, indices, vals) or None."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64:
        return None
    if not hasattr(lib, "_has_tr"):
        lib._has_tr = _bind(lib, "ht_transpose", None,
                            [ctypes.c_int64, ctypes.c_int64, _I64, _I32,
                             _F64, _I64, _I32, _F64])
    if not lib._has_tr:
        return None
    nnz = int(A.indptr[A.nrows])
    Bp = np.empty(A.ncols + 1, dtype=np.int64)
    Bi = np.empty(max(nnz, 1), dtype=np.int32)
    Bv = np.empty(max(nnz, 1), dtype=np.float64)
    lib.ht_transpose(A.nrows, A.ncols, A.indptr, A.indices, A.data,
                     Bp, Bi, Bv)
    return Bp, Bi[:nnz], Bv[:nnz]


def diagonal(A, nd: int) -> Optional[np.ndarray]:
    """Native CSR diagonal extraction; returns out[:nd] or None."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64:
        return None
    if not hasattr(lib, "_has_diag"):
        lib._has_diag = _bind(lib, "ht_diag", None,
                              [ctypes.c_int64, _I64, _I32, _F64,
                               ctypes.c_int64, _F64])
    if not lib._has_diag:
        return None
    out = np.empty(nd, dtype=np.float64)
    lib.ht_diag(A.nrows, A.indptr, A.indices, A.data, nd, out)
    return out


def mc64(B) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Native MC64-equivalent matching; same contract as
    :func:`hifir_tpu_torch.pre.matching.mc64_matching`.

    The kernel is layout-agnostic (it matches "columns" of whatever
    compressed axis it is handed), so the CSR arrays are fed directly —
    i.e. the matching runs on A^T — exactly as the reference does
    (``pre/EqlDriver.hpp:95-117`` passes the CRS to MC64 and swaps the
    returned s/t).  This removes a full counting transpose per level
    (~0.7 s of the 1M-row robust factorize).  Outputs are mapped back:
    the kernel's per-row match ``pT[row] = col`` inverts to our
    ``p[col] = row`` contract, and the row/column scalings swap.
    """
    lib = _load()
    n = B.nrows
    # matching runs on f64 magnitudes regardless of working precision
    if np.iscomplexobj(B.data) or B.data.dtype != np.float64:
        vals = (np.abs(B.data).astype(np.float64)
                if np.iscomplexobj(B.data)
                else B.data.astype(np.float64))
    else:
        vals = B.data
    pT = np.empty(n, dtype=np.int64)
    t = np.empty(n, dtype=np.float64)   # kernel "row" scalings = our cols
    s = np.empty(n, dtype=np.float64)   # kernel "col" scalings = our rows
    info = lib.ht_mc64(n, np.ascontiguousarray(B.indptr, dtype=np.int64),
                       np.ascontiguousarray(B.indices, dtype=np.int32),
                       np.ascontiguousarray(vals), pT, t, s)
    if info < 0:
        raise RuntimeError(f"native mc64 failed with {info}")
    p = np.empty(n, dtype=np.int64)
    p[pT] = np.arange(n, dtype=np.int64)
    return p, s, t, info


def amd(n: int, indptr: np.ndarray, indices: np.ndarray) -> Optional[np.ndarray]:
    """Native AMD ordering on a symmetric pattern; returns permutation or None."""
    lib = _load()
    if lib is None or not getattr(lib, "_has_amd", False):
        return None
    perm = np.empty(n, dtype=np.int64)
    st = lib.ht_amd(n, np.ascontiguousarray(indptr, dtype=np.int64),
                    np.ascontiguousarray(indices, dtype=np.int32), perm)
    if st != 0:
        return None
    return perm


def rcm(n: int, indptr: np.ndarray, indices: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None or not getattr(lib, "_has_rcm", False):
        return None
    perm = np.empty(n, dtype=np.int64)
    st = lib.ht_rcm(n, np.ascontiguousarray(indptr, dtype=np.int64),
                    np.ascontiguousarray(indices, dtype=np.int32), perm)
    if st != 0:
        return None
    return perm


def crout(Ahat, d0: np.ndarray, m2: int, pars: Tuple[float, float, float,
                                                     float, float, float],
          row_ref: np.ndarray, col_ref: np.ndarray,
          schur_aL: float, schur_aU: float, symmetric: int = 0):
    """Native deferred-Crout level kernel + Schur.

    Returns ``(m, L_B, U_B, S, E, F, d, ord_final, stats)`` with the
    matrices as ``(indptr, indices, vals)`` CSR triples; same semantics as
    :func:`hifir_tpu_torch.alg.crout_np.crout_level_np` plus the L_E/U_F dropping,
    Schur formation and E/F block extraction fused in.

    ``symmetric``: 0 = general LDU, 1 = LDL^T (opts.is_symm; real or
    complex-symmetric), 2 = pattern-symmetric mirror mode (the reference's
    ``level_factorize<IsSymm=true>``; anchor ``crout_level_np(symm_mode=2)``),
    3 = Hermitian LDL^H (complex A == A^H; anchor ``symm_mode=3``).
    """
    lib = _load()
    kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U = pars
    n = Ahat.nrows
    vdt = np.dtype(Ahat.data.dtype)
    sym, _, scal = _DT_DISPATCH[vdt]

    def _as_scal(a):
        a = np.ascontiguousarray(a, dtype=vdt)
        return a.view(scal)

    fn = getattr(lib, sym)
    h = fn(n, m2, Ahat.indptr, Ahat.indices, _as_scal(Ahat.data),
           _as_scal(np.asarray(d0, dtype=vdt)),
           kappa_d, kappa, tau_L, tau_U, alpha_L, alpha_U,
           np.ascontiguousarray(row_ref, dtype=np.int64),
           np.ascontiguousarray(col_ref, dtype=np.int64),
           schur_aL, schur_aU, int(symmetric))
    if not h:
        raise RuntimeError("native crout failed")
    try:
        return _export_crout_result(lib, h, n, vdt)
    finally:
        # Always free the Result shell, even if export raises midway; the
        # per-matrix _MatHandle owners keep moved-out matrices alive
        # independently.
        lib.ht_res_free(h)


def _export_crout_result(lib, h, n, vdt):
    m = lib.ht_res_m(h)
    nm = n - m

    def _mat(what, nrows):
        # zero-copy with PER-MATRIX lifetime: the matrix's vectors are moved
        # out of the Result into a standalone holder, so e.g. the (consumed)
        # Schur complement is freed as soon as the next level drops it
        # instead of living as long as the preconditioner (that retention
        # was ~0.5 GB of dead arrays on a 1M-row robust factorize)
        nnz = lib.ht_res_nnz(h, what)
        mh = lib.ht_res_take_mat(h, what)
        owner = _MatHandle(lib, mh)
        pp = ctypes.c_void_p()
        pi = ctypes.c_void_p()
        pv = ctypes.c_void_p()
        lib.ht_mat_ptrs(mh, ctypes.byref(pp), ctypes.byref(pi),
                        ctypes.byref(pv))
        indptr = _wrap_native(pp.value, np.int64, nrows + 1, owner)
        indices = _wrap_native(pi.value, np.int32, nnz, owner)
        vals = _wrap_native(pv.value, vdt, nnz, owner)
        return indptr, indices, vals

    L = _mat(0, m)
    U = _mat(1, m)
    S = _mat(2, nm)
    E = _mat(3, nm)
    F = _mat(4, m)
    d = np.empty(m, dtype=vdt)
    if m:
        lib.ht_res_copy_d(h, d.ctypes.data_as(ctypes.c_void_p))
    # ord holds row and column orderings back to back (they coincide
    # for the non-pivoting kernel)
    ordf = np.empty(2 * n, dtype=np.int64)
    lib.ht_res_copy_ord(h, ordf)
    ordf = ordf.reshape(2, n)
    if np.array_equal(ordf[0], ordf[1]):
        ordf = ordf[0]
    stats = np.empty(6, dtype=np.int64)
    lib.ht_res_copy_stats(h, stats)
    kmm = _fetch_kmm(lib, h)
    return m, L, U, S, E, F, d, ordf, stats, kmm


def _fetch_kmm(lib, h) -> Optional[np.ndarray]:
    """min/max |kappa_u|, min/max |kappa_l| of a native level result (the
    reference's INFO2 per-level dump inputs, ref factor.hpp:1063-1110)."""
    if not hasattr(lib, "_has_kmm"):
        lib._has_kmm = _bind(lib, "ht_res_kmm", None,
                             [ctypes.c_void_p, _F64])
    if not lib._has_kmm:
        return None
    out = np.empty(4, dtype=np.float64)
    lib.ht_res_kmm(h, out)
    return out


def trsv(M, b: np.ndarray, lower: bool) -> Optional[np.ndarray]:
    """Native sequential strict-triangular solve; None if unavailable.
    ``b`` may be (n,) or a row-major (n, k) multi-RHS block (the latter maps
    to the dedicated mrhs kernels, ref CompressedStorage.hpp:1382-1518)."""
    lib = _load()
    if lib is None or M.data.dtype != b.dtype:
        return None
    vdt = M.data.dtype
    if vdt == np.float64:
        ok1 = getattr(lib, "_has_trsv", False)
        okm = getattr(lib, "_has_trsv_mrhs", False)
        suffix = ""
    elif vdt == np.float32:
        ok1 = getattr(lib, "_has_trsv_s", False)
        okm = getattr(lib, "_has_trsv_mrhs_s", False)
        suffix = "_s"
    else:
        return None
    x = np.ascontiguousarray(b, dtype=vdt).copy()
    tri = "lower" if lower else "upper"
    if b.ndim == 2:
        if not okm:
            return None
        fn = getattr(lib, f"ht_trsv_{tri}_mrhs{suffix}")
        fn(M.nrows, M.indptr, M.indices,
           np.ascontiguousarray(M.data, dtype=vdt), x, x.shape[1])
        return x
    if not ok1:
        return None
    fn = getattr(lib, f"ht_trsv_{tri}{suffix}")
    fn(M.nrows, M.indptr, M.indices,
       np.ascontiguousarray(M.data, dtype=vdt), x)
    return x


def trsv_levels(n: int, indptr: np.ndarray, indices: np.ndarray,
                lower: bool) -> Optional[np.ndarray]:
    """Dependency levels of a strict-triangular factor; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_has_levels"):
        lib._has_levels = _bind(
            lib, "ht_trsv_levels", None,
            [ctypes.c_int64, _I64, _I32, ctypes.c_int, _I64])
    if not lib._has_levels:
        return None
    lev = np.zeros(n, dtype=np.int64)
    lib.ht_trsv_levels(n, np.ascontiguousarray(indptr, dtype=np.int64),
                       np.ascontiguousarray(indices, dtype=np.int32),
                       1 if lower else 0, lev)
    return lev


def permute_scale(A, s: np.ndarray, t: np.ndarray, p: np.ndarray,
                  q_inv: np.ndarray):
    """Native Ahat = (diag(s) A diag(t))[p, q] with sorted rows; None if
    unavailable."""
    lib = _load()
    if lib is None or A.data.dtype not in (np.float64, np.float32):
        return None
    f32 = A.data.dtype == np.float32
    if not hasattr(lib, "_has_permute"):
        lib._has_permute = _bind(
            lib, "ht_permute_scale", None,
            [ctypes.c_int64, _I64, _I32, _F64, _F64, _F64, _I64, _I64,
             _I64, _I32, _F64])
        lib._has_permute_s = _bind(
            lib, "ht_permute_scale_s", None,
            [ctypes.c_int64, _I64, _I32, _F32, _F64, _F64, _I64, _I64,
             _I64, _I32, _F32])
    if not lib._has_permute or (f32 and not lib._has_permute_s):
        return None
    n = A.nrows
    vdt = np.float32 if f32 else np.float64
    Bp = np.empty(n + 1, dtype=np.int64)
    Bi = np.empty(A.nnz, dtype=np.int32)
    Bv = np.empty(A.nnz, dtype=vdt)
    fn = lib.ht_permute_scale_s if f32 else lib.ht_permute_scale
    fn(n, A.indptr, A.indices,
       np.ascontiguousarray(A.data, dtype=vdt),
       np.ascontiguousarray(s, dtype=np.float64),
       np.ascontiguousarray(t, dtype=np.float64),
       np.ascontiguousarray(p, dtype=np.int64),
       np.ascontiguousarray(q_inv, dtype=np.int64), Bp, Bi, Bv)
    return Bp, Bi, Bv


def pattern_symm(n: int, indptr: np.ndarray, indices: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_has_psym"):
        lib._has_psym = _bind(lib, "ht_pattern_symm", ctypes.c_double,
                              [ctypes.c_int64, _I64, _I32])
    if not lib._has_psym:
        return None
    return float(lib.ht_pattern_symm(
        n, np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int32)))


def value_symm(n: int, indptr: np.ndarray, indices: np.ndarray,
               vals: np.ndarray) -> Optional[bool]:
    """Exact A == A^T test (real f64) for the auto-LDL^T dispatch; None if
    the native library is unavailable (callers fall back to scipy)."""
    lib = _load()
    if lib is None or vals.dtype != np.float64:
        return None
    if not hasattr(lib, "_has_vsym"):
        lib._has_vsym = _bind(lib, "ht_value_symm", ctypes.c_int,
                              [ctypes.c_int64, _I64, _I32, _F64])
    if not lib._has_vsym:
        return None
    return bool(lib.ht_value_symm(
        n, np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int32),
        np.ascontiguousarray(vals, dtype=np.float64)))


def defer_probe(A, m0: int, p: np.ndarray, q: np.ndarray):
    """Native (diag, max-magnitude) probe for static deferral; None if
    unavailable."""
    lib = _load()
    if lib is None or A.data.dtype != np.float64:
        return None
    if not hasattr(lib, "_has_probe"):
        lib._has_probe = _bind(
            lib, "ht_defer_probe", None,
            [ctypes.c_int64, _I64, _I32, _F64, ctypes.c_int64, _I64, _I64,
             _F64, _F64])
    if not lib._has_probe:
        return None
    diag = np.empty(m0, dtype=np.float64)
    mx = np.empty(m0, dtype=np.float64)
    lib.ht_defer_probe(A.nrows, A.indptr, A.indices,
                       np.ascontiguousarray(A.data, dtype=np.float64), m0,
                       np.ascontiguousarray(p, dtype=np.int64),
                       np.ascontiguousarray(q, dtype=np.int64), diag, mx)
    return diag, mx


def has_pivot() -> bool:
    lib = _load()
    return bool(lib is not None and getattr(lib, "_has_pivot", False))


def crout_pivot(Ahat, m2: int, pars, row_ref, col_ref, schur_aL, schur_aU,
                gamma: float):
    """Native rook-pivoting level kernel; same contract as
    :func:`hifir_tpu_torch.alg.crout_pivot_np.pivot_crout_level_np` with finalize
    fused (returns independent row/col orderings as a (2, n) array)."""
    lib = _load()
    kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U = pars
    n = Ahat.nrows
    vdt = np.dtype(Ahat.data.dtype)
    _, psym, scal = _DT_DISPATCH[vdt]
    data = np.ascontiguousarray(Ahat.data, dtype=vdt).view(scal)
    fn = getattr(lib, psym)
    h = fn(n, m2, Ahat.indptr, Ahat.indices, data,
           kappa_d, kappa, tau_L, tau_U, alpha_L, alpha_U,
           np.ascontiguousarray(row_ref, dtype=np.int64),
           np.ascontiguousarray(col_ref, dtype=np.int64),
           schur_aL, schur_aU, gamma)
    if not h:
        raise RuntimeError("native pivot crout failed")
    try:
        m = lib.ht_res_m(h)
        nm = n - m

        def _mat(what, nrows):
            nnz = lib.ht_res_nnz(h, what)
            indptr = np.empty(nrows + 1, dtype=np.int64)
            indices = np.empty(max(nnz, 1), dtype=np.int32)
            vals = np.empty(max(nnz, 1), dtype=vdt)
            lib.ht_res_copy_mat(h, what, indptr, indices,
                                vals.ctypes.data_as(ctypes.c_void_p))
            return indptr, indices[:nnz], vals[:nnz]

        L = _mat(0, m)
        U = _mat(1, m)
        S = _mat(2, nm)
        E = _mat(3, nm)
        F = _mat(4, m)
        d = np.empty(m, dtype=vdt)
        if m:
            lib.ht_res_copy_d(h, d.ctypes.data_as(ctypes.c_void_p))
        ordf = np.empty(2 * n, dtype=np.int64)
        lib.ht_res_copy_ord(h, ordf)
        ordf = ordf.reshape(2, n)
        stats = np.empty(6, dtype=np.int64)
        lib.ht_res_copy_stats(h, stats)
        kmm = _fetch_kmm(lib, h)
    finally:
        lib.ht_res_free(h)
    return m, L, U, S, E, F, d, ordf, stats, kmm


def sym_leading_pattern(A, p: np.ndarray, q: np.ndarray, m: int):
    """Fused symmetrized leading-block pattern ``(B | B^T)`` with
    ``B = pattern(A[p[:m], q[:m]])`` for the fill-reducing orderings; returns
    ``(indptr, indices)`` (rows unsorted) or None if the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_has_symlead"):
        lib._has_symlead = _bind(
            lib, "ht_sym_leading_pattern", ctypes.c_int64,
            [ctypes.c_int64, _I64, _I32, _I64, _I64, ctypes.c_int64,
             _I64, _I32])
    if not lib._has_symlead:
        return None
    p = np.ascontiguousarray(p, dtype=np.int64)
    q = np.ascontiguousarray(q, dtype=np.int64)
    cap = 2 * int((A.indptr[p[:m] + 1] - A.indptr[p[:m]]).sum())
    Pp = np.empty(m + 1, dtype=np.int64)
    Pi = np.empty(max(cap, 1), dtype=np.int32)
    nnz = lib.ht_sym_leading_pattern(A.nrows, A.indptr, A.indices, p, q, m,
                                     Pp, Pi)
    return Pp, Pi[:nnz]
