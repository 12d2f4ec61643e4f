"""Preprocessing driver (ref ``src/hif/pre/driver.hpp:68`` and
``pre/matching_scaling.hpp:348``).

Pipeline per level: (1) optional a-priori scaling + MC64-style matching with
scaling, (2) scaling safeguard (beta), (3) static deferral of tiny/zero
diagonals to the tail, (4) fill-reducing reordering (AMD/RCM) of the leading
block, composed into the row/column permutations.

The port's copy of ``hifir_tpu/pre/driver.py``: the defer probe and the
fused leading-block pattern run in the native host library when it is
loaded, the numpy paths otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ds.csr import CSR
from ..options import REORDER_AUTO, REORDER_OFF, REORDER_RCM, Options
from ..utils.log import hif_warning
from .matching import do_matching
from .ordering import run_amd, run_rcm

__all__ = ["do_preprocessing", "defer_tiny_diags", "fix_poor_scaling"]

_EPS = float(np.finfo(np.float64).eps)


def fix_poor_scaling(m0: int, level: int, p, q, s, t, beta: float = 1e3) -> None:
    """Safeguard badly mismatched row/column scaling pairs
    (ref ``pre/matching_scaling.hpp:60-76``): for level>=2, whenever
    ``beta*min(s_p,t_q) < max(s_p,t_q)`` set both to the geometric mean."""
    beta0 = 1e3 if beta < 0.0 else beta
    if level <= 1 or beta0 <= 1.0:
        return
    sp = s[p[:m0]]
    tq = t[q[:m0]]
    bad = np.minimum(sp, tq) * beta0 < np.maximum(sp, tq)
    if bad.any():
        g = np.sqrt(sp[bad] * tq[bad])
        s[p[:m0][bad]] = g
        t[q[:m0][bad]] = g


def defer_tiny_diags(A: CSR, m0: int, p: np.ndarray, q: np.ndarray
                     ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Statically defer zero/tiny diagonals to the tail of the leading block
    (ref ``pre/matching_scaling.hpp:99-183``).

    An entry is *good* when ``|A[p_i, q_i]| > eps * max(rowmax, colmax)``.
    Returns ``(m, p, q)`` where accepted entries occupy positions [0, m) in
    original relative order followed by deferred ones at [m, m0).
    """
    n = A.nrows
    if m0 == 0:
        return 0, p, q
    from . import _native

    # the probe consumes magnitudes only: non-f64 working precisions (native
    # f32/c64 factorization, complex) convert |data| once per level (~ms)
    # instead of falling into the scipy max(axis)/searchsorted path (seconds
    # per level at 1M rows)
    if A.data.dtype == np.float64:
        probe = _native.defer_probe(A, m0, p, q)
    else:
        Aabs = CSR(A.nrows, A.ncols, A.indptr, A.indices,
                   np.abs(A.data).astype(np.float64))
        probe = _native.defer_probe(Aabs, m0, p, q)
    if probe is not None:
        diag, mx = probe
    else:
        absS = A.to_scipy().copy()
        absS.data = np.abs(absS.data)
        rowmax = np.asarray(absS.max(axis=1).todense()).ravel()
        colmax = np.asarray(absS.max(axis=0).todense()).ravel()
        rows = np.repeat(np.arange(n), np.diff(A.indptr))
        # vectorized lookup of A[p_i, q_i]: CSR entries in row-major key order
        # are globally sorted, so one searchsorted answers all m0 queries
        keys = rows * np.int64(A.ncols) + A.indices.astype(np.int64)
        queries = p[:m0] * np.int64(A.ncols) + q[:m0]
        pos = np.searchsorted(keys, queries)
        pos_c = np.minimum(pos, keys.size - 1)
        hit = (keys.size > 0) & (keys[pos_c] == queries)
        diag = np.where(hit, A.data[pos_c], 0.0)
        mx = np.maximum(rowmax[p[:m0]], colmax[q[:m0]])
        mx[mx == 0.0] = 1.0
    good = np.abs(diag) > mx * _EPS
    m = int(good.sum())
    order = np.concatenate([np.flatnonzero(good), np.flatnonzero(~good)])
    p2 = p.copy()
    q2 = q.copy()
    p2[:m0] = p[:m0][order]
    q2[:m0] = q[:m0][order]
    return m, p2, q2


def do_preprocessing(A: CSR, m0: int, level: int, opts: Options,
                     is_symm_pre: bool):
    """Full preprocessing step (ref ``pre/driver.hpp:68-141``).

    Returns ``(s, t, p, q, m)``; ``p``/``q`` are forward permutations of size n
    (position -> original index) and ``m <= m0`` the leading block size.
    """
    n = A.nrows
    if m0 == n:
        B = A
    else:
        B = A.extract_leading(m0)

    p_blk, q_blk, s_blk, t_blk, info = do_matching(B, is_symm_pre,
                                                   opts.pre_scale)
    if info == 1:
        hif_warning("matching: input matrix is structurally singular!")
    elif info == 2:
        hif_warning("matching: scaling may cause overflow!")

    # extend block results to full size: identity/unity on the tail
    # (ref ``do_maching``, pre/matching_scaling.hpp:422-431)
    p = np.arange(n, dtype=np.int64)
    q = np.arange(n, dtype=np.int64)
    s = np.ones(n)
    t = np.ones(n)
    p[:m0] = p_blk[:m0]
    q[:m0] = q_blk[:m0]
    s[:m0] = s_blk[:m0]
    t[:m0] = t_blk[:m0]

    fix_poor_scaling(m0, level, p, q, s, t, opts.beta)

    m, p, q = defer_tiny_diags(A, m0, p, q)

    if opts.reorder != REORDER_OFF and m:
        use_rcm = (opts.reorder == REORDER_RCM
                   or (opts.reorder == REORDER_AUTO and is_symm_pre
                       and level == 1 and m != m0))
        # leading-block pattern B_m = A[p_{1:m}, q_{1:m}] (ref
        # ``compute_leading_block``, pre/matching_scaling.hpp:199),
        # symmetrized for the ordering graph; native fused path builds
        # (B | B^T) in one O(nnz) pass
        from . import _native

        P = None
        trip = _native.sym_leading_pattern(A, p, q, m)
        if trip is not None:
            P = _native.rcm(m, *trip) if use_rcm else _native.amd(m, *trip)
        if P is None:
            S = A.to_scipy()
            Bm = S[p[:m], :][:, q[:m]].tocsr()
            Bm.data = np.ones_like(Bm.data)
            Bm_csr = CSR(m, m, Bm.indptr.astype(np.int64), Bm.indices,
                         Bm.data)
            P = run_rcm(Bm_csr) if use_rcm else run_amd(Bm_csr)
        p[:m] = p[:m][P]
        q[:m] = q[:m][P]

    return s, t, p, q, m
