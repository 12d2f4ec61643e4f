"""Per-level factorization driver.

Behavioral port target: ``src/hif/alg/factor.hpp:561-1307``
(``level_factorize``).  The port's copy of ``hifir_tpu/alg/factor.py``:
preprocessing and the sequential Crout kernel run on the host, in the
native host library (``native/src``, through :mod:`..pre._native`) when it
is loaded and in numpy otherwise (:mod:`.crout_np`,
:mod:`.crout_pivot_np`).  The JAX package's distributed Schur is not
ported.  The per-level operands are later packed onto the GPU by
:class:`~hifir_tpu_torch.alg.prec.DevicePrec`.  Its phases are spans of
:mod:`..trace`: ``hifir.factorize.pre``, ``.crout`` and ``.schur`` (the
anchors' offset dropping and Schur complement; the native Crout computes
both inside ``.crout``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..ds.csr import CSR
from ..options import (PIVOTING_AUTO, PIVOTING_ON, VERBOSE_FAC,
                       Options, determine_fac_pars)
from ..pre import _native
from ..pre.driver import do_preprocessing
from ..trace import span
from ..utils.log import hif_info
from .crout_np import CroutResult, crout_level_np
from .crout_pivot_np import pivot_crout_level_np
from .level import LevelPrec

__all__ = ["LevelPrec", "level_factorize", "MIN_LOCAL_SIZE_RATIO"]

# ref macros.hpp HIF_MIN_LOCAL_SIZE_PERCTG = 85
MIN_LOCAL_SIZE_RATIO = 0.85


def _symm_kernel_mode(opts: Options, Ahat: CSR, sym_block: bool) -> int:
    """Crout kernel mode for this level (shared by the native and anchor
    branches): 0 general LDU; 1 LDL^T (real or complex-symmetric is_symm);
    3 Hermitian LDL^H (complex is_symm classified as A == A^H by
    ``api.factorize`` via ``opts.symm_kind == 2``); 2 declared symmetric
    leading block (m0 > 0, ref builder.hpp:534,546-567)."""
    if bool(opts.is_symm):
        if np.iscomplexobj(Ahat.data):
            # symm_kind: 1 = A == A^T, 2 = A == A^H.  Unclassified complex
            # (user constructed options by hand and bypassed api.factorize's
            # classification) falls back to the general path — unlike the
            # reference, whose is_symm on complex input silently produces a
            # broken factorization (BASELINE.md round-5).
            return {1: 1, 2: 3}.get(int(getattr(opts, "symm_kind", 0)), 0)
        return 1
    return 2 if sym_block else 0


def _drop_offsets(M: CSR, ref_sizes: np.ndarray, alpha: float) -> CSR:
    """Per-row space cap on the offset factors L_E / U_F
    (ref ``alg/Schur.hpp:61-134`` drop_offsets_kernel)."""
    if alpha <= 0.0 or M.nrows == 0:
        return M
    rows_keep = []
    cols_keep = []
    vals_keep = []
    for i in range(M.nrows):
        s_, e_ = M.indptr[i], M.indptr[i + 1]
        nnz = e_ - s_
        cap = int(math.ceil(alpha * ref_sizes[i]))
        idx = M.indices[s_:e_]
        val = M.data[s_:e_]
        if cap < nnz:
            # deterministic top-k: |v| descending, ties by position ascending
            # (== secondary-axis index ascending) — same total order as the
            # native finalize drop, so kept sets match bit-exactly
            sel = np.lexsort((np.arange(nnz), -np.abs(val)))[:cap]
            idx, val = idx[sel], val[sel]
        rows_keep.append(np.full(idx.size, i, dtype=np.int64))
        cols_keep.append(idx.astype(np.int64))
        vals_keep.append(val)
    return CSR.from_coo(M.nrows, M.ncols,
                        np.concatenate(rows_keep) if rows_keep else [],
                        np.concatenate(cols_keep) if cols_keep else [],
                        np.concatenate(vals_keep) if vals_keep else
                        np.empty(0, dtype=M.dtype))


def _compute_schur(C_tail, L_E: CSR, d: np.ndarray, U_F: CSR) -> CSR:
    """Schur complement S = C - L_E diag(d) U_F (ref ``alg/Schur.hpp:214``
    compute_Schur_simple; the native path accumulates in extended precision)."""
    import scipy.sparse as sp

    LD = L_E.to_scipy().copy()
    LD = LD @ sp.diags(d)
    S = (C_tail - LD @ U_F.to_scipy()).tocsr()
    S.sum_duplicates()
    S.sort_indices()
    return CSR(S.shape[0], S.shape[1], S.indptr.astype(np.int64), S.indices,
               S.data)


def level_factorize(A: CSR, m0: int, N: int, level: int, opts: Options,
                    row_sizes: np.ndarray, col_sizes: np.ndarray,
                    stats: np.ndarray, force_pivot: bool = False,
                    sym_block: bool = False, device="cuda"
                    ) -> Tuple[LevelPrec, Optional[CSR], np.ndarray, np.ndarray]:
    """One level end-to-end.  Returns ``(prec, S_next, row_sizes, col_sizes)``;
    ``S_next`` is ``None`` when this is the last level (dense tail attached to
    ``prec.dense_matrix``).  ``force_pivot`` selects the rook-pivoting kernel
    (the AUTO retry path, ref builder.hpp:552-567).  ``sym_block`` is the
    reference's ``IsSymm`` template flag (builder.hpp:534-535: level 1 with a
    user-declared symmetric leading block ``m0 > 0``): symmetric
    preprocessing is forced and the Crout kernel runs in mirror mode
    (``crout_level_np(symm_mode=2)``).  ``opts.dist_schur`` computes the
    Schur complement by the ring SpGEMM over the default mesh on
    ``device`` (:func:`~hifir_tpu_torch.parallel.schur.schur_spgemm_ring`),
    on the numpy anchors, as the JAX package does."""
    import scipy.sparse as sp

    n = A.nrows
    if A.ncols != n:
        raise ValueError("only square systems are supported")

    # --- symmetric-preprocessing decision (ref factor.hpp:588-611) ---------
    if opts.is_symm or sym_block:
        do_symm_pre = True
    elif opts.symm_pre_lvls < 0:
        if level <= -opts.symm_pre_lvls:
            ratio = A.pattern_symm_ratio()
            do_symm_pre = ratio >= opts.nzp_thres
        else:
            do_symm_pre = False
    else:
        do_symm_pre = level <= opts.symm_pre_lvls

    # --- row/col size references (ref factor.hpp:629-649) ------------------
    if level == 1:
        row_sizes = A.row_nnz().astype(np.int64)
        col_sizes = np.zeros(n, dtype=np.int64)
        np.add.at(col_sizes, A.indices, 1)
        lower_row = int(math.ceil(MIN_LOCAL_SIZE_RATIO * A.nnz / n))
        lower_col = lower_row
        np.maximum(row_sizes, lower_row, out=row_sizes)
        np.maximum(col_sizes, lower_col, out=col_sizes)

    # --- preprocessing ------------------------------------------------------
    hif_info(opts, "\nenter level %d (%s)", level,
             "symmetric" if do_symm_pre else "asymmetric")
    if not opts.no_pre:
        with span("hifir.factorize.pre"):
            s, t, p, q, m = do_preprocessing(A, m0, level, opts, do_symm_pre)
        hif_info(opts, "preprocessing done with leading block size %d", m)
    else:
        s = np.ones(n)
        t = np.ones(n)
        p = np.arange(n, dtype=np.int64)
        q = np.arange(n, dtype=np.int64)
        m = n
    m2 = m

    # --- permuted scaled level matrix in id space ---------------------------
    q_inv_ids = np.empty(n, dtype=np.int64)
    q_inv_ids[q] = np.arange(n)
    trip = (_native.permute_scale(A, s, t, p, q_inv_ids)
            if A.data.dtype in (np.float64, np.float32) else None)
    if trip is not None:
        Ahat = CSR(n, n, *trip)
        Ahat_s = None
    else:
        S_scipy = A.to_scipy()
        Ahat_s = (sp.diags(s) @ S_scipy @ sp.diags(t)
                  ).tocsr()[p, :][:, q].tocsr()
        Ahat_s.sort_indices()
        if Ahat_s.data.dtype != A.data.dtype:
            # the f64 diag scalings upcast single-precision values; the
            # level matrix keeps the working precision
            Ahat_s.data = Ahat_s.data.astype(A.data.dtype)
        Ahat = CSR(n, n, Ahat_s.indptr.astype(np.int64), Ahat_s.indices,
                   Ahat_s.data)
    d0 = Ahat.diagonal()[:m2] if m2 else np.empty(0, dtype=A.dtype)

    row_ref = row_sizes[p]
    col_ref = col_sizes[q]

    # --- Crout loop (native C++ fast path, numpy anchor fallback) -----------
    a_L, a_U = opts.alpha_L, opts.alpha_U
    if level == 1 and opts.fat_schur_1st:
        a_L *= 2
        a_U *= 2
    use_pivot = force_pivot or opts.pivot == PIVOTING_ON
    # dist_schur needs the anchor branch (the native kernel fuses the Schur);
    # VERBOSE_FAC (per-Crout-step streaming, ref builder.hpp:266-267) also
    # runs the anchor, whose loop streams each step -- matching the
    # reference, where the streamer costs the factorization its speed too
    stream_fac = bool(opts.verbose & VERBOSE_FAC)
    use_native = (not use_pivot and opts.use_native and not opts.dist_schur
                  and not stream_fac
                  and _native.has_crout_dtype(Ahat.data.dtype))
    S_native = None
    EF_native = None
    native_pivot_ok = (opts.use_native
                       and _native.has_pivot_dtype(Ahat.data.dtype))
    with span("hifir.factorize.crout"):
        if use_pivot and native_pivot_ok:
            pars = determine_fac_pars(opts, level)
            (m, Ltrip, Utrip, Strip, Etrip, Ftrip, dvec_n, ordf,
             nstats, kmm) = _native.crout_pivot(Ahat, m2, pars, row_ref,
                                                col_ref, a_L, a_U,
                                                opts.gamma)
            res = CroutResult(
                m=m, n=n,
                L_B=CSR(m, m, *Ltrip), d=dvec_n, U_B=CSR(m, m, *Utrip),
                L_E=None, U_F=None, ord_final=ordf,
                defers=int(nstats[0]), diag_defers=int(nstats[1]),
                cond_defers=int(nstats[2]), space_drops=int(nstats[3]),
                total_drops=int(nstats[4]), kappa_u=None, kappa_l=None)
            S_native = CSR(n - m, n - m, *Strip)
            EF_native = (CSR(n - m, m, *Etrip), CSR(m, n - m, *Ftrip))
        elif use_pivot:
            res = pivot_crout_level_np(Ahat, m2, level, opts, row_ref,
                                       col_ref)
            kmm = None
        elif use_native:
            pars = determine_fac_pars(opts, level)
            # kernel mode: 1 = LDL^T mirror (U = L^T), for real or
            # complex-symmetric input under opts.is_symm; 3 = Hermitian
            # LDL^H (U = conj(L)^T) when api.factorize classified the
            # complex input as A == A^H (opts.symm_kind == 2) — a
            # correctness improvement over
            # the reference, whose own is_symm on complex input is broken
            # (BASELINE.md round-5 measurement); 2 = symmetric leading-block
            # mirror matching the reference's level_factorize<IsSymm=true>
            # dispatch (builder.hpp:534,546-567, taken only when the user
            # declares a symmetric leading block with m0 > 0 at level 1);
            # 0 = general LDU
            symm_kernel = _symm_kernel_mode(opts, Ahat, sym_block)
            (m, Ltrip, Utrip, Strip, Etrip, Ftrip, dvec_n, ordf,
             nstats, kmm) = _native.crout(Ahat, d0, m2, pars, row_ref,
                                          col_ref, a_L, a_U,
                                          symmetric=symm_kernel)
            res = CroutResult(
                m=m, n=n,
                L_B=CSR(m, m, *Ltrip), d=dvec_n, U_B=CSR(m, m, *Utrip),
                L_E=None, U_F=None, ord_final=ordf,
                defers=int(nstats[0]), diag_defers=int(nstats[1]),
                cond_defers=int(nstats[2]), space_drops=int(nstats[3]),
                total_drops=int(nstats[4]), kappa_u=None, kappa_l=None)
            S_native = CSR(n - m, n - m, *Strip)
            EF_native = (CSR(n - m, m, *Etrip), CSR(m, n - m, *Ftrip))
        else:
            # same mode dispatch as the native branch above
            anchor_mode = _symm_kernel_mode(opts, Ahat, sym_block)
            res = crout_level_np(Ahat, d0, m2, level, opts, row_ref, col_ref,
                                 symm_mode=anchor_mode)
            kmm = None
    m = res.m

    # INFO2 per-level |kappa| dump (ref factor.hpp:1063-1110)
    if kmm is None and getattr(res, "kappa_u", None) is not None \
            and len(res.kappa_u):
        ku = np.abs(res.kappa_u)
        kl = np.abs(getattr(res, "kappa_l", res.kappa_u))
        kmm = (ku.min(), ku.max(),
               (kl.min() if len(kl) else 0.0),
               (kl.max() if len(kl) else 0.0))
    if kmm is not None:
        hif_info(opts, "  |kappa_u| in [%.4g, %.4g], |kappa_l| in "
                       "[%.4g, %.4g]", kmm[0], kmm[1], kmm[2], kmm[3],
                 tag="info2")

    # --- post-flag analysis (ref factor.hpp:1032-1050) ----------------------
    post_flag = 0
    if m2 and m <= 0.25 * m2:
        post_flag = 2
        m = 0
    elif m2 and m <= 0.4 * m2:
        post_flag = -1

    # AUTO retry: too many dynamic deferrals -> redo this level with the
    # rook-pivoting kernel (ref factor.hpp:1044-1050 + builder.hpp:552-567)
    if post_flag != 0 and opts.pivot == PIVOTING_AUTO and not use_pivot:
        hif_info(opts, "level %d: retrying with rook pivoting "
                       "(post_flag=%d)", level, post_flag)
        return level_factorize(A, m0, N, level, opts, row_sizes, col_sizes,
                               stats, force_pivot=True, device=device)

    # stats (ref factor.hpp:1053-1060)
    stats[0] += m0 - m
    stats[1] += res.defers if m else 0
    stats[2] += res.diag_defers
    stats[3] += res.cond_defers
    stats[4] += res.total_drops
    stats[5] += res.space_drops

    if res.ord_final.ndim == 2:
        ord_rows, ord_cols = res.ord_final[0], res.ord_final[1]
    else:
        ord_rows = ord_cols = res.ord_final
    p_out = p[ord_rows]
    q_out = q[ord_cols]

    if m and post_flag <= 0:
        if S_native is not None:
            S = S_native
            E, F = EF_native
        else:
            # permuted-by-final-order view of Ahat
            if Ahat_s is None:
                Ahat_s = Ahat.to_scipy()
                Ahat_s.sort_indices()  # native permute_scale emits unsorted
            Ah2 = Ahat_s[ord_rows, :][:, ord_cols].tocsr()
            with span("hifir.factorize.schur"):
                # L_E / U_F dropping (ref factor.hpp:1152-1181)
                L_E = _drop_offsets(res.L_E, row_sizes[p_out[m:]], a_L)
                U_F_t = _drop_offsets(res.U_F.transpose(),
                                      col_sizes[q_out[m:]], a_U)
                U_F = U_F_t.transpose()
                C_tail = Ah2[m:, :][:, m:].tocsr()
                if opts.dist_schur:
                    # the ring SpGEMM over the default mesh on the device
                    from ..parallel.schur import schur_spgemm_ring

                    C_csr = CSR(n - m, n - m, C_tail.indptr.astype(np.int64),
                                C_tail.indices, C_tail.data)
                    S = schur_spgemm_ring(C_csr, L_E, res.d, U_F,
                                          device=device)
                else:
                    S = _compute_schur(C_tail, L_E, res.d, U_F)
            E = Ah2[m:, :][:, :m].tocsr()
            F = Ah2[:m, :][:, m:].tocsr()
            E = CSR(n - m, m, E.indptr.astype(np.int64), E.indices, E.data)
            F = CSR(m, n - m, F.indptr.astype(np.int64), F.indices, F.data)
        L_B, dvec, U_B = res.L_B, res.d, res.U_B
    else:
        # too many deferrals: S = A, trivial level (ref factor.hpp:1200-1207)
        if post_flag == 2:
            hif_info(opts, "too many dynamic deferrals, resort to complete "
                           "factorization of the Schur (=A) on the next step")
        S = A
        p_out = np.arange(n, dtype=np.int64)
        q_out = np.arange(n, dtype=np.int64)
        s = np.ones(n)
        t = np.ones(n)
        L_B = CSR(0, 0, np.zeros(1, dtype=np.int64),
                  np.empty(0, dtype=np.int32), np.empty(0, dtype=A.dtype))
        U_B = L_B
        dvec = np.empty(0, dtype=A.dtype)
        E = CSR(n, 0, np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int32),
                np.empty(0, dtype=A.dtype))
        F = CSR(0, n, np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int32),
                np.empty(0, dtype=A.dtype))

    # --- dense last-level decision (ref factor.hpp:1212-1240) ---------------
    AmB_nnz = int(row_sizes[p_out[m:]].sum() + col_sizes[q_out[m:]].sum())
    dense_thres1 = int(max(opts.alpha_L, opts.alpha_U) * AmB_nnz)
    thres_floor = int(math.ceil(opts.c_d * N ** (1.0 / 3.0)))
    dense_thres2 = max(thres_floor,
                       2000 if opts.dense_thres <= 0 else opts.dense_thres)
    nm = n - m
    # after an AUTO retry the pivoting kernel already ran, so moderate
    # deferral flags terminate in the dense level (ref factor.hpp:1231-1235)
    to_dense = ((post_flag < 0 and (opts.pivot != PIVOTING_AUTO or use_pivot))
                or int(math.ceil(nm * nm * opts.rho)) <= dense_thres1
                or nm <= dense_thres2 or not m)
    if (to_dense and opts.dense_defer and m and post_flag >= 0
            and nm > thres_floor
            and int(math.ceil(nm * nm * opts.rho)) > dense_thres1):
        # Cost-aware refinement (deviation from ref factor.hpp:1231, opt-out
        # via dense_defer=0): the static dense_thres floor alone triggered
        # the switch, but this level factored healthily (m > 0.4*m2 is
        # guaranteed here by the post-flag analysis) and the Schur is still
        # sparse, so another sparse level is far cheaper than an O(nm^3)
        # QRCP now (the JAX package's measurement on poisson2d(256) is in
        # BASELINE.md).  Recursion terminates: every deferred level
        # shrinks the tail by >= 40% (else post_flag would have fired).
        to_dense = False

    hif_info(opts, "level %d: m=%d/%d, defers=%d (diag %d, cond %d), "
                   "drops=%d (space %d), nnz(L_B)=%d nnz(U_B)=%d, "
                   "nnz(S)=%d%s", level, m, m2, res.defers, res.diag_defers,
             res.cond_defers, res.total_drops, res.space_drops,
             L_B.nnz, U_B.nnz, 0 if S is None else S.nnz,
             ", dense tail" if to_dense and nm else "")
    p_inv = np.empty(n, dtype=np.int64)
    p_inv[p_out] = np.arange(n)
    q_inv = np.empty(n, dtype=np.int64)
    q_inv[q_out] = np.arange(n)

    prec = LevelPrec(m=m, n=n, L_B=L_B, d=dvec, U_B=U_B, E=E, F=F, s=s, t=t,
                     p=p_out, p_inv=p_inv, q=q_out, q_inv=q_inv)

    if to_dense and nm:
        prec.dense_matrix = S.todense()
        return prec, None, row_sizes, col_sizes
    if nm == 0:
        return prec, None, row_sizes, col_sizes

    # carry forward tail size references (ref factor.hpp:1243-1254)
    new_rows = row_sizes[p_out[m:]].copy()
    new_cols = col_sizes[q_out[m:]].copy()
    return prec, S, new_rows, new_cols
