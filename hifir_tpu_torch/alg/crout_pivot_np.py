"""Deferred Crout ILDU with inverse-based thresholded rook pivoting.

Behavioral counterpart of the reference pivoting kernel
(``src/hif/alg/PivotCrout.hpp`` + ``alg/pivot_factor.hpp``):
at each step the pivot pair may be improved by alternating row/column rook
exchanges (at most 4, ref ``PivotCrout.hpp:510``), accepting a candidate iff
``|d_k| < gamma * |candidate|`` and the candidate keeps the incremental
inverse-norm estimate within ``kappa`` (ref ``pivot_factor.hpp:266-277``).
Deferral still applies to pairs that no exchange can fix.

Design: unlike the non-pivoting kernel, row ids and column ids are independent
(interchanges re-pair them); the trailing diagonal cannot be maintained
incrementally, so ``d_k`` is computed on the fly (ref ``compute_dk``,
PivotCrout.hpp:64).  The reference's augmented linked lists with O(nnz-local)
interchanges (``AugCRS::interchange_cols``) are replaced by swapping entries
of explicit candidate arrays — ids never move.

Used by ``level_factorize`` when ``pivot=ON`` or on the AUTO retry after too
many dynamic deferrals (ref ``builder.hpp:552-567``).  The port's copy of
``hifir_tpu/alg/crout_pivot_np.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..ds.csr import CSR
from ..options import Options, determine_fac_pars
from .crout_np import CroutResult, _drop

__all__ = ["pivot_crout_level_np"]

_PENDING, _ACCEPTED, _DEFERRED = 0, 1, 2
_MAX_ROOK_STEPS = 4  # ref PivotCrout.hpp:510


def pivot_crout_level_np(Ahat: CSR, m2: int, level: int, opts: Options,
                         row_ref: np.ndarray, col_ref: np.ndarray
                         ) -> CroutResult:
    """Factorize the leading block with rook pivoting.  Same contract as
    :func:`hifir_tpu_torch.alg.crout_np.crout_level_np` but returns independent row
    and column orderings (``ord_final`` is a (2, n) array [rows; cols])."""
    n = Ahat.nrows
    dtype = Ahat.data.dtype
    kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U = determine_fac_pars(
        opts, level)
    gamma = opts.gamma if opts.gamma > 0 else 1.0

    Acsc = Ahat.tocsc()

    statusR = np.zeros(n, dtype=np.int8)
    statusC = np.zeros(n, dtype=np.int8)
    # candidate pairings by position; interchanges swap entries
    rowcand = np.arange(m2, dtype=np.int64)
    colcand = np.arange(m2, dtype=np.int64)
    pos_of_row = np.arange(m2, dtype=np.int64)   # row id -> position
    pos_of_col = np.arange(m2, dtype=np.int64)

    rows_of_L_j: List[List[int]] = [[] for _ in range(n)]
    rows_of_L_v: List[List[complex]] = [[] for _ in range(n)]
    cols_of_U_j: List[List[int]] = [[] for _ in range(n)]
    cols_of_U_v: List[List[complex]] = [[] for _ in range(n)]
    L_ids: List[np.ndarray] = []
    L_vals: List[np.ndarray] = []
    U_ids: List[np.ndarray] = []
    U_vals: List[np.ndarray] = []
    dvec: List[complex] = []
    kappa_u: List[complex] = []
    kappa_l: List[complex] = []
    deferredR: List[int] = []
    deferredC: List[int] = []
    diag_defers = cond_defers = 0
    space_drops = total_drops = 0

    buf_u = np.zeros(n, dtype=dtype)
    tag_u = np.full(n, -1, dtype=np.int64)
    buf_l = np.zeros(n, dtype=dtype)
    tag_l = np.full(n, -1, dtype=np.int64)

    def _kappa_new(adj_j, adj_v, kap_prev, idv):
        sm = 0.0
        for jj, vv in zip(adj_j[idv], adj_v[idv]):
            sm += kap_prev[jj] * vv
        k1 = 1.0 - sm
        k2 = -1.0 - sm
        return k2 if abs(k1) < abs(k2) else k1

    def _compute_l(ci, stamp):
        """Unscaled l over non-accepted rows (column ci), incl. the pivot row."""
        ids = []
        s_, e_ = Acsc.indptr[ci], Acsc.indptr[ci + 1]
        for r, v in zip(Acsc.indices[s_:e_], Acsc.data[s_:e_]):
            r = int(r)
            if statusR[r] != _ACCEPTED:
                buf_l[r] = v
                tag_l[r] = stamp
                ids.append(r)
        for j, ujk in zip(cols_of_U_j[ci], cols_of_U_v[ci]):
            du = dvec[j] * ujk
            for r, lv in zip(L_ids[j], L_vals[j]):
                r = int(r)
                if statusR[r] == _ACCEPTED:
                    continue
                if tag_l[r] != stamp:
                    buf_l[r] = -du * lv
                    tag_l[r] = stamp
                    ids.append(r)
                else:
                    buf_l[r] -= du * lv
        return ids

    def _compute_ut(ri, stamp):
        """Unscaled ut over non-accepted cols (row ri), incl. the pivot col."""
        ids = []
        s_, e_ = Ahat.indptr[ri], Ahat.indptr[ri + 1]
        for c, v in zip(Ahat.indices[s_:e_], Ahat.data[s_:e_]):
            c = int(c)
            if statusC[c] != _ACCEPTED:
                buf_u[c] = v
                tag_u[c] = stamp
                ids.append(c)
        for j, lkj in zip(rows_of_L_j[ri], rows_of_L_v[ri]):
            ld = lkj * dvec[j]
            for c, uv in zip(U_ids[j], U_vals[j]):
                c = int(c)
                if statusC[c] == _ACCEPTED:
                    continue
                if tag_u[c] != stamp:
                    buf_u[c] = -ld * uv
                    tag_u[c] = stamp
                    ids.append(c)
                else:
                    buf_u[c] -= ld * uv
        return ids

    step = 0
    stamp = 0
    for pos in range(m2):
        ri = int(rowcand[pos])
        ci = int(colcand[pos])

        # --- thresholded rook pivoting (ref apply_thres_pivot) -------------
        for _rook in range(_MAX_ROOK_STEPS):
            changed = False
            # column of candidates for the row interchange
            stamp += 1
            l_ids = _compute_l(ci, stamp)
            dk = buf_l[ri] if tag_l[ri] == stamp else 0.0
            best_r, best_mag = -1, abs(dk)
            for r in l_ids:
                if r == ri or r >= m2 or statusR[r] != _PENDING:
                    continue
                if pos_of_row[r] <= pos:
                    continue
                mag = abs(buf_l[r])
                if mag > best_mag:
                    best_r, best_mag = r, mag
            if best_r >= 0 and abs(dk) < gamma * best_mag:
                kl_c = _kappa_new(rows_of_L_j, rows_of_L_v, kappa_l, best_r) \
                    if step else 1.0
                if abs(kl_c) <= kappa:
                    p2 = pos_of_row[best_r]
                    rowcand[pos], rowcand[p2] = rowcand[p2], rowcand[pos]
                    pos_of_row[ri], pos_of_row[best_r] = p2, pos
                    ri = best_r
                    changed = True
            # row of candidates for the column interchange
            stamp += 1
            u_ids = _compute_ut(ri, stamp)
            dk = buf_u[ci] if tag_u[ci] == stamp else 0.0
            best_c, best_mag = -1, abs(dk)
            for c in u_ids:
                if c == ci or c >= m2 or statusC[c] != _PENDING:
                    continue
                if pos_of_col[c] <= pos:
                    continue
                mag = abs(buf_u[c])
                if mag > best_mag:
                    best_c, best_mag = c, mag
            if best_c >= 0 and abs(dk) < gamma * best_mag:
                ku_c = _kappa_new(cols_of_U_j, cols_of_U_v, kappa_u, best_c) \
                    if step else 1.0
                if abs(ku_c) <= kappa:
                    p2 = pos_of_col[best_c]
                    colcand[pos], colcand[p2] = colcand[p2], colcand[pos]
                    pos_of_col[ci], pos_of_col[best_c] = p2, pos
                    ci = best_c
                    changed = True
            if not changed:
                break

        # --- admissibility of the (possibly exchanged) pair ----------------
        stamp += 1
        u_list = _compute_ut(ri, stamp)
        dk = buf_u[ci] if tag_u[ci] == stamp else 0.0
        bad = (dk == 0) or (abs(1.0 / dk) > kappa_d)
        if not bad:
            if step:
                ku = _kappa_new(cols_of_U_j, cols_of_U_v, kappa_u, ci)
                kl = _kappa_new(rows_of_L_j, rows_of_L_v, kappa_l, ri)
            else:
                ku = kl = 1.0
            bad = abs(ku) > kappa or abs(kl) > kappa
            if bad:
                cond_defers += 1
        else:
            diag_defers += 1
        if bad:
            statusR[ri] = _DEFERRED
            statusC[ci] = _DEFERRED
            deferredR.append(ri)
            deferredC.append(ci)
            continue

        # --- accept --------------------------------------------------------
        stamp_u = stamp
        stamp += 1
        l_list = _compute_l(ci, stamp)
        # scale and drop (diag excluded from both vectors)
        ut_ids = np.array([c for c in u_list if c != ci], dtype=np.int64)
        for c in ut_ids:
            buf_u[c] /= dk
        l_ids_arr = np.array([r for r in l_list if r != ri], dtype=np.int64)
        for r in l_ids_arr:
            buf_l[r] /= dk

        ut_vals = buf_u[ut_ids] if ut_ids.size else np.empty(0, dtype=dtype)
        ut_ids, ut_vals, nn, ns = _drop(ut_ids, ut_vals, tau_U,
                                        abs(ku) * kappa_d, alpha_U,
                                        int(row_ref[ri]))
        total_drops += nn + ns
        space_drops += ns
        l_vals = buf_l[l_ids_arr] if l_ids_arr.size else np.empty(0,
                                                                  dtype=dtype)
        l_ids_arr, l_vals, nn, ns = _drop(l_ids_arr, l_vals, tau_L,
                                          abs(kl) * kappa_d, alpha_L,
                                          int(col_ref[ci]))
        total_drops += nn + ns
        space_drops += ns

        U_ids.append(ut_ids)
        U_vals.append(ut_vals)
        for c, v in zip(ut_ids, ut_vals):
            cols_of_U_j[c].append(step)
            cols_of_U_v[c].append(v)
        L_ids.append(l_ids_arr)
        L_vals.append(l_vals)
        for r, v in zip(l_ids_arr, l_vals):
            rows_of_L_j[r].append(step)
            rows_of_L_v[r].append(v)
        dvec.append(dk)
        kappa_u.append(ku)
        kappa_l.append(kl)
        statusR[ri] = _ACCEPTED
        statusC[ci] = _ACCEPTED
        step += 1

    m = step
    acc_rows = [int(rowcand[pos]) for pos in range(m2)
                if statusR[rowcand[pos]] == _ACCEPTED]
    acc_cols = [int(colcand[pos]) for pos in range(m2)
                if statusC[colcand[pos]] == _ACCEPTED]
    ord_rows = np.concatenate([
        np.array(acc_rows, dtype=np.int64),
        np.arange(m2, n, dtype=np.int64),
        np.array(deferredR, dtype=np.int64)])
    ord_cols = np.concatenate([
        np.array(acc_cols, dtype=np.int64),
        np.arange(m2, n, dtype=np.int64),
        np.array(deferredC, dtype=np.int64)])
    posR = np.empty(n, dtype=np.int64)
    posR[ord_rows] = np.arange(n)
    posC = np.empty(n, dtype=np.int64)
    posC[ord_cols] = np.arange(n)

    def _assemble(ids_list, vals_list, pos_map, primary_is_col):
        rows, cols, vals = [], [], []
        for j, (ids, vv) in enumerate(zip(ids_list, vals_list)):
            if ids.size == 0:
                continue
            pp = pos_map[ids]
            if primary_is_col:
                rows.append(pp)
                cols.append(np.full(pp.size, j, dtype=np.int64))
            else:
                rows.append(np.full(pp.size, j, dtype=np.int64))
                cols.append(pp)
            vals.append(vv)
        if rows:
            return (np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals))
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
                np.empty(0, dtype=dtype))

    lr, lc, lv = _assemble(L_ids, L_vals, posR, True)
    ur, uc, uv = _assemble(U_ids, U_vals, posC, False)
    in_B = lr < m
    L_B = CSR.from_coo(m, m, lr[in_B], lc[in_B], lv[in_B])
    L_E = CSR.from_coo(n - m, m, lr[~in_B] - m, lc[~in_B], lv[~in_B])
    in_B = uc < m
    U_B = CSR.from_coo(m, m, ur[in_B], uc[in_B], uv[in_B])
    U_F = CSR.from_coo(m, n - m, ur[~in_B], uc[~in_B] - m, uv[~in_B])

    return CroutResult(
        m=m, n=n, L_B=L_B, d=np.array(dvec, dtype=dtype), U_B=U_B,
        L_E=L_E, U_F=U_F, ord_final=np.stack([ord_rows, ord_cols]),
        defers=len(deferredR), diag_defers=diag_defers,
        cond_defers=cond_defers, space_drops=space_drops,
        total_drops=total_drops,
        kappa_u=np.array(kappa_u, dtype=dtype),
        kappa_l=np.array(kappa_l, dtype=dtype))
