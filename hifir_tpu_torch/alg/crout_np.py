"""Deferred Crout incomplete LDU — host reference kernel (numpy).

This is the correctness anchor for one level of the HIF factorization,
behaviorally matching the reference hot loop
(``src/hif/alg/factor.hpp:803-1004`` with the Crout kernels in
``alg/Crout.hpp``): inverse-based condition estimation (kappa recurrence),
dynamic deferral of bad pivots to the tail, dual dropping (inverse-threshold +
scalability-oriented top-k), and the trailing diagonal update.

The data-structure design is deliberately different from the reference: instead
of augmented linked lists with lazy index rotation (``ds/AugmentedStorage.hpp``)
we factor in a *stable id space* — ids are positions in the post-preprocessing
ordering and never move; deferral only affects the final ordering, computed at
the end.  Dual adjacency (``rows_of_L``/``cols_of_U``) provides the cross-major
traversals that the reference gets from linked lists.

The port's copy of ``hifir_tpu/alg/crout_np.py``, the correctness anchor:
the native host library's C++ kernel (``native/src/crout.cpp``) mirrors it
and runs instead whenever the library is loaded and ``Options.use_native``
is set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from ..ds.csr import CSR
from ..options import Options, determine_fac_pars

__all__ = ["crout_level_np", "CroutResult"]

_PENDING, _ACCEPTED, _DEFERRED = 0, 1, 2


@dataclasses.dataclass
class CroutResult:
    """Raw per-level factorization output in final-position index space."""

    m: int                        # final leading block size
    n: int
    L_B: CSR                      # strictly-lower m x m CSR (unit diag implied)
    d: np.ndarray                 # diagonal, length m
    U_B: CSR                      # strictly-upper m x m CSR
    L_E: CSR                      # (n-m) x m tail rows of L
    U_F: CSR                      # m x (n-m) tail columns of U
    ord_final: np.ndarray         # final ordering: position -> id
    defers: int
    diag_defers: int
    cond_defers: int
    space_drops: int
    total_drops: int
    kappa_u: np.ndarray
    kappa_l: np.ndarray


def _drop(ids: np.ndarray, vals: np.ndarray, tau: float, kap: float,
          alpha: float, nnz_ref: int):
    """Dual dropping (ref ``alg/thresholds.hpp:49,72``).

    Numerical: drop ``|v| <= tau / kap`` (inverse-based).  Space: keep the
    ``ceil(alpha * nnz_ref)`` largest magnitudes.  Returns kept (ids, vals,
    n_num_dropped, n_space_dropped).
    """
    n0 = ids.size
    if tau > 0.0 and kap > 0.0:
        keep = np.abs(vals) > tau / kap
        ids, vals = ids[keep], vals[keep]
    n_num = n0 - ids.size
    n_space = 0
    if alpha > 0.0:
        cap = int(math.ceil(alpha * nnz_ref))
        if cap < 1:
            cap = 1
        if ids.size > cap:
            # deterministic top-k: primary |v| descending, ties by id
            # ascending — the native drop_vec uses the same total order, so
            # kept SETS (and kept order) are bit-identical under exact ties
            sel = np.lexsort((ids, -np.abs(vals)))[:cap]
            n_space = ids.size - cap
            ids, vals = ids[sel], vals[sel]
    return ids, vals, n_num, n_space


def _drop_tail(ids: np.ndarray, vals: np.ndarray, tau: float, kap: float,
               alpha: float, nnz_ref: int, start_size: int):
    """Dropping for the *tail* part of l in the pattern-symmetric mirror mode:
    the mirrored leading entries count against the space cap (ref
    ``apply_space_dropping`` start_size arg, ``thresholds.hpp:72-86``; call
    site ``factor.hpp:957-963``)."""
    n0 = ids.size
    if tau > 0.0 and kap > 0.0:
        keep = np.abs(vals) > tau / kap
        ids, vals = ids[keep], vals[keep]
    n_num = n0 - ids.size
    n_space = 0
    if alpha > 0.0:
        cap_total = int(math.ceil(alpha * nnz_ref))
        if start_size >= cap_total:
            cap_total = start_size + 1
        cap = cap_total - start_size
        if ids.size > cap:
            # deterministic top-k (see _drop)
            sel = np.lexsort((ids, -np.abs(vals)))[:cap]
            n_space = ids.size - cap
            ids, vals = ids[sel], vals[sel]
    return ids, vals, n_num, n_space


def crout_level_np(Ahat: CSR, d0: np.ndarray, m2: int, level: int,
                   opts: Options, row_ref: np.ndarray, col_ref: np.ndarray,
                   symm_mode: int = 0) -> CroutResult:
    """Factorize the leading block of a permuted/scaled level matrix.

    Parameters
    ----------
    Ahat:
        Permuted scaled level matrix ``(diag(s) A diag(t))[p, q]`` indexed by
        ids (positions in the post-preprocessing ordering).
    d0:
        Initial diagonal ``Ahat[i, i]`` for ids ``i < m2`` (ref
        ``extract_perm_diag``, factor.hpp:130).
    m2:
        Leading block size after static deferral.
    row_ref / col_ref:
        Per-id nnz references for space dropping: ``row_sizes[p[id]]`` and
        ``col_sizes[q[id]]`` in reference terms (ref factor.hpp:939,956).
    symm_mode:
        0 = general LDU.  1 = LDLᵀ (``opts.is_symm``, real input): ut is
        never computed — each U row is the mirror of the kept l column
        (U = Lᵀ), ``kappa_u = kappa_l``, and the trailing diagonal update is
        ``d[c] -= (l[c]/dk) * l[c]`` on the *unscaled* column (ref
        ``factor.hpp:818-820,906-931`` for the ``IsSymm`` LDLᵀ variant; the
        native kernel's mode 1 — this anchor is its spec).
        3 = Hermitian LDL^H (complex ``opts.is_symm`` with A == A^H): the
        LDL^T walk with three conjugations — the U[:, idk] multiplier is
        ``conj(L[idk, j])``, the trailing diagonal update is
        ``d[r] -= (l[r]/dk) * conj(l[r])`` (d stays exactly real), and the
        mirrored U rows store ``conj(l)`` so U = L^H.  NOTE this is a
        deliberate deviation: the reference's own is_symm on complex input
        produces a broken preconditioner (measured err ~1 vs 5e-16 on its
        general path for both Hermitian and complex-symmetric input; its
        Crout loop never conjugates while its finalize transposes do —
        symm_factor.hpp:522,551).
        2 = pattern-symmetric *mirror* mode, matching the
        reference's ``level_factorize<IsSymm=true>`` instantiation (used for
        levels <= 2 when the pattern is >= nzp_thres symmetric and q == p,
        s == t from symmetric preprocessing): only ut is computed; the
        leading-block part of each L column is the mirror of the kept ut
        (so ``L_B == U_B^T``); only the tail part of l (static tail +
        dynamically deferred ids) is computed and dropped, with the mirrored
        count charged against the space cap; ``kappa_l = kappa_ut``; the
        trailing diagonal update uses ut alone (ref ``Crout.hpp:613-630``,
        ``compute_l<IsSymm>`` ``Crout.hpp:271-356``, ``_load_acol<IsSymm>``
        ``Crout.hpp:803-850``, call sites ``factor.hpp:903-983``).  On
        deferral the mirrored entries of the deferred id spill into the tail
        views (the reference gets this from its index-rotation machinery).
    """
    n = Ahat.nrows
    dtype = Ahat.data.dtype
    mirror = symm_mode == 2
    herm = symm_mode == 3
    ldlt = symm_mode == 1 or herm
    kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U = determine_fac_pars(
        opts, level)

    Acsc = Ahat.tocsc()

    d = np.array(d0, copy=True)
    status = np.zeros(n, dtype=np.int8)
    # dual adjacency: rows_of_L[id] = [(step j, L[id, j])], cols_of_U likewise
    rows_of_L_j: List[List[int]] = [[] for _ in range(n)]
    rows_of_L_v: List[List[complex]] = [[] for _ in range(n)]
    cols_of_U_j: List[List[int]] = [[] for _ in range(n)]
    cols_of_U_v: List[List[complex]] = [[] for _ in range(n)]
    # accepted columns of L / rows of U, by step
    L_ids: List[np.ndarray] = []
    L_vals: List[np.ndarray] = []
    U_ids: List[np.ndarray] = []
    U_vals: List[np.ndarray] = []
    dvec: List[complex] = []
    kappa_u: List[complex] = []
    kappa_l: List[complex] = []
    deferred: List[int] = []
    # mirror mode: tail view of each L column (ids >= m2 or deferred); the
    # leading part is implicit (mirror of the kept ut => L_B = U_B^T)
    Ltail_r: List[List[int]] = []
    Ltail_v: List[List[complex]] = []

    def _spill_mirror(idv: int) -> None:
        """On deferral of a pending id, its mirrored L entries move from the
        leading parts to the tail views of their columns (the reference's
        defer_entry index rotation achieves the same, Crout.hpp:681)."""
        for jj, vv in zip(cols_of_U_j[idv], cols_of_U_v[idv]):
            Ltail_r[jj].append(idv)
            Ltail_v[jj].append(vv)

    diag_defers = cond_defers = 0
    space_drops = total_drops = 0

    # dense scatter workspaces (analog of SparseVector dense tags,
    # ds/SparseVec.hpp:247); one pair per vector
    buf_u = np.zeros(n, dtype=dtype)
    tag_u = np.full(n, -1, dtype=np.int64)
    buf_l = np.zeros(n, dtype=dtype)
    tag_l = np.full(n, -1, dtype=np.int64)

    def _kappa_new(adj_j, adj_v, kap_prev, idv):
        """Incremental inverse-norm estimate (ref ``Crout.hpp:486-516``).

        The walk is newest-step-first: the native kernel's adjacency lists
        prepend (Adj::add), and 3+-term sums round differently per order —
        matching the traversal order keeps anchor==native bit-identical.
        """
        sm = 0.0
        for jj, vv in zip(reversed(adj_j[idv]), reversed(adj_v[idv])):
            sm += kap_prev[jj] * vv
        k1 = 1.0 - sm
        k2 = -1.0 - sm
        return k2 if abs(k1) < abs(k2) else k1

    # per-Crout-step streamer (ref builder.hpp:266-267 + the Crout_info
    # calls in factor.hpp:803-1004; compiled to a no-op unless VERBOSE_FAC)
    from ..options import VERBOSE_FAC
    from ..utils.log import hif_info

    stream = bool(opts.verbose & VERBOSE_FAC)

    step = 0
    for idk in range(m2):
        if stream:
            hif_info(opts, " Crout step %d (id %d), defers=%d", step, idk,
                     len(deferred), tag="fac")
        # --- pivot admissibility (ref factor.hpp:806-871) ---
        dk = d[idk]
        if dk == 0 or abs(1.0 / dk) > kappa_d:
            diag_defers += 1
            status[idk] = _DEFERRED
            deferred.append(idk)
            if mirror:
                _spill_mirror(idk)
            continue
        if step:
            if ldlt:
                # LDLᵀ: one kappa recurrence serves both sides
                # (ref factor.hpp:818-820); LDL^H: kappa_u = conj(kappa_l)
                # (U = L^H makes the U-side recurrence the conjugate of the
                # L-side one, inductively)
                kl = _kappa_new(rows_of_L_j, rows_of_L_v, kappa_l, idk)
                ku = np.conj(kl) if herm else kl
            else:
                ku = _kappa_new(cols_of_U_j, cols_of_U_v, kappa_u, idk)
                kl = ku if mirror else _kappa_new(rows_of_L_j, rows_of_L_v,
                                                  kappa_l, idk)
        else:
            ku = kl = 1.0
        if abs(ku) > kappa or abs(kl) > kappa:
            cond_defers += 1
            status[idk] = _DEFERRED
            deferred.append(idk)
            if mirror:
                _spill_mirror(idk)
            continue

        # --- accepted: compute ut = Ahat[idk, rest] - L[idk,:] D U[:, rest]
        # (ref Crout.hpp:169); skipped for LDLᵀ (U = Lᵀ) ---
        ut_list: List[int] = []
        if not ldlt:
            s_, e_ = Ahat.indptr[idk], Ahat.indptr[idk + 1]
            for c, v in zip(Ahat.indices[s_:e_], Ahat.data[s_:e_]):
                c = int(c)
                if status[c] != _ACCEPTED and c != idk:
                    buf_u[c] = v
                    tag_u[c] = step
                    ut_list.append(c)
            # in mirror mode L[idk, :] (leading row of a pending id) is the
            # mirror of U[:, idk], so the adjacency to traverse is cols_of_U
            row_adj_j = cols_of_U_j[idk] if mirror else rows_of_L_j[idk]
            row_adj_v = cols_of_U_v[idk] if mirror else rows_of_L_v[idk]
            # newest-first to match the native prepend-list walk
            # (see _kappa_new)
            for j, lkj in zip(reversed(row_adj_j), reversed(row_adj_v)):
                ld = lkj * dvec[j]
                for c, uv in zip(U_ids[j], U_vals[j]):
                    c = int(c)
                    if status[c] == _ACCEPTED or c == idk:
                        continue
                    if tag_u[c] != step:
                        buf_u[c] = -ld * uv
                        tag_u[c] = step
                        ut_list.append(c)
                    else:
                        buf_u[c] -= ld * uv

        # --- compute l = Ahat[rest, idk] - L[rest,:] D U[:, idk]
        # (ref Crout.hpp:271); mirror mode computes only the tail part
        # (ids >= m2 or deferred) against the tail views of L ---
        l_list: List[int] = []
        s_, e_ = Acsc.indptr[idk], Acsc.indptr[idk + 1]
        for r, v in zip(Acsc.indices[s_:e_], Acsc.data[s_:e_]):
            r = int(r)
            if mirror:
                if r < m2 and status[r] != _DEFERRED:
                    continue
            elif status[r] == _ACCEPTED or r == idk:
                continue
            buf_l[r] = v
            tag_l[r] = step
            l_list.append(r)
        # LDLᵀ: U[:, idk] is the mirror of L[idk, :], so the adjacency to
        # traverse is rows_of_L (the native mode-1 kernel does the same)
        col_adj_j = rows_of_L_j[idk] if ldlt else cols_of_U_j[idk]
        col_adj_v = rows_of_L_v[idk] if ldlt else cols_of_U_v[idk]
        for j, ujk in zip(reversed(col_adj_j), reversed(col_adj_v)):
            # LDL^H: U[j, idk] = conj(L[idk, j])
            du = dvec[j] * (np.conj(ujk) if herm else ujk)
            tail_r = Ltail_r[j] if mirror else L_ids[j]
            tail_v = Ltail_v[j] if mirror else L_vals[j]
            for r, lv in zip(tail_r, tail_v):
                r = int(r)
                if status[r] == _ACCEPTED or r == idk:
                    continue
                if tag_l[r] != step:
                    buf_l[r] = -du * lv
                    tag_l[r] = step
                    l_list.append(r)
                else:
                    buf_l[r] -= du * lv

        # --- diagonal scaling + trailing diag update (ref Crout.hpp:646,542,
        # order per factor.hpp:906-931: scale ut, update diag, scale l) ---
        for c in ut_list:
            buf_u[c] /= dk
        if ldlt:
            # d[c] -= (l[c]/dk) * l[c] on the unscaled column, exactly the
            # native mode-1 order (scale-one-factor then multiply);
            # LDL^H conjugates the second factor (update stays exactly real
            # when dk is real: l*conj(l) has fp-exact zero imaginary part)
            for r in l_list:
                if r < m2 and status[r] == _PENDING:
                    d[r] -= (buf_l[r] / dk) * (np.conj(buf_l[r]) if herm
                                               else buf_l[r])
        elif mirror:
            # d[c] -= dk * ut_scaled[c]^2 (ref update_diag<true>,
            # Crout.hpp:613-630; no conjugation — symmetric, not Hermitian)
            for c in ut_list:
                if c < m2 and status[c] == _PENDING:
                    d[c] -= dk * buf_u[c] * buf_u[c]
        else:
            # d[c] -= ut_scaled[c] * l_unscaled[c] for pending ids in block
            if len(ut_list) <= len(l_list):
                it, other_tag = ut_list, tag_l
            else:
                it, other_tag = l_list, tag_u
            for c in it:
                if c < m2 and status[c] == _PENDING and other_tag[c] == step:
                    d[c] -= buf_u[c] * buf_l[c]
        for r in l_list:
            buf_l[r] /= dk

        # --- dropping (ref factor.hpp:936-996) ---
        ut_ids = np.array(ut_list, dtype=np.int64)
        ut_vals = buf_u[ut_ids] if ut_ids.size else np.empty(0, dtype=dtype)
        ut_ids, ut_vals, nn, ns = _drop(ut_ids, ut_vals, tau_U,
                                        abs(ku) * kappa_d, alpha_U,
                                        int(row_ref[idk]))
        total_drops += nn + ns
        space_drops += ns

        l_ids = np.array(l_list, dtype=np.int64)
        l_vals = buf_l[l_ids] if l_ids.size else np.empty(0, dtype=dtype)
        if mirror:
            n_lead = int(np.count_nonzero(
                (ut_ids < m2) & (status[ut_ids] == _PENDING)
            )) if ut_ids.size else 0
            l_ids, l_vals, nn, ns = _drop_tail(l_ids, l_vals, tau_L,
                                               abs(kl) * kappa_d, alpha_L,
                                               int(col_ref[idk]), n_lead)
        else:
            l_ids, l_vals, nn, ns = _drop(l_ids, l_vals, tau_L,
                                          abs(kl) * kappa_d, alpha_L,
                                          int(col_ref[idk]))
        total_drops += nn + ns
        space_drops += ns

        # --- store and update adjacency ---
        if ldlt:
            # U row = kept l entries (U = Lᵀ; conj for LDL^H so U = L^H);
            # cols_of_U is never traversed in this mode, so no adjacency
            # update on the U side
            U_ids.append(l_ids)
            U_vals.append(np.conj(l_vals) if herm else l_vals)
        else:
            U_ids.append(ut_ids)
            U_vals.append(ut_vals)
            for c, v in zip(ut_ids, ut_vals):
                cols_of_U_j[c].append(step)
                cols_of_U_v[c].append(v)
        if mirror:
            Ltail_r.append(list(l_ids))
            Ltail_v.append(list(l_vals))
        else:
            L_ids.append(l_ids)
            L_vals.append(l_vals)
            for r, v in zip(l_ids, l_vals):
                rows_of_L_j[r].append(step)
                rows_of_L_v[r].append(v)
        dvec.append(dk)
        kappa_u.append(ku)
        kappa_l.append(kl)
        status[idk] = _ACCEPTED
        step += 1

    m = step
    # final ordering: accepted ids in acceptance order, then the static tail,
    # then dynamically deferred ids in deferral order (ref compress_tails +
    # the post-loop gap compression, factor.hpp:1007-1027)
    acc_ids = np.flatnonzero(status == _ACCEPTED)
    # acceptance order == id order for accepted (we sweep ids in order)
    ord_final = np.concatenate([
        acc_ids,
        np.arange(m2, n, dtype=np.int64),
        np.array(deferred, dtype=np.int64),
    ])
    pos = np.empty(n, dtype=np.int64)
    pos[ord_final] = np.arange(n)

    # assemble L (n x m) and U (m x n) in final positions, then split
    def _assemble(ids_list, vals_list, primary_is_col: bool):
        rows, cols, vals = [], [], []
        for j, (ids, vv) in enumerate(zip(ids_list, vals_list)):
            if ids.size == 0:
                continue
            pp = pos[ids]
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

    if mirror:
        # materialize L columns: leading part = mirror of the accepted kept
        # ut entries (=> L_B = U_B^T), tail part = the tail views
        for j in range(m):
            acc = status[U_ids[j]] == _ACCEPTED if U_ids[j].size else \
                np.zeros(0, dtype=bool)
            L_ids.append(np.concatenate([
                U_ids[j][acc], np.array(Ltail_r[j], dtype=np.int64)]))
            L_vals.append(np.concatenate([
                U_vals[j][acc], np.array(Ltail_v[j], dtype=dtype)]))

    lr, lc, lv = _assemble(L_ids, L_vals, primary_is_col=True)
    ur, uc, uv = _assemble(U_ids, U_vals, primary_is_col=False)

    in_B = lr < m
    L_B = CSR.from_coo(m, m, lr[in_B], lc[in_B], lv[in_B])
    L_E = CSR.from_coo(n - m, m, lr[~in_B] - m, lc[~in_B], lv[~in_B])
    in_B = uc < m
    U_B = CSR.from_coo(m, m, ur[in_B], uc[in_B], uv[in_B])
    U_F = CSR.from_coo(m, n - m, ur[~in_B], uc[~in_B] - m, uv[~in_B])

    return CroutResult(
        m=m, n=n, L_B=L_B, d=np.array(dvec, dtype=dtype), U_B=U_B,
        L_E=L_E, U_F=U_F, ord_final=ord_final,
        defers=len(deferred), diag_defers=diag_defers,
        cond_defers=cond_defers, space_drops=space_drops,
        total_drops=total_drops,
        kappa_u=np.array(kappa_u, dtype=dtype),
        kappa_l=np.array(kappa_l, dtype=dtype),
    )
