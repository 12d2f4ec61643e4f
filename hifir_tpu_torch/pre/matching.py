"""Maximum-product bipartite matching with scaling (MC64 job-5 equivalent).

The reference vendors a C++ translation of HSL MC64 (Duff & Koster 2001,
``src/hif/pre/equilibrate.hpp:30,712``).  This module is a
from-scratch implementation of the same published algorithm: a min-cost
perfect matching on costs ``c_ij = log(max_i|a_ij| / |a_ij|)`` solved by
successive shortest augmenting paths (Dijkstra with dual potentials), whose
dual variables yield row/column scalings making matched entries +-1 and all
entries <= 1 in magnitude.

The port's copy of ``hifir_tpu/pre/matching.py``.  This Python version is
the correctness anchor; the native host library's C++ MC64, with the same
semantics, runs whenever the library is loaded.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

from ..ds.csr import CSR

__all__ = ["mc64_matching", "do_matching"]


def mc64_matching(A: CSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Compute matching and scalings for a square sparse matrix.

    Returns ``(p, s, t, info)`` where ``p[j]`` is the row matched to column
    ``j`` (so ``(diag(s) A diag(t))[p[j], j]`` has magnitude 1), ``s``/``t``
    are row/column scalings, and ``info`` is 0 on success, 1 if structurally
    singular (ref MC64 flag semantics, ``pre/EqlDriver.hpp:99-110``).
    """
    n = A.nrows
    assert A.ncols == n, "matching requires a square matrix"
    # column-wise access
    AT = A.tocsc()  # CSR of A^T: row j holds column j of A
    indptr, rows, vals = AT.indptr, AT.indices, AT.data

    absv = np.abs(vals)
    # per-column max magnitude
    cmax = np.zeros(n)
    for j in range(n):
        s_, e_ = indptr[j], indptr[j + 1]
        if e_ > s_:
            cmax[j] = absv[s_:e_].max()
    info = 0
    # cost per entry; exact zeros get +inf (cannot be matched)
    with np.errstate(divide="ignore"):
        logs = np.where(absv > 0.0, np.log(absv), -np.inf)
    cost = np.empty_like(absv)
    for j in range(n):
        s_, e_ = indptr[j], indptr[j + 1]
        if e_ > s_ and cmax[j] > 0.0:
            cost[s_:e_] = np.log(cmax[j]) - logs[s_:e_]
        else:
            cost[s_:e_] = np.inf

    INF = np.inf
    u = np.zeros(n)  # column potentials
    v = np.zeros(n)  # row potentials
    match_col = np.full(n, -1, dtype=np.int64)  # col -> row
    match_row = np.full(n, -1, dtype=np.int64)  # row -> col

    # cheap greedy initialization on zero-reduced-cost entries (c_ij == 0 is
    # the column-max entry); mirrors MC64's initial extreme matching phase
    for j in range(n):
        s_, e_ = indptr[j], indptr[j + 1]
        for k in range(s_, e_):
            i = rows[k]
            if cost[k] == 0.0 and match_row[i] < 0:
                match_col[j] = i
                match_row[i] = j
                break

    dist = np.empty(n)
    pred = np.empty(n, dtype=np.int64)

    for j0 in range(n):
        if match_col[j0] >= 0:
            continue
        # Dijkstra for shortest augmenting path from column j0
        dist.fill(INF)
        pred.fill(-1)
        heap = []
        scanned_rows = []
        scanned_cols = [j0]
        in_tree = np.zeros(n, dtype=bool)  # rows finalized
        minval = 0.0
        cur_col = j0
        sink = -1
        while True:
            s_, e_ = indptr[cur_col], indptr[cur_col + 1]
            ucur = u[cur_col]
            for k in range(s_, e_):
                i = rows[k]
                if in_tree[i] or cost[k] == INF:
                    continue
                nd = minval + cost[k] - ucur - v[i]
                if nd < dist[i]:
                    dist[i] = nd
                    pred[i] = cur_col
                    heapq.heappush(heap, (nd, i))
            # extract closest unfinalized row
            while heap:
                d_, i_ = heapq.heappop(heap)
                if not in_tree[i_] and d_ <= dist[i_]:
                    break
            else:
                break  # no augmenting path
            minval = d_
            in_tree[i_] = True
            scanned_rows.append(i_)
            if match_row[i_] < 0:
                sink = i_
                break
            cur_col = match_row[i_]
            scanned_cols.append(cur_col)
        if sink < 0:
            info = 1
            continue
        # update potentials to keep reduced costs >= 0
        u[j0] += minval
        for j in scanned_cols:
            if j != j0:
                u[j] += minval - dist[match_col[j]]
        for i in scanned_rows:
            v[i] += dist[i] - minval
        # augment along predecessor chain
        i = sink
        while True:
            j = pred[i]
            nxt = match_col[j]
            match_col[j] = i
            match_row[i] = j
            if j == j0:
                break
            i = nxt

    # fill unmatched (structurally singular) with arbitrary free rows
    if info:
        free_rows = [i for i in range(n) if match_row[i] < 0]
        k = 0
        for j in range(n):
            if match_col[j] < 0:
                match_col[j] = free_rows[k]
                match_row[free_rows[k]] = j
                k += 1

    # scalings from dual potentials
    with np.errstate(over="ignore"):
        s_row = np.exp(v)
        t_col = np.where(cmax > 0.0, np.exp(u) / np.where(cmax > 0, cmax, 1.0),
                         1.0)
    # guard rows untouched by any finite cost
    s_row[~np.isfinite(s_row)] = 1.0
    t_col[~np.isfinite(t_col)] = 1.0
    if np.any(s_row > 1e300) or np.any(t_col > 1e300):
        info = max(info, 2)
    return match_col, s_row, t_col, info


def do_matching(B: CSR, is_symm: bool, pre_scale: int = 0):
    """Matching driver (ref ``pre/EqlDriver.hpp:69-133``).

    Applies the optional a-priori scaling, runs the matching kernel and folds
    its scalings in; for symmetric systems the permutation is shared and the
    scalings symmetrized as sqrt(s*t).

    Returns ``(p, q, s, t, info)`` with ``p`` the row permutation (``p[i]`` =
    row matched to column ``i``) and ``q`` identity for asymmetric inputs.
    """
    from .scaling import iterative_scale, scale_extreme_values, scale_eye

    n = B.nrows
    if pre_scale == 0:
        B2, s, t = scale_eye(B)
    elif pre_scale == 1:
        B2, s, t = scale_extreme_values(B, is_symm)
    else:
        B2, s, t = iterative_scale(B, is_symm=is_symm)

    from . import _native

    if _native.available():
        p, ms, mt, info = _native.mc64(B2)
    else:
        p, ms, mt, info = mc64_matching(B2)
    s = s * ms
    t = t * mt
    if is_symm:
        q = p.copy()
        s = np.sqrt(s * t)
        t = s.copy()
    else:
        q = np.arange(n, dtype=np.int64)
    return p, q, s, t, info
