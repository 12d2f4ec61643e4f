"""The host factorization as plain arrays, for the reference and the
operation counts.

The reference cannot factorize a 1M-row operator again within a run, so it
follows the program from the program's own host factorization (PERF.md,
"How correct is decided"): this module copies each level of
``HIF.precs`` (read by attribute, nothing of the program imported) into
scipy and numpy arrays.  The stage this skips, the factorize, is checked
by itself (:func:`hifbench.compare.factorization`: ``fact_gap`` and the
shape the configuration states)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["host_levels"]


def _csr(T) -> sp.csr_matrix:
    return sp.csr_matrix((np.asarray(T.data), np.asarray(T.indices),
                          np.asarray(T.indptr)), shape=(T.nrows, T.ncols))


def host_levels(precs) -> tuple:
    """``(levels, tail)``: one dict a level (m, n; L and U the strict
    factors, E, F as scipy CSR; d, s, t; the permutations p, q and their
    inverses) and the last level's dense Schur complement (None when there
    is none)."""
    levels = []
    for h in precs:
        levels.append(dict(
            m=int(h.m), n=int(h.n), L=_csr(h.L_B), U=_csr(h.U_B),
            E=_csr(h.E), F=_csr(h.F), d=np.asarray(h.d), s=np.asarray(h.s),
            t=np.asarray(h.t), p=np.asarray(h.p, np.int64),
            q=np.asarray(h.q, np.int64), p_inv=np.asarray(h.p_inv, np.int64),
            q_inv=np.asarray(h.q_inv, np.int64)))
    dense = precs[-1].dense_matrix
    return levels, None if dense is None else np.asarray(dense)
