"""Fill-reducing orderings (ref ``src/hif/pre/reordering.hpp``,
``pre/amd.hpp``, ``pre/rcm.hpp``).

The port's copy of the numpy paths of ``hifir_tpu/pre/ordering.py``.  The
JAX package runs AMD (approximate minimum degree) in its native C++ library
and falls back to scipy's reverse Cuthill-McKee without it; the port has no
native host library yet, so its ``run_amd`` is RCM until the native kernels
are ported, exactly as the JAX package is without its library.  Input is the
(sorted, symmetric-pattern) leading-block graph.
"""

from __future__ import annotations

import numpy as np

from ..ds.csr import CSR

__all__ = ["run_amd", "run_rcm", "symmetrize_pattern"]


def symmetrize_pattern(B: CSR) -> CSR:
    """Pattern of B + B^T with unit values (orderings need symmetric graphs)."""
    S = B.to_scipy()
    P = (S + S.T).tocsr()
    P.data = np.ones_like(P.data)
    P.sort_indices()
    return CSR(B.nrows, B.ncols, P.indptr.astype(np.int64), P.indices, P.data)


def run_rcm(B: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized pattern (scipy's
    ``reverse_cuthill_mckee``)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    P = symmetrize_pattern(B)
    return np.asarray(
        reverse_cuthill_mckee(P.to_scipy(), symmetric_mode=True),
        dtype=np.int64)


def run_amd(B: CSR) -> np.ndarray:
    """The ``REORDER_AMD`` ordering: reverse Cuthill-McKee until the native
    AMD kernel is ported (the JAX package's fallback without its native
    library)."""
    return run_rcm(B)
