"""The configurations' matrices, made here so that the program and the
reference get the same arrays, as scipy CSR in float64 with sorted
indices.  A configuration's ``generator`` names a module of this package
(``problems/<generator>.py``) whose ``make(config)`` builds its matrix, so
that a configuration with a new operator adds a file and edits none."""

from __future__ import annotations

import importlib

import numpy as np
import scipy.sparse as sp

__all__ = ["make", "assemble"]


def assemble(n: int, diag: float, pairs) -> sp.csr_matrix:
    """A symmetric stencil operator: ``diag`` on the diagonal and -1 at
    both (r, c) and (c, r) for every index pair of ``pairs``."""
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, diag)]
    for r, c in pairs:
        for a, b in ((r, c), (c, r)):
            rows.append(a)
            cols.append(b)
            vals.append(np.full(a.size, -1.0))
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                             np.concatenate(cols))),
                      shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


def make(config: dict) -> sp.csr_matrix:
    """The matrix of a configuration file, by its ``generator``."""
    mod = importlib.import_module(f"{__name__}.{config['generator']}")
    return mod.make(config)
