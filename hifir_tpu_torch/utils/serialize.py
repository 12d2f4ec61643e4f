"""Load a multilevel preconditioner saved by ``hifir_tpu.utils.serialize``.

The key layout is the one ``save_prec`` writes: ``nlevels``; per level ``i``
``l{i}_mn``, ``l{i}_{L_B,U_B,E,F}_{indptr,indices,data,shape}``,
``l{i}_{d,s,t,p,p_inv,q,q_inv}`` and, on the last level, ``l{i}_dense`` with
``l{i}_dense_kind``.  The dense tail is factorized again on load, as the
JAX package's ``load_prec`` does.
"""

from __future__ import annotations

from typing import List, Mapping

import numpy as np

from ..alg.level import LevelPrec
from ..ds.csr import CSR
from ..small_scale.dense import DENSE_SOLVERS

__all__ = ["prec_from_arrays", "load_prec"]

_MAT_FIELDS = ("L_B", "U_B", "E", "F")
_VEC_FIELDS = ("d", "s", "t", "p", "p_inv", "q", "q_inv")


def prec_from_arrays(d: Mapping[str, np.ndarray]) -> List[LevelPrec]:
    """Rebuild the levels from the arrays of a ``save_prec`` payload."""
    precs = []
    for i in range(int(d["nlevels"])):
        m, n = (int(v) for v in d[f"l{i}_mn"])
        mats = {}
        for f in _MAT_FIELDS:
            shape = d[f"l{i}_{f}_shape"]
            mats[f] = CSR(int(shape[0]), int(shape[1]),
                          d[f"l{i}_{f}_indptr"], d[f"l{i}_{f}_indices"],
                          d[f"l{i}_{f}_data"])
        vecs = {f: np.array(d[f"l{i}_{f}"]) for f in _VEC_FIELDS}
        prec = LevelPrec(m=m, n=n, **mats, **vecs)
        if f"l{i}_dense" in d:
            prec.dense_matrix = np.array(d[f"l{i}_dense"])
            kind = (str(d[f"l{i}_dense_kind"]) if f"l{i}_dense_kind" in d
                    else "qrcp")
            solver = DENSE_SOLVERS[kind]()
            solver.factorize(prec.dense_matrix)
            prec.dense_solver = solver
        precs.append(prec)
    return precs


def load_prec(path):
    """Read a ``.npz`` written by ``save_prec`` into a
    :class:`~hifir_tpu_torch.api.HIF`."""
    from ..api import HIF

    with np.load(path, allow_pickle=False) as z:
        return HIF(prec_from_arrays(z))
