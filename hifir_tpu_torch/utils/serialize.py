"""Save and load a multilevel preconditioner as one ``.npz``.

The port's copy of ``hifir_tpu/utils/serialize.py``: a file that either
package's ``save_prec`` writes loads in the other.  The key layout:
``nlevels``, ``stats``; per level ``i``
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

__all__ = ["prec_from_arrays", "load_prec", "save_prec"]

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


def save_prec(fname, M) -> None:
    """Write the levels (and deferral counters) of a factorized
    :class:`~hifir_tpu_torch.api.HIF` to ``fname`` (``.npz``)."""
    payload = {"nlevels": np.int64(len(M.precs)), "stats": M.stats_}
    for i, prec in enumerate(M.precs):
        payload[f"l{i}_mn"] = np.array([prec.m, prec.n], dtype=np.int64)
        for f in _MAT_FIELDS:
            mat = getattr(prec, f)
            payload[f"l{i}_{f}_indptr"] = mat.indptr
            payload[f"l{i}_{f}_indices"] = mat.indices
            payload[f"l{i}_{f}_data"] = mat.data
            payload[f"l{i}_{f}_shape"] = np.array(mat.shape, dtype=np.int64)
        for f in _VEC_FIELDS:
            payload[f"l{i}_{f}"] = getattr(prec, f)
        if prec.dense_matrix is not None:
            payload[f"l{i}_dense"] = prec.dense_matrix
            if prec.dense_solver is not None:
                payload[f"l{i}_dense_kind"] = np.array(prec.dense_solver.kind)
    np.savez_compressed(fname, **payload)


def load_prec(path):
    """Read a ``.npz`` written by ``save_prec`` into a
    :class:`~hifir_tpu_torch.api.HIF`."""
    from ..api import HIF

    with np.load(path, allow_pickle=False) as z:
        M = HIF(prec_from_arrays(z))
        if "stats" in z:
            M.stats_ = z["stats"].copy()
    return M
