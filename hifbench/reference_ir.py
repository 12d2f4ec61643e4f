"""The plain reference of HIFIR, the refined apply, in numpy and scipy:
X = M^{-1} B, then ``nirs`` - 1 steps of X += M^{-1} (B - A X), each
M-solve :func:`hifbench.reference.msolve` of the host factorization
prepared in one precision (:class:`hifbench.reference.Prec`).

It imports neither jax, nor hifir_tpu, nor anything of hifir_tpu_torch."""

from __future__ import annotations

import numpy as np

from .reference import Prec, msolve

__all__ = ["hifir"]


def hifir(P: Prec, A, B: np.ndarray, nirs: int) -> np.ndarray:
    """HIFIR(B) for B of shape (n,) or (n, k) in ``P``'s precision, A a
    scipy sparse matrix (cast to that precision)."""
    A = A.astype(P.dtype)
    B = np.asarray(B, dtype=P.dtype)
    X = msolve(P, B)
    for _ in range(1, nirs):
        X = X + msolve(P, B - A @ X)
    return X
