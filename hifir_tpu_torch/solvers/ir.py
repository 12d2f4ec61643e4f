"""HIFIR: iterative refinement around the multilevel M-solve.

The port of ``hifir_tpu/solvers/gmres.py:ir_apply_device``.  The operator A
may be a sliced ELL, an ELL or a BSR (:mod:`..ops.spmv`,
:mod:`..ops.bsr_spmv`); the residual B - A X runs in kernel K1 with its
fused epilogue, or in K7 followed by a subtraction, on the card.  On a
CUDA pack with ``graphs`` on, :func:`ir_apply` is one captured graph for
each (A, nirs, r, shape), the counterpart of the JAX ``fori_loop``.
Each call is a ``hifir.ir`` span and adds 1 to the counter ``ir.calls``
and ``nirs`` to ``ir.msolves`` on the host, replays included.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..alg.prec import prec_solve_mrhs
from ..device import as_values
from ..graphs import cache_of
from ..ops.spmv import ell_matvec_mrhs, sliced_ell_sub_mrhs
from ..trace import add, span

__all__ = ["ir_apply", "ir_apply_mrhs", "residual_mrhs"]


def residual_mrhs(A, B: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """B - A X for blocks of shape (n, nrhs)."""
    if hasattr(A, "block_cols"):   # BSR: K7, then the subtraction
        return B - ell_matvec_mrhs(A, X)
    return sliced_ell_sub_mrhs(A, X, B)   # (sliced) ELL: K1's fused B - A X


def ir_apply_mrhs(A, levels, tail, B: torch.Tensor, nirs: int,
                  r: Optional[int] = None) -> torch.Tensor:
    """The eager refinement of B (n, nrhs) on a pack's ``levels`` and
    ``tail``: X = M^{-1} B, then nirs - 1 steps of X += M^{-1}(B - A X)."""
    X = prec_solve_mrhs(levels, tail, B, r)
    for _ in range(1, nirs):
        X = X + prec_solve_mrhs(levels, tail, residual_mrhs(A, B, X), r)
    return X


def ir_apply(A, prec, b, nirs: int, r: Optional[int] = None) -> torch.Tensor:
    """x = HIFIR(b): x = M^{-1} b, then nirs - 1 steps of x += M^{-1}(b - A x).

    ``b`` is one vector (n,) or a block (n, nrhs); ``prec`` a
    :class:`~hifir_tpu_torch.alg.prec.DevicePrec`, whose dtype and device the
    result takes.  ``r`` (> 0) overrides the dense tail's rank in every
    M-solve.  As in the JAX package, the M-solves are the bare multilevel
    solve: ``prec.nsp`` is not applied.
    """
    with span("hifir.ir"):
        cache = cache_of(prec)
        b = as_values(b, prec.dtype, prec.device)
        B = b[:, None] if b.ndim == 1 else b
        args = (A, prec.levels, prec.tail, B, nirs, r)
        X = (ir_apply_mrhs(*args) if cache is None
             else cache.call(ir_apply_mrhs, *args))
    add("ir.calls")
    add("ir.msolves", nirs)
    return X[:, 0] if b.ndim == 1 else X
