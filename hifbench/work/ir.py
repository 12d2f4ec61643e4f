"""One HIFIR call of ``nrhs`` columns with ``nirs`` M-solves: the M-solves
(:mod:`hifbench.work.msolve`) and ``nirs`` - 1 residuals R = B - A X, each
reading A's entries (value plus 4-byte index) and its 4-byte row pointers,
X and B once and writing R once, at two operations an entry and column."""

from __future__ import annotations

from .msolve import msolve_work

__all__ = ["ir_work"]


def ir_work(levels, tail_n: int, n: int, nnz_a: int, nrhs: int, nirs: int,
            es: int) -> tuple:
    """``(bytes, flops)`` of one call."""
    mb, mf = msolve_work(levels, tail_n, n, nrhs, es)
    rb = nnz_a * (es + 4) + 4 * (n + 1) + 3 * n * nrhs * es
    rf = 2 * nnz_a * nrhs
    return nirs * mb + (nirs - 1) * rb, nirs * mf + (nirs - 1) * rf
