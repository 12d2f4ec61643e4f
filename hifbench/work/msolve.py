"""One multilevel M-solve X = M^{-1} B of ``nrhs`` columns.

Bytes: each operand the algorithm needs, read once: every level's L, U, E
and F entries as value plus 4-byte index, with their 4-byte row pointers;
the dense tail (one nt x nt matrix); B read once and X written once.
Operations: two a stored entry and column for each use (L and U are applied
twice a level, on the way down and up; E and F once), and the tail's two
dense products."""

from __future__ import annotations

__all__ = ["msolve_work"]


def msolve_work(levels, tail_n: int, n: int, nrhs: int, es: int) -> tuple:
    """``(bytes, flops)`` of one M-solve; ``levels`` the host levels
    (:func:`hifbench.hostprec.host_levels`), ``es`` the value's bytes."""
    nbytes = flops = 0
    for lv in levels:
        m, nl = lv["m"], lv["n"]
        nnz = {k: int(lv[k].nnz) for k in "LUEF"}
        nbytes += sum(nnz.values()) * (es + 4)
        nbytes += 4 * (2 * (m + 1) + (nl - m + 1) + (m + 1))
        flops += 2 * nrhs * (2 * nnz["L"] + 2 * nnz["U"] + nnz["E"]
                             + nnz["F"])
    nbytes += tail_n * tail_n * es + 2 * n * nrhs * es
    flops += 4 * tail_n * tail_n * nrhs
    return nbytes, flops
