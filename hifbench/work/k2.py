"""K2's work in one M-solve: the level-scheduled triangular solves.

A pack with ``dense_inv="auto"`` applies (I + L)^{-1} and (I + U)^{-1} of a
level by the level scan (K2, ``trsv_solve_kernel``) when the level's m is
above 8 x 2048 (below it, by dense or blocked inverses), each factor twice
a solve.  A launch reads its strict factor's entries (value plus 4-byte
index) and its right-hand side's rows once and writes its rows once, as
``chip_smoke.py``'s K2 bound counts them.  A reader checks the launches the
trace holds against :func:`k2_launches` and reads nothing where they
differ, so a pack that moves a level to another form leaves the metric
silent instead of wrong."""

from __future__ import annotations

__all__ = ["SCAN_ABOVE", "k2_levels", "k2_launches", "k2_work"]

SCAN_ABOVE = 8 * 2048


def k2_levels(levels) -> list:
    return [lv for lv in levels if lv["m"] > SCAN_ABOVE]


def k2_launches(levels) -> int:
    """K2 launches a solve: L and U, down and up, on each scanned level."""
    return 4 * len(k2_levels(levels))


def k2_work(levels, nrhs: int, es: int) -> tuple:
    """``(bytes, flops)`` of K2's launches in one M-solve."""
    nbytes = flops = 0
    for lv in k2_levels(levels):
        for f in ("L", "U"):
            nnz = int(lv[f].nnz)
            nbytes += 2 * (nnz * (es + 4) + 2 * lv["m"] * nrhs * es)
            flops += 2 * 2 * nnz * nrhs
    return nbytes, flops
