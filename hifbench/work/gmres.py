"""One GMRES(restart) system to convergence, right-preconditioned, one
right-hand side: its M-solves (one an Arnoldi step: the preconditioned
vectors are kept, so x needs no further solve), its products with A (one
a step and one a restart cycle's residual; nnz(A) entries as value plus
4-byte index, row pointers, x read and y written), and the Arnoldi basis:
step j of a cycle reads the j + 1 basis vectors four times (two
projections, each a dot product and an update), writes the new basis
vector and the preconditioned vector once."""

from __future__ import annotations

from .msolve import msolve_work

__all__ = ["gmres_work"]


def gmres_work(levels, tail_n: int, nnz_a: int, n: int, iters: int,
               restart: int, es: int) -> tuple:
    """``(bytes, flops)`` of one system that took ``iters`` Arnoldi steps."""
    mb, mf = msolve_work(levels, tail_n, n, 1, es)
    cycles = max(1, -(-iters // restart))
    products = iters + cycles
    nbytes = iters * mb
    flops = iters * mf
    nbytes += products * (nnz_a * (es + 4) + 4 * (n + 1) + 2 * n * es)
    flops += products * 2 * nnz_a
    for it in range(iters):
        j = it % restart
        nbytes += (4 * (j + 1) + 2) * n * es
        flops += 8 * (j + 1) * n
    return nbytes, flops
