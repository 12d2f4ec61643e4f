"""Krylov drivers on the device: GMRES(m), FGMRES-HIFIR and batched GMRES.

The port of ``hifir_tpu/solvers/gmres.py``: right-preconditioned restarted
GMRES around the multilevel M-solve (:func:`gmres_hif`), flexible GMRES with
inner iterative refinement and a rank control (:func:`fgmres_hifir`), and
GMRES over a block of right-hand sides (:func:`gmres_mrhs`).  The operator A
may be an ELL or a sliced ELL (kernel K1) or a BSR (kernel K7).

The restart cycle is the JAX package's design: device-resident, static
shapes, masked after convergence.  CGS2 as two projections, Givens
rotations of each new Hessenberg column and the masked back-substitution
all run on the device; the host reads a few numbers a cycle.

- Single RHS (:func:`_segment`): the basis V, the preconditioned Z, the
  Hessenberg H, the rotations G and g live in a workspace on the device.
  The cycle runs in segments of ``SEGMENT`` Arnoldi steps, each one program;
  a step after ``done`` (|g[j+1]| <= rtol ||b||) changes nothing (every
  piece of state goes through ``torch.where``, as JAX's ``lax.cond`` skips
  the step), and every segment ends by forming the cycle's x from the steps
  so far.  The host reads (done, steps, residual estimate) after each
  segment and ends the cycle at done: at most ceil(m / SEGMENT) reads a
  cycle and SEGMENT - 1 masked steps after convergence (JAX reads twice a
  cycle and masks up to m - 1 steps inside one program).
- Batched (:func:`_cycle_mrhs`): one program for all m steps, the batched
  rotations and the back-substitution masked by each column's ``used``
  steps (a zero pivot is a Krylov breakdown, which is exact convergence);
  the host reads the largest relative residual estimate once a cycle.

On a CUDA pack with ``graphs`` on, each program is a captured graph in the
pack's cache (:mod:`..graphs`; ``fgmres_hifir`` gets a set for each inner
count it reaches); otherwise it runs eagerly.

Complex packs run the same iteration: the projections conjugate the basis,
the norms are real, and :func:`_givens` makes unitary rotations in both
cycles.  The JAX package's single-RHS rotation
(``hifir_tpu/solvers/gmres.py:93-101``) does not conjugate, so on complex
input its |g[j+1]| is not the residual norm and its iteration counts differ
from these; its batched cycle conjugates, as this one does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..alg.prec import DevicePrec, prec_solve_mrhs
from ..device import as_values, real_dtype
from ..graphs import GraphRefused, cache_of
from ..ops.spmv import ell_matvec, ell_matvec_mrhs
from ..trace import add, span
from .ir import ir_apply_mrhs, residual_mrhs

__all__ = ["gmres_hif", "fgmres_hifir", "gmres_mrhs", "SEGMENT"]

# Arnoldi steps a single-RHS program runs between two host reads
SEGMENT = 5


def _givens(c: torch.Tensor, G: torch.Tensor, g: torch.Tensor, j: int):
    """Rotate Hessenberg column ``j``, ``c`` of shape (m+1, *R), in place by
    the stored rotations ``G[:j]`` (G: (m, 2, 2, *R)), and make its own
    rotation, which sets (c[j], c[j+1]) to (rho, 0).  Returns that rotation
    ((2, 2, *R)) and g[j:j+2] rotated by it; writes neither G nor g."""
    for i in range(j):
        c[i:i + 2] = (G[i] * c[None, i:i + 2]).sum(1)
    a, bb = c[j], c[j + 1]
    rho = torch.sqrt(a.abs() ** 2 + bb.abs() ** 2)
    ok = rho > 0
    safe = torch.where(ok, rho, 1)
    cs = torch.where(ok, a.conj() / safe, 1)
    sn = torch.where(ok, bb.conj() / safe, 0)
    Gj = torch.stack([torch.stack([cs, sn]),
                      torch.stack([-sn.conj(), cs.conj()])])
    c[j] = rho
    c[j + 1].zero_()      # a scalar assignment would copy from the host
    return Gj, Gj[:, 0] * g[j]


@dataclasses.dataclass
class _Cycle:
    """A single-RHS GMRES(m) cycle's device state: b, the cycle's start x
    and its result ``xo``, the threshold rtol ||b||, V (m+1, n), Z (m, n),
    H (m+1, m), G (m, 2, 2), g (m+1,), ``done``, the steps ``jused`` and
    ``stat`` = (done, jused, |residual| estimate), what the host reads."""

    b: torch.Tensor
    x: torch.Tensor
    xo: torch.Tensor
    rtol: torch.Tensor
    V: torch.Tensor
    Z: torch.Tensor
    H: torch.Tensor
    G: torch.Tensor
    g: torch.Tensor
    done: torch.Tensor
    jused: torch.Tensor
    stat: torch.Tensor

    @classmethod
    def new(cls, n: int, m: int, dtype, device) -> "_Cycle":
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        rdt = real_dtype(dtype)
        return cls(z(n), z(n), z(n), z(dt=rdt), z(m + 1, n), z(m, n),
                   z(m + 1, m), z(m, 2, 2), z(m + 1),
                   z(dt=torch.bool), z(dt=torch.int64), z(3, dt=rdt))


def _start(A, w: _Cycle) -> None:
    """The cycle's start: x from the last cycle's result, r = b - A x,
    V[0] = r / ||r||, g = ||r|| e_0, the rest of the state zero."""
    w.x.copy_(w.xo)
    r = residual_mrhs(A, w.b[:, None], w.x[:, None])[:, 0]
    beta = torch.linalg.vector_norm(r)
    for t in (w.V, w.Z, w.H, w.G, w.g, w.done, w.jused):
        t.zero_()
    w.g[0] = beta
    w.V[0] = torch.where(beta > 0, r / beta, r)


def _step(A, levels, tail, nirs: int, r, j: int, w: _Cycle) -> None:
    """Arnoldi step j: z = HIFIR(V[j]), CGS2 of A z against V[:j+1], the
    rotations of column j, and the done test; after ``done`` it writes back
    what was there."""
    z = ir_apply_mrhs(A, levels, tail, w.V[j][:, None], nirs, r)[:, 0]
    v = ell_matvec(A, z)
    Vj = w.V[:j + 1]
    h1 = Vj.conj() @ v
    v = v - h1 @ Vj
    h2 = Vj.conj() @ v
    v = v - h2 @ Vj
    hj1 = torch.linalg.vector_norm(v)
    c = torch.zeros_like(w.g)
    c[:j + 1] = h1 + h2
    c[j + 1] = hj1
    Gj, gj = _givens(c, w.G, w.g, j)
    keep = w.done
    w.V[j + 1] = torch.where(keep, w.V[j + 1],
                             torch.where(hj1 > 0, v / hj1, v))
    w.Z[j] = torch.where(keep, w.Z[j], z)
    w.H[:, j] = torch.where(keep, w.H[:, j], c)
    w.G[j] = torch.where(keep, w.G[j], Gj)
    w.g[j:j + 2] = torch.where(keep, w.g[j:j + 2], gj)
    w.jused.copy_(torch.where(keep, w.jused, j + 1))
    w.done.copy_(keep | (w.g[j + 1].abs() <= w.rtol))


def _finish(w: _Cycle) -> None:
    """xo = x + Z^T y, y from the leading ``jused`` block of H (the others
    masked to the identity), and ``stat``."""
    m = w.Z.shape[0]
    used = torch.arange(m, device=w.g.device) < w.jused
    Hm = (torch.where(used[:, None] & used, w.H[:m], 0)
          + torch.diag((~used).to(w.H.dtype)))
    y = torch.linalg.solve_triangular(
        Hm, torch.where(used, w.g[:m], 0)[:, None], upper=True)[:, 0]
    torch.add(w.x, y @ w.Z, out=w.xo)
    res = w.g.gather(0, w.jused[None]).abs()
    w.stat.copy_(torch.cat([w.done[None].to(res.dtype),
                            w.jused[None].to(res.dtype), res]))


def _segment(A, levels, tail, nirs: int, r, j0: int, j1: int,
             w: _Cycle) -> None:
    """Steps j0..j1-1 of a single-RHS cycle (the start first when j0 is 0),
    then the cycle's x so far: one program."""
    if j0 == 0:
        _start(A, w)
    for j in range(j0, j1):
        _step(A, levels, tail, nirs, r, j, w)
    _finish(w)


def _run(cache, fn, *args) -> None:
    if cache is None:
        fn(*args)
    else:
        cache.step(fn, *args)


def _workspace(cache, make, *args):
    return make(*args) if cache is None else cache.workspace(make, *args)


def _read(t, host=float):
    """``host(t)``: one of the driver's reads of a device value, which
    waits for the device (counted in ``gmres.reads``)."""
    add("gmres.reads")
    with span("hifir.gmres.read"):
        return host(t)


def _restart_cycle(A, prec, cache, w: _Cycle, nirs: int, r, seg: int):
    """One GMRES(m) restart cycle in segments of ``seg`` steps; returns the
    |residual| estimate and the steps done (x_new is in ``w.xo``).  The
    steps the segments run (masked ones included) count in
    ``gmres.steps_run``, those the cycle uses in ``gmres.steps_used``."""
    m = w.Z.shape[0]
    for j0 in range(0, m, seg):
        j1 = min(m, j0 + seg)
        _run(cache, _segment, A, prec.levels, prec.tail, nirs, r, j0, j1, w)
        add("gmres.steps_run", j1 - j0)
        done, jused, res = _read(w.stat, torch.Tensor.tolist)
        if done:
            break
    add("gmres.steps_used", int(jused))
    return res, int(jused)


def _cycle_cache(prec):
    """The cache of the cycles' programs, which run the M-solve over a
    :class:`~hifir_tpu_torch.alg.prec.DevicePrec`'s levels and tail; any
    other preconditioner raises :class:`~hifir_tpu_torch.graphs.
    GraphRefused`."""
    if not isinstance(prec, DevicePrec):
        raise GraphRefused(
            f"{type(prec).__name__} cannot be captured in a GMRES cycle: the "
            "cycle's programs run the M-solve over a DevicePrec's levels and "
            "tail, and a DistPrec's solve is a program of its own over its "
            "mesh (DistPrec.solve)")
    return cache_of(prec)


def _gmres(A, prec, b, restart, rtol, maxit, x0, nirs_of, r):
    """The restart loop shared by :func:`gmres_hif` and
    :func:`fgmres_hifir`; ``nirs_of(cycle)`` is a cycle's inner count."""
    cache = _cycle_cache(prec)
    with span("hifir.gmres"):
        b = as_values(b, prec.dtype, prec.device)
        bnrm = _read(torch.linalg.vector_norm(b))
        if bnrm == 0.0:
            return torch.zeros_like(b), 0, 0
        w = _workspace(cache, _Cycle.new, b.shape[0], restart, prec.dtype,
                       prec.device)
        w.b.copy_(b)
        if x0 is None:
            w.xo.zero_()
        else:
            w.xo.copy_(as_values(x0, prec.dtype, prec.device))
        w.rtol.fill_(rtol * bnrm)
        it, flag, cycle = 0, 1, 0
        while it < maxit:
            res, j_used = _restart_cycle(A, prec, cache, w, nirs_of(cycle),
                                         r, SEGMENT)
            it += j_used
            cycle += 1
            if res <= rtol * bnrm:
                flag = 0
                break
        return w.xo.clone(), flag, it


def gmres_hif(A, prec, b, restart: int = 30, rtol: float = 1e-6,
              maxit: int = 500, x0=None) -> Tuple[torch.Tensor, int, int]:
    """Right-preconditioned restarted GMRES on the pack's device.

    ``A`` is an ELL, sliced-ELL or BSR operator, ``prec`` a
    :class:`~hifir_tpu_torch.alg.prec.DevicePrec`.  Returns (x, flag,
    iterations); flag 0 means converged to ``rtol``."""
    return _gmres(A, prec, b, restart, rtol, maxit, x0, lambda cycle: 1,
                  None)


def fgmres_hifir(A, prec, b, restart: int = 30, rtol: float = 1e-6,
                 maxit: int = 500, x0=None, max_inner: int = 4,
                 rank: int = 0) -> Tuple[torch.Tensor, int, int]:
    """Flexible GMRES whose preconditioner is HIFIR (:func:`ir_apply`).

    The inner refinement count doubles once per restart cycle (1, 2, 4, ...,
    capped at ``2**max_inner``), as in the JAX package; ``rank > 0``
    overrides the dense tail's rank in every M-solve.  Returns (x, flag,
    iterations)."""
    return _gmres(A, prec, b, restart, rtol, maxit, x0,
                  lambda cycle: 1 << min(cycle, max_inner), rank)


@dataclasses.dataclass
class _CycleMrhs:
    """A batched GMRES(m) cycle's device state over R columns: B, X (both
    (n, R)), ``bsafe`` (R,) (||b_k||, 1 for a zero column), V (R, m+1, n),
    Z (R, m, n) and ``stat``, the largest relative residual estimate."""

    B: torch.Tensor
    X: torch.Tensor
    bsafe: torch.Tensor
    V: torch.Tensor
    Z: torch.Tensor
    stat: torch.Tensor

    @classmethod
    def new(cls, n: int, R: int, m: int, dtype, device) -> "_CycleMrhs":
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        rdt = real_dtype(dtype)
        return cls(z(n, R), z(n, R), z(R, dt=rdt), z(R, m + 1, n),
                   z(R, m, n), z(dt=rdt))


def _cycle_mrhs(A, levels, tail, w: _CycleMrhs) -> None:
    """One batched GMRES(m) restart cycle over the R columns of B: all m
    steps, X updated in place.

    The basis of column k is V[k] (rows are vectors), so each projection is
    one strided-batched GEMM over the columns.  The JAX layout (m+1, n, R)
    puts the batch innermost, where ``torch.bmm`` and ``torch.einsum`` would
    copy the basis for every projection; this one costs a transposed copy of
    the (n, R) A-product a step instead.  The M-solve reads V[:, j].T as it
    is: its first gather by p writes a contiguous block."""
    B, X, V, Z = w.B, w.X, w.V, w.Z
    R, m = Z.shape[0], Z.shape[1]
    Rsd = residual_mrhs(A, B, X)
    beta = torch.linalg.vector_norm(Rsd, dim=0)                    # (R,)
    Hd = B.new_zeros((R, m + 1, m))
    V[:, 0] = (Rsd / torch.where(beta > 0, beta, 1)).T
    for j in range(m):
        Zj = prec_solve_mrhs(levels, tail, V[:, j].T)
        Z[:, j] = Zj.T
        W = ell_matvec_mrhs(A, Zj).T.contiguous()[:, None]         # (R, 1, n)
        Vj = V[:, :j + 1]                                          # (R, j+1, n)
        h1 = torch.bmm(W, Vj.mH)                                   # (R, 1, j+1)
        W = torch.baddbmm(W, h1, Vj, alpha=-1)
        h2 = torch.bmm(W, Vj.mH)
        W = torch.baddbmm(W, h2, Vj, alpha=-1)
        hj1 = torch.linalg.vector_norm(W[:, 0], dim=1)       # (R,), real
        Hd[:, :j + 1, j] = (h1 + h2)[:, 0]
        Hd[:, j + 1, j] = hj1
        # a zero W (breakdown) stays zero
        torch.div(W[:, 0], torch.where(hj1 > 0, hj1, 1)[:, None],
                  out=V[:, j + 1])
    G = B.new_zeros((m, 2, 2, R))
    g = B.new_zeros((m + 1, R))
    g[0] = beta
    Hr = B.new_zeros((m + 1, m, R))
    for j in range(m):
        c = Hd[:, :, j].T.contiguous()                             # (m+1, R)
        G[j], g[j:j + 2] = _givens(c, G, g, j)
        Hr[:, j] = c
    # per column, the steps before the first zero pivot enter the
    # back-substitution; the others are masked to the identity
    Hm = Hr[:m].permute(2, 0, 1)                                   # (R, m, m)
    ok = torch.diagonal(Hm, dim1=1, dim2=2).abs() > 0
    used = torch.cumprod(ok.to(torch.int32), dim=1).bool()         # (R, m)
    Hm = (torch.where(used[:, :, None] & used[:, None, :], Hm, 0)
          + torch.diag_embed((~used).to(B.dtype)))
    y = torch.linalg.solve_triangular(
        Hm, torch.where(used, g[:m].T, 0)[:, :, None], upper=True)[:, :, 0]
    X += torch.bmm(y[:, None, :], Z)[:, 0].T
    w.stat.copy_((g[m].abs() / w.bsafe).max())


def gmres_mrhs(A, prec, B, restart: int = 30, rtol: float = 1e-6,
               maxit: int = 500) -> Tuple[torch.Tensor, int, int]:
    """Right-preconditioned restarted GMRES over the columns of B (n, R),
    every kernel launch shared by all columns (the M-solve is the batched
    one).  Returns (X, flag, cycles); flag 0 once every column's residual
    estimate is within ``rtol`` of its ||b||."""
    cache = _cycle_cache(prec)
    with span("hifir.gmres"):
        B = as_values(B, prec.dtype, prec.device)
        n, R = B.shape
        w = _workspace(cache, _CycleMrhs.new, n, R, restart, prec.dtype,
                       prec.device)
        w.B.copy_(B)
        w.X.zero_()
        bnrm = torch.linalg.vector_norm(B, dim=0)
        w.bsafe.copy_(torch.where(bnrm > 0, bnrm, 1))
        cycles, flag = 0, 1
        while cycles * restart < maxit:
            _run(cache, _cycle_mrhs, A, prec.levels, prec.tail, w)
            cycles += 1
            if _read(w.stat) <= rtol:
                flag = 0
                break
        return w.X.clone(), flag, cycles
