"""Multilevel preconditioner on the device: packing, M-solves and products.

The port of ``hifir_tpu/alg/prec.py``.  Per-level operands are packed once
(scalings and permutations as index tensors, L_B and U_B as one of the three
triangular forms of :mod:`..ops.trsv`, E and F as sliced ELL, the dense tail
as QR/eigen/LU factors) and the levels are walked down and up in PyTorch,
on blocks B of shape (n, nrhs):

- :func:`prec_solve_mrhs`: X = M^{-1} B;
- :func:`prec_solve_tran_mrhs`: X = M^{-H} B, on the adjoint operands that
  :meth:`DevicePrec.pack_transpose` packs (:class:`TranLevel`);
- :func:`prec_prod_mrhs` and :func:`prec_prod_tran_mrhs`: Y = M X and
  Y = M^H X, on the operands of :meth:`DevicePrec.pack_prod` and
  :meth:`DevicePrec.pack_prod_tran`.

These functions are eager.  :class:`DevicePrec`'s methods run them as the
JAX package runs its jitted ones: as replays of captured CUDA graphs
(:mod:`..graphs`, one cache and memory pool a pack), unless the pack's
``graphs`` is off or it lies on the CPU.

Both solves take a runtime rank ``r`` for the dense tail.  The sparse work
runs in the kernels of :mod:`..ops`: K1 for every product with E, F, their
adjoints, the blocked inverses' Off_b and, in the products, L_B and U_B; K2
for the level scans.  The dense work (explicit inverses, tail) runs in
``torch.matmul`` and ``torch.linalg.solve_triangular``.  Where the JAX
package scatters (``zeros().at[perm].set(v)``) the port gathers by the
inverse permutation (``p_inv``, ``q_inv``, ``jpvt_inv``, packed once).

Packs are float32, float64, complex64 or complex128.  ``.conj()`` and
``.mH`` stand where the JAX package conjugates.  On a complex tensor they
are lazy views whose memory is not conjugated, so they appear only in
elementwise products, ``torch.matmul`` and ``torch.linalg.solve_triangular``,
which honour the view and return plain tensors.  The sparse adjoint
operands that K1 and K2 read (L_B^H, U_B^H, E^H, F^H) are conjugated on the
host when they are packed (:func:`_adjoint`), and the kernels' wrapper
refuses any operand with the conjugate bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import as_values, numpy_dtype, resolve_device, torch_dtype
from ..graphs import GraphCache, cache_of
from ..nsp import NspFilter, nsp_filter
from ..ops.spmv import SlicedELL, sliced_ell_from_csr, sliced_ell_sub_mrhs
from ..ops.trsv import (build_trsv_block_dense, build_trsv_dense,
                        build_trsv_schedule, trsv_apply_mrhs)
from ..small_scale.dense import solve_rank
from ..trace import span

__all__ = ["DeviceLevel", "DenseTail", "TranLevel", "ProdLevel",
           "ProdTranLevel", "DevicePrec", "prec_solve_mrhs",
           "prec_solve_tran_mrhs", "prec_prod_mrhs", "prec_prod_tran_mrhs",
           "tail_solve_mrhs", "tail_multiply_mrhs"]


@dataclasses.dataclass
class DenseTail:
    """Dense last level: truncated-rank QRCP, symmetric eigen or LU factors."""

    Q: torch.Tensor       # (nm, nm) Q (QRCP), V (SYEIG), unit-lower L (LUP)
    R: torch.Tensor       # (nm, nm) upper triangular (QRCP/LUP)
    jpvt: torch.Tensor    # (nm,) int64 col pivots / eig order / row perm
    jpvt_inv: torch.Tensor  # (nm,) int64 inverse of jpvt
    w: torch.Tensor       # (nm,) eigenvalues (SYEIG) or zeros
    rank: int
    kind: str             # "qrcp" | "syeig" | "lup"


@dataclasses.dataclass
class DeviceLevel:
    """One level's device operands."""

    p: torch.Tensor       # (n,) int64 row permutation (position -> orig)
    q_inv: torch.Tensor   # (n,) int64 inverse column permutation
    s_p: torch.Tensor     # (n,) s[p] gather-scaling coefficients
    t: torch.Tensor       # (n,)
    d: torch.Tensor       # (m,) diagonal
    L: object             # strict lower solve of L_B (a trsv form)
    U: object             # strict upper solve of U_B (a trsv form)
    E: SlicedELL          # (n-m) x m
    F: SlicedELL          # m x (n-m)
    m: int
    n: int
    # the other side's gathers, for the adjoint solve and the products
    q: torch.Tensor       # (n,) int64 column permutation
    p_inv: torch.Tensor   # (n,) int64 inverse row permutation
    s: torch.Tensor       # (n,) row scaling
    t_q: torch.Tensor     # (n,) t[q]


@dataclasses.dataclass
class TranLevel:
    """One level's adjoint operands (:meth:`DevicePrec.pack_transpose`)."""

    LT: object            # L_B^H: unit strict upper (a trsv form)
    UT: object            # U_B^H: unit strict lower (a trsv form)
    ET: SlicedELL         # E^H, m x (n-m)
    FT: SlicedELL         # F^H, (n-m) x m


@dataclasses.dataclass
class ProdLevel:
    """One level's forward-product operands: strict L_B and U_B as ELL."""

    Lell: SlicedELL
    Uell: SlicedELL


@dataclasses.dataclass
class ProdTranLevel:
    """One level's adjoint-product operands: L_B^H and U_B^H as ELL (E^H,
    F^H and the adjoint triangular forms come from :class:`TranLevel`)."""

    LellH: SlicedELL
    UellH: SlicedELL


# ---------------------------------------------------------------------------
# the dense tail

def tail_solve_mrhs(tail: Optional[DenseTail], Y: torch.Tensor,
                    trans: bool = False, r: Optional[int] = None
                    ) -> torch.Tensor:
    """Truncated-rank dense backsolve of Y (nm, nrhs), or its adjoint.

    ``0 < r <= rank`` overrides the pack's rank; r <= 0, None and r above
    the pack's rank keep the pack's (the host QRCP's and SYEIG's rule,
    :func:`~hifir_tpu_torch.small_scale.dense.solve_rank`; the JAX device
    tail keeps r columns there).  The masks of the JAX ``tail_solve_rank``
    become slices.  LUP ignores r, as the JAX package does."""
    if tail is None:
        return Y
    solve = torch.linalg.solve_triangular
    if tail.kind == "lup":
        L, U = tail.Q, tail.R
        if not trans:
            Z = solve(L, Y[tail.jpvt], upper=False, unitriangular=True)
            return solve(U, Z, upper=True)
        Z = solve(U.mH, Y, upper=False)
        Z = solve(L.mH, Z, upper=True, unitriangular=True)
        return Z[tail.jpvt_inv]
    r = solve_rank(r, tail.rank)
    if r == 0:
        return torch.zeros_like(Y)
    if tail.kind == "syeig":
        Vr = tail.Q[:, :r]
        return Vr @ ((Vr.mH @ Y) / tail.w[:r, None])
    Qr, Rr, piv = tail.Q[:, :r], tail.R[:r, :r], tail.jpvt[:r]
    if not trans:
        Z = solve(Rr, Qr.mH @ Y, upper=True)
        return torch.zeros_like(Y).index_copy_(0, piv, Z)
    return Qr @ solve(Rr.mH, Y[piv], upper=False)


def tail_multiply_mrhs(tail: DenseTail, X: torch.Tensor,
                       trans: bool = False) -> torch.Tensor:
    """The dense tail times X (nm, nrhs), or its adjoint times X."""
    Q, R = tail.Q, tail.R
    if tail.kind == "syeig":
        return Q @ (tail.w[:, None] * (Q.mH @ X))
    if tail.kind == "lup":
        # P A = L U, so A X = P^T L U X and A^H X = U^H L^H P X
        if not trans:
            return (Q @ (R @ X))[tail.jpvt_inv]
        return R.mH @ (Q.mH @ X[tail.jpvt])
    # A P = Q R, so A X = Q R P^T X and A^H X = P R^H Q^H X
    if not trans:
        return Q @ (R @ X[tail.jpvt])
    return (R.mH @ (Q.mH @ X))[tail.jpvt_inv]


# ---------------------------------------------------------------------------
# solves

def _ldu_solve_mrhs(lvl: DeviceLevel, Y: torch.Tensor) -> torch.Tensor:
    """Y <- U^{-1} D^{-1} L^{-1} Y."""
    Y = trsv_apply_mrhs(lvl.L, Y)
    Y = Y / lvl.d[:, None]
    return trsv_apply_mrhs(lvl.U, Y)


def _ldu_solve_tran_mrhs(lvl: DeviceLevel, top: TranLevel,
                         Y: torch.Tensor) -> torch.Tensor:
    """Y <- L^{-H} D^{-H} U^{-H} Y."""
    Y = trsv_apply_mrhs(top.UT, Y)
    Y = Y / lvl.d.conj()[:, None]
    return trsv_apply_mrhs(top.LT, Y)


def prec_solve_mrhs(levels: List[DeviceLevel], tail: Optional[DenseTail],
                    B: torch.Tensor, r: Optional[int] = None) -> torch.Tensor:
    """Multilevel solve X = M^{-1} B for B of shape (n, nrhs); ``r > 0``
    overrides the tail's rank.

    Each level's scaled right-hand side ``wb`` takes both subtractions in
    place (kernel K1 with its fused epilogue): the down-sweep turns
    ``wb[m:]`` into ``wb[m:] - E x1``, the next level's right-hand side, and
    the up-sweep, which reads only ``wb[:m]``, turns that into
    ``wb[:m] - F x_tail`` before its last use."""
    wbs = []
    rhs = B
    for lvl in levels:
        wb = lvl.s_p[:, None] * rhs[lvl.p]
        x1 = _ldu_solve_mrhs(lvl, wb[:lvl.m])
        rhs = wb[lvl.m:]
        sliced_ell_sub_mrhs(lvl.E, x1, rhs, out=rhs)
        wbs.append(wb)
    x_tail = tail_solve_mrhs(tail, rhs, r=r)
    for lvl, wb in zip(reversed(levels), reversed(wbs)):
        m = lvl.m
        head = wb[:m]
        if lvl.n - m:
            sliced_ell_sub_mrhs(lvl.F, x_tail, head, out=head)
        x1 = _ldu_solve_mrhs(lvl, head)
        sol = torch.cat([x1, x_tail])
        x_tail = lvl.t[:, None] * sol[lvl.q_inv]
    return x_tail


def prec_solve_tran_mrhs(levels: List[DeviceLevel], tops: List[TranLevel],
                         tail: Optional[DenseTail], B: torch.Tensor,
                         r: Optional[int] = None) -> torch.Tensor:
    """Adjoint multilevel solve X = M^{-H} B for B of shape (n, nrhs).

    The forward walk mirrored: the scaling conj(t[q]) on entry, F^H on the
    way down and E^H on the way up (both in place by K1, as in the forward
    solve), the adjoint triangular forms, and conj(s) by p^{-1} on exit."""
    wbs = []
    rhs = B
    for lvl, top in zip(levels, tops):
        wb = lvl.t_q.conj()[:, None] * rhs[lvl.q]
        x1 = _ldu_solve_tran_mrhs(lvl, top, wb[:lvl.m])
        rhs = wb[lvl.m:]
        sliced_ell_sub_mrhs(top.FT, x1, rhs, out=rhs)
        wbs.append(wb)
    x_tail = tail_solve_mrhs(tail, rhs, trans=True, r=r)
    for lvl, top, wb in zip(reversed(levels), reversed(tops), reversed(wbs)):
        m = lvl.m
        head = wb[:m]
        if lvl.n - m:
            sliced_ell_sub_mrhs(top.ET, x_tail, head, out=head)
        x1 = _ldu_solve_tran_mrhs(lvl, top, head)
        sol = torch.cat([x1, x_tail])
        x_tail = lvl.s.conj()[:, None] * sol[lvl.p_inv]
    return x_tail


# ---------------------------------------------------------------------------
# products

def prec_prod_mrhs(levels: List[DeviceLevel], prods: List[ProdLevel],
                   tail: Optional[DenseTail], X: torch.Tensor) -> torch.Tensor:
    """Y = M X for X of shape (n, nrhs).

    A level's leading block is (I + L) D (I + U), its products with L and U
    K1's ``C + A X`` (``sign=1``), and the tail rows E w + y_tail one more
    such launch."""
    vs = []
    cur = X
    for lvl in levels:
        v = cur[lvl.q] / lvl.t_q[:, None]
        vs.append(v)
        cur = v[lvl.m:]
    y_tail = cur if tail is None else tail_multiply_mrhs(tail, cur)
    for lvl, pr, v in zip(reversed(levels), reversed(prods), reversed(vs)):
        m = lvl.m
        v1 = v[:m]
        u = torch.empty_like(v)
        z = sliced_ell_sub_mrhs(pr.Uell, v1, v1, sign=1) * lvl.d[:, None]
        sliced_ell_sub_mrhs(pr.Lell, z, z, out=u[:m], sign=1)
        if lvl.n - m:
            Fv2 = sliced_ell_sub_mrhs(lvl.F, v[m:])
            w = v1 + _ldu_solve_mrhs(lvl, Fv2)
            sliced_ell_sub_mrhs(lvl.E, w, y_tail, out=u[m:], sign=1)
            u[:m] += Fv2
        y_tail = u[lvl.p_inv] / lvl.s[:, None]
    return y_tail


def prec_prod_tran_mrhs(levels: List[DeviceLevel], tops: List[TranLevel],
                        prods_t: List[ProdTranLevel],
                        tail: Optional[DenseTail],
                        X: torch.Tensor) -> torch.Tensor:
    """Y = M^H X for X of shape (n, nrhs): :func:`prec_prod_mrhs` mirrored,
    with the leading block (I + U^H) conj(D) (I + L^H)."""
    ws = []
    cur = X
    for lvl in levels:
        w = cur[lvl.p] / lvl.s_p.conj()[:, None]
        ws.append(w)
        cur = w[lvl.m:]
    y_tail = cur if tail is None else tail_multiply_mrhs(tail, cur,
                                                         trans=True)
    for lvl, top, pt, w in zip(reversed(levels), reversed(tops),
                               reversed(prods_t), reversed(ws)):
        m = lvl.m
        w1 = w[:m]
        z = torch.empty_like(w)
        y = (sliced_ell_sub_mrhs(pt.LellH, w1, w1, sign=1)
             * lvl.d.conj()[:, None])
        sliced_ell_sub_mrhs(pt.UellH, y, y, out=z[:m], sign=1)
        if lvl.n - m:
            EHw2 = sliced_ell_sub_mrhs(top.ET, w[m:])
            u = w1 + _ldu_solve_tran_mrhs(lvl, top, EHw2)
            sliced_ell_sub_mrhs(top.FT, u, y_tail, out=z[m:], sign=1)
            z[:m] += EHw2
        y_tail = z[lvl.q_inv] / lvl.t.conj()[:, None]
    return y_tail


# ---------------------------------------------------------------------------
# packing

def _ldu_form(T, lower: bool, dense_inv: int, chunk, k_cap, dtype, dev):
    """The triangular form of ``(I + strict(T))^{-1}`` by its size: an
    explicit dense inverse for 0 < m <= dense_inv, the blocked inverse up to
    8 * dense_inv, else the level scan (an empty one for m == 0)."""
    if 0 < T.nrows <= dense_inv:
        return build_trsv_dense(T, lower=lower, dtype=dtype, device=dev)
    if dense_inv and 0 < T.nrows <= 8 * dense_inv:
        return build_trsv_block_dense(T, lower=lower, W=dense_inv,
                                      dtype=dtype, device=dev)
    return build_trsv_schedule(T, lower=lower, chunk=chunk, dtype=dtype,
                               k_cap=k_cap, device=dev)


def _dense_inv(dense_inv) -> int:
    return 2048 if dense_inv == "auto" else int(dense_inv)


def _adjoint(A):
    """A^H of a host CSR."""
    T = A.transpose()
    if np.iscomplexobj(T.data):
        T.data = np.conj(T.data)
    return T


def _host_dtype(precs) -> np.dtype:
    """The host levels' value dtype: that of the levels with rows and of the
    dense tail together, so that a complex tail under levels with m == 0
    (whose ``d`` is empty) still packs as complex."""
    dts = [np.asarray(p.d).dtype for p in precs if p.m]
    if precs[-1].dense_matrix is not None:
        dts.append(precs[-1].dense_matrix.dtype)
    return np.result_type(*dts) if dts else np.dtype(np.float64)


def _device_tail(dense: np.ndarray, dtype: torch.dtype, dev) -> DenseTail:
    """The dense tail factorized again on ``dev`` in ``dtype`` by K8
    (``qrcp_factor``), its rank at the default ``rrqr_cond`` (the JAX
    package's ``from_host(tail_on_device=True)``).  A complex tail raises
    TypeError (the sweep is real only)."""
    from ..small_scale.qrcp_device import qrcp_factor

    Q, R, piv, rank = qrcp_factor(torch.as_tensor(dense, dtype=dtype,
                                                  device=dev))
    inv = torch.empty_like(piv).scatter_(0, piv, torch.arange(
        piv.numel(), device=dev))
    return DenseTail(Q, R, piv, inv, torch.zeros(piv.numel(), dtype=dtype,
                                                 device=dev), rank, "qrcp")


def _dense_tail(last, dtype: torch.dtype, dev) -> Optional[DenseTail]:
    ds = last.dense_solver
    if ds is None:
        return None

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def perm(a):
        a = np.asarray(a, dtype=np.int64)
        inv = np.empty_like(a)
        inv[a] = np.arange(a.size)
        return (torch.as_tensor(a, device=dev),
                torch.as_tensor(inv, device=dev))

    if ds.kind == "qrcp":
        return DenseTail(f(ds.Q), f(ds.R), *perm(ds.jpvt), f(np.zeros(ds.n)),
                         ds.rank, "qrcp")
    if ds.kind == "syeig":
        order = np.argsort(-np.abs(ds.w))
        return DenseTail(f(ds.V[:, order]), f(np.zeros((ds.n, ds.n))),
                         *perm(order), f(ds.w[order]), ds.rank, "syeig")
    lu = ds.lu
    return DenseTail(f(np.tril(lu, -1) + np.eye(ds.n)), f(np.triu(lu)),
                     *perm(ds.piv_perm()), f(np.zeros(ds.n)), ds.rank, "lup")


@dataclasses.dataclass
class DevicePrec:
    """Whole multilevel preconditioner on one device.

    ``nsp`` and ``nsp_tran`` (``None`` until set) are the null-space filters
    of the forward and the adjoint solves; ``tran``, ``prod`` and
    ``prod_tran`` are the operands that :meth:`pack_transpose`,
    :meth:`pack_prod` and :meth:`pack_prod_tran` add.  ``dense_inv``,
    ``chunk`` and ``k_cap`` are the triangular-form settings of
    :meth:`from_host`, which the adjoint factors reuse.

    ``graphs`` (on by default) runs the solves and products on a CUDA pack
    as replays of captured graphs (:mod:`~hifir_tpu_torch.graphs`), kept in
    ``graph_cache``; off, they dispatch op by op.  On the CPU they are
    always eager."""

    levels: List[DeviceLevel]
    tail: Optional[DenseTail]
    n: int
    dtype: torch.dtype
    device: torch.device
    dense_inv: int
    chunk: object
    k_cap: object
    tran: Optional[List[TranLevel]] = None
    prod: Optional[List[ProdLevel]] = None
    prod_tran: Optional[List[ProdTranLevel]] = None
    nsp: Optional[NspFilter] = None
    nsp_tran: Optional[NspFilter] = None
    graphs: bool = True
    graph_cache: Optional[GraphCache] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def from_host(cls, precs, dtype=None, chunk="auto", k_cap="auto",
                  dense_inv="auto", device="cuda",
                  tail_on_device=False, graphs=True) -> "DevicePrec":
        """Pack host levels (:class:`~hifir_tpu_torch.alg.level.LevelPrec`).

        ``dtype=None`` keeps the host precision, complex128 included;
        ``dtype=np.complex64`` casts a complex host to single precision.  A
        complex host does not pack into a real dtype (TypeError).
        ``dense_inv``: levels with
        0 < m <= dense_inv apply L/U through an explicit dense inverse, levels
        with m <= 8 * dense_inv through the blocked inverse, larger ones (and
        all of them with ``dense_inv=0``) through the level scan; "auto" is
        2048.  A level with m == 0 packs an empty schedule.
        ``tail_on_device``: when the last level has a dense matrix, factorize
        it again on ``device`` in the pack's dtype with K8 (QRCP, the rank at
        the default ``rrqr_cond``) instead of packing the host's factors; a
        complex tail raises TypeError.
        ``graphs``: see the class docstring.
        """
        dev = resolve_device(device)
        dense_inv = _dense_inv(dense_inv)
        host = _host_dtype(precs)
        ndt = host if dtype is None else numpy_dtype(dtype)
        tdt = torch_dtype(ndt)
        if host.kind == "c" and not tdt.is_complex:
            raise TypeError(f"a complex preconditioner packs as complex64 "
                            f"or complex128, not {ndt}")

        def vec(a, dt=tdt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        i64 = torch.int64
        form = (dense_inv, chunk, k_cap, ndt, dev)
        with span("hifir.pack"):
            levels = []
            for prec in precs:
                with span("hifir.pack.trsv"):
                    L = _ldu_form(prec.L_B, True, *form)
                    U = _ldu_form(prec.U_B, False, *form)
                with span("hifir.pack.ell"):
                    E = sliced_ell_from_csr(prec.E, dtype=ndt, device=dev)
                    F = sliced_ell_from_csr(prec.F, dtype=ndt, device=dev)
                levels.append(DeviceLevel(
                    p=vec(prec.p, i64), q_inv=vec(prec.q_inv, i64),
                    s_p=vec(prec.s[prec.p]), t=vec(prec.t), d=vec(prec.d),
                    L=L, U=U, E=E, F=F, m=prec.m, n=prec.n,
                    q=vec(prec.q, i64), p_inv=vec(prec.p_inv, i64),
                    s=vec(prec.s), t_q=vec(prec.t[prec.q])))
            last = precs[-1]
            with span("hifir.pack.tail"):
                if tail_on_device and last.dense_matrix is not None:
                    tail = _device_tail(last.dense_matrix, tdt, dev)
                else:
                    tail = _dense_tail(last, tdt, dev)
        return cls(levels=levels, tail=tail,
                   n=precs[0].n, dtype=tdt, device=dev, dense_inv=dense_inv,
                   chunk=chunk, k_cap=k_cap, graphs=graphs)

    def operands(self):
        """The ``(levels, tail)`` that the module functions take, as the JAX
        package's ``operands()`` hands its pytrees to outer jitted solvers
        (here to :func:`~hifir_tpu_torch.graphs.jit`)."""
        return self.levels, self.tail

    def _drop(self, operands) -> None:
        """Forget the graphs captured on operands about to be replaced."""
        if self.graph_cache is not None and operands is not None:
            self.graph_cache.drop(operands)

    def _call(self, fn, *args):
        """``fn(*args)`` as a replay of the pack's graph, or eagerly."""
        cache = cache_of(self)
        return fn(*args) if cache is None else cache.call(fn, *args)

    def pack_transpose(self, host_precs) -> None:
        """Pack the adjoint operands (U_B^H and L_B^H in the triangular form
        of the forward factors, by the pack's ``dense_inv``, ``chunk`` and
        ``k_cap``; E^H and F^H as sliced ELL) in the pack's dtype, on its
        device."""
        ndt = numpy_dtype(self.dtype)
        dev = self.device
        form = (self.dense_inv, self.chunk, self.k_cap, ndt, dev)
        self._drop(self.tran)
        self.tran = [TranLevel(
            LT=_ldu_form(_adjoint(hp.L_B), False, *form),
            UT=_ldu_form(_adjoint(hp.U_B), True, *form),
            ET=sliced_ell_from_csr(_adjoint(hp.E), dtype=ndt, device=dev),
            FT=sliced_ell_from_csr(_adjoint(hp.F), dtype=ndt, device=dev))
            for hp in host_precs]

    def pack_prod(self, host_precs) -> None:
        """Pack the forward-product operands (L_B and U_B as sliced ELL)."""
        ndt = numpy_dtype(self.dtype)
        self._drop(self.prod)
        self.prod = [ProdLevel(
            Lell=sliced_ell_from_csr(hp.L_B, dtype=ndt, device=self.device),
            Uell=sliced_ell_from_csr(hp.U_B, dtype=ndt, device=self.device))
            for hp in host_precs]

    def pack_prod_tran(self, host_precs) -> None:
        """Pack the adjoint-product operands (L_B^H and U_B^H as sliced
        ELL); packs the adjoint operands first when they are absent."""
        if self.tran is None:
            self.pack_transpose(host_precs)
        ndt = numpy_dtype(self.dtype)
        self._drop(self.prod_tran)
        self.prod_tran = [ProdTranLevel(
            LellH=sliced_ell_from_csr(_adjoint(hp.L_B), dtype=ndt,
                                      device=self.device),
            UellH=sliced_ell_from_csr(_adjoint(hp.U_B), dtype=ndt,
                                      device=self.device))
            for hp in host_precs]

    def _solve(self, B, trans: bool, r) -> torch.Tensor:
        B = as_values(B, self.dtype, self.device)
        if not trans:
            return self._call(prec_solve_mrhs, self.levels, self.tail, B, r)
        if self.tran is None:
            raise RuntimeError("call pack_transpose() before trans solves")
        return self._call(prec_solve_tran_mrhs, self.levels, self.tran,
                          self.tail, B, r)

    def solve_mrhs(self, B, trans: bool = False, r: int = 0) -> torch.Tensor:
        """X = M^{-1} B (``trans``: M^{-H} B) for B of shape (n, nrhs), on
        the pack's device.  ``r > 0`` overrides the dense tail's rank; the
        filter ``nsp`` (``nsp_tran``) is applied to every column, after the
        graph."""
        with span("hifir.solve"):
            X = self._solve(B, trans, r)
            return nsp_filter(self.nsp_tran if trans else self.nsp, X)

    def solve(self, b, trans: bool = False, r: int = 0) -> torch.Tensor:
        """x = M^{-1} b (``trans``: M^{-H} b) for one vector: the one-column
        batched solve, then the filter on the vector."""
        with span("hifir.solve"):
            x = self._solve(as_values(b, self.dtype, self.device)[:, None],
                            trans, r)[:, 0]
            return nsp_filter(self.nsp_tran if trans else self.nsp, x)

    def mmultiply(self, x, trans: bool = False) -> torch.Tensor:
        """y = M x (``trans``: M^H x) for one vector, on the pack's
        device."""
        with span("hifir.solve"):
            X = as_values(x, self.dtype, self.device)[:, None]
            if trans:
                if self.prod_tran is None:
                    raise RuntimeError("call pack_prod_tran() before trans "
                                       "mmultiply")
                return self._call(prec_prod_tran_mrhs, self.levels,
                                  self.tran, self.prod_tran, self.tail,
                                  X)[:, 0]
            if self.prod is None:
                raise RuntimeError("call pack_prod() before mmultiply")
            return self._call(prec_prod_mrhs, self.levels, self.prod,
                              self.tail, X)[:, 0]
