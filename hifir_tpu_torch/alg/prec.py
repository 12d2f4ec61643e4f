"""Multilevel preconditioner on the device: packing and the batched M-solve.

The port of the forward half of ``hifir_tpu/alg/prec.py``: per-level
operands are packed once (scalings and permutations as index tensors, L_B
and U_B as one of the three triangular forms of :mod:`..ops.trsv`, E and F
as sliced ELL, the dense tail as QR/eigen/LU factors) and the solve walks the
levels down and up in eager PyTorch.  The sparse work runs in the kernels of
:mod:`..ops`; the dense work (explicit inverses, tail) in ``torch.matmul``
and ``torch.linalg.solve_triangular``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device, torch_dtype
from ..ops.spmv import SlicedELL, sliced_ell_from_csr, sliced_ell_sub_mrhs
from ..ops.trsv import (build_trsv_block_dense, build_trsv_dense,
                        build_trsv_schedule, trsv_apply_mrhs)

__all__ = ["DeviceLevel", "DenseTail", "DevicePrec", "prec_solve_mrhs"]


@dataclasses.dataclass
class DenseTail:
    """Dense last level: truncated-rank QRCP, symmetric eigen or LU factors."""

    Q: torch.Tensor       # (nm, nm) Q (QRCP), V (SYEIG), unit-lower L (LUP)
    R: torch.Tensor       # (nm, nm) upper triangular (QRCP/LUP)
    jpvt: torch.Tensor    # (nm,) int64 col pivots / eig order / row perm
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


def _ldu_solve_mrhs(lvl: DeviceLevel, Y: torch.Tensor) -> torch.Tensor:
    """Y <- U^{-1} D^{-1} L^{-1} Y."""
    Y = trsv_apply_mrhs(lvl.L, Y)
    Y = Y / lvl.d[:, None]
    return trsv_apply_mrhs(lvl.U, Y)


def _tail_solve_mrhs(tail: DenseTail, Y: torch.Tensor) -> torch.Tensor:
    r = tail.rank
    if tail.kind == "syeig":
        Vr = tail.Q[:, :r]
        return Vr @ ((Vr.mH @ Y) / tail.w[:r, None])
    if tail.kind == "lup":
        Z = torch.linalg.solve_triangular(tail.Q, Y[tail.jpvt], upper=False,
                                          unitriangular=True)
        return torch.linalg.solve_triangular(tail.R, Z, upper=True)
    wv = tail.Q[:, :r].mH @ Y
    Z = torch.linalg.solve_triangular(tail.R[:r, :r], wv, upper=True)
    return torch.zeros_like(Y).index_copy_(0, tail.jpvt[:r], Z)


def prec_solve_mrhs(levels: List[DeviceLevel], tail: Optional[DenseTail],
                    B: torch.Tensor) -> torch.Tensor:
    """Multilevel solve X = M^{-1} B for B of shape (n, nrhs).

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
    if tail is None:
        x_tail = rhs
    elif tail.rank == 0:
        x_tail = torch.zeros_like(rhs)
    else:
        x_tail = _tail_solve_mrhs(tail, rhs)
    for lvl, wb in zip(reversed(levels), reversed(wbs)):
        m = lvl.m
        head = wb[:m]
        if lvl.n - m:
            sliced_ell_sub_mrhs(lvl.F, x_tail, head, out=head)
        x1 = _ldu_solve_mrhs(lvl, head)
        sol = torch.cat([x1, x_tail])
        x_tail = lvl.t[:, None] * sol[lvl.q_inv]
    return x_tail


def _dense_tail(last, dtype: torch.dtype, dev) -> Optional[DenseTail]:
    ds = last.dense_solver
    if ds is None:
        return None

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    if ds.kind == "qrcp":
        return DenseTail(f(ds.Q), f(ds.R), i(ds.jpvt), f(np.zeros(ds.n)),
                         ds.rank, "qrcp")
    if ds.kind == "syeig":
        order = np.argsort(-np.abs(ds.w))
        return DenseTail(f(ds.V[:, order]), f(np.zeros((ds.n, ds.n))),
                         i(order), f(ds.w[order]), ds.rank, "syeig")
    lu = ds.lu
    return DenseTail(f(np.tril(lu, -1) + np.eye(ds.n)), f(np.triu(lu)),
                     i(ds.piv_perm()), f(np.zeros(ds.n)), ds.rank, "lup")


@dataclasses.dataclass
class DevicePrec:
    """Whole multilevel preconditioner on one device."""

    levels: List[DeviceLevel]
    tail: Optional[DenseTail]
    n: int
    dtype: torch.dtype
    device: torch.device

    @classmethod
    def from_host(cls, precs, dtype=None, chunk="auto", k_cap="auto",
                  dense_inv="auto", device="cuda") -> "DevicePrec":
        """Pack host levels (:class:`~hifir_tpu_torch.alg.level.LevelPrec`).

        ``dtype=None`` keeps the host precision.  ``dense_inv``: levels with
        0 < m <= dense_inv apply L/U through an explicit dense inverse, levels
        with m <= 8 * dense_inv through the blocked inverse, larger ones (and
        all of them with ``dense_inv=0``) through the level scan; "auto" is
        2048.  A level with m == 0 packs an empty schedule.
        """
        dev = resolve_device(device)
        if dense_inv == "auto":
            dense_inv = 2048
        dense_inv = int(dense_inv)
        if dtype is None:
            dtype = next((np.asarray(p.d).dtype for p in precs if p.m),
                         np.float64)
        ndt = numpy_dtype(dtype)
        tdt = torch_dtype(ndt)

        def _ldu(T, lower):
            if 0 < T.nrows <= dense_inv:
                return build_trsv_dense(T, lower=lower, dtype=ndt, device=dev)
            if dense_inv and 0 < T.nrows <= 8 * dense_inv:
                return build_trsv_block_dense(T, lower=lower, W=dense_inv,
                                              dtype=ndt, device=dev)
            return build_trsv_schedule(T, lower=lower, chunk=chunk, dtype=ndt,
                                       k_cap=k_cap, device=dev)

        def vec(a, dt=tdt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        levels = [DeviceLevel(
            p=vec(prec.p, torch.int64), q_inv=vec(prec.q_inv, torch.int64),
            s_p=vec(prec.s[prec.p]), t=vec(prec.t), d=vec(prec.d),
            L=_ldu(prec.L_B, lower=True), U=_ldu(prec.U_B, lower=False),
            E=sliced_ell_from_csr(prec.E, dtype=ndt, device=dev),
            F=sliced_ell_from_csr(prec.F, dtype=ndt, device=dev),
            m=prec.m, n=prec.n) for prec in precs]
        return cls(levels=levels, tail=_dense_tail(precs[-1], tdt, dev),
                   n=precs[0].n, dtype=tdt, device=dev)

    def solve_mrhs(self, B) -> torch.Tensor:
        """X = M^{-1} B for B of shape (n, nrhs), on the pack's device."""
        B = torch.as_tensor(B, dtype=self.dtype, device=self.device)
        return prec_solve_mrhs(self.levels, self.tail, B)

    def solve(self, b) -> torch.Tensor:
        """x = M^{-1} b for one vector (the one-column batched solve)."""
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        return self.solve_mrhs(b[:, None])[:, 0]
