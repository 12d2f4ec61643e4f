"""Row-sharded SpMV and the distributed IR step.

The port of ``hifir_tpu/parallel/sharded.py``: row-block sharded SpMV
(x replicated in, y row-sharded out) and the multi-rank IR step
``X <- X + M^{-1}(B - A X)`` on a ``(rhs, rows)`` mesh, A row-sharded over
``rows`` and the right-hand sides split over ``rhs``.

Each rank's row block goes through kernel K1 (:mod:`..ops.spmv`); the ranks
of a device share one launch: their blocks are one ELL operator over their
stacked copies of X (rank r's column c is column ``r * rows(X) + c``).  In
the IR step K1's fused ``C - A X`` gives ``R_local = B_local - A_local X``
in that one launch; a tiled all_gather assembles R on every rank, and the
M-solve runs replicated, every rank on its own copy (the copies of a
device as the columns of one batched solve, on that device's copy of the
pack, made once for a device other than the pack's).  The step is one
captured graph of the mesh's cache for each operator, pack, shape and
dtype (the JAX package jits it): the K1 residual of every rank row, the
all_gather and the M-solve of every card's copy, replayed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..alg.prec import prec_solve_mrhs
from ..ds.csr import CSR
from ..graphs import jit
from ..ops.spmv import ELL, ell_from_csr, sliced_ell_sub_mrhs
from .mesh import Mesh

__all__ = ["pad_rows", "ShardedELL", "shard_ell_rows", "stacked_ell",
           "sharded_spmv", "make_sharded_ir_step"]


def pad_rows(A, multiple: int):
    """Pad a host CSR with empty rows to a multiple (for even row
    sharding)."""
    n = A.nrows
    npad = (-n) % multiple
    if npad == 0:
        return A
    indptr = np.concatenate([A.indptr,
                             np.full(npad, A.indptr[-1], dtype=np.int64)])
    return CSR(n + npad, A.ncols, indptr, A.indices, A.data)


def stacked_ell(idx: torch.Tensor, val: torch.Tensor, ncols: int,
                xrows: int) -> ELL:
    """The row blocks (R, nb, K) of R ranks on one device as one ELL
    operator over their stacked X blocks of ``xrows`` rows each: rank r's
    column c < ``ncols`` becomes ``r * xrows + c``, padding the stack's
    sentinel ``R * xrows``."""
    R, nb, K = idx.shape
    if R * max(xrows, 1) >= 2**31:
        raise ValueError(f"{R} ranks of {xrows} rows reach 2**31 stacked "
                         "columns, beyond K1's 32-bit indices")
    off = torch.arange(R, dtype=torch.int32, device=idx.device)[:, None,
                                                                 None] * xrows
    cols = torch.where(idx < ncols, idx + off,
                       torch.full_like(idx, R * xrows))
    return ELL(cols.reshape(R * nb, K).contiguous(),
               val.reshape(R * nb, K).contiguous(), R * nb, R * xrows)


@dataclasses.dataclass
class ShardedELL:
    """A host CSR's rows padded to the ``rows`` axis and split into one row
    block a rank (ELL, global column ids, padding column ``ncols``)."""

    mesh: Mesh
    idx: np.ndarray          # (D, nb, K) int32
    val: np.ndarray          # (D, nb, K)
    nrows: int               # padded rows
    ncols: int
    _placed: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nb(self) -> int:
        return self.idx.shape[1]

    def group_ells(self, i: int, xrows: int) -> List[ELL]:
        """The K1 operators of rhs-row ``i``'s groups over stacked X blocks
        of ``xrows`` rows (placed once, then kept)."""
        key = (i, xrows)
        if key not in self._placed:
            rm = self.mesh.row_mesh(i)
            self._placed[key] = [
                stacked_ell(ix, vl, self.ncols, xrows)
                for ix, vl in zip(rm.put(self.idx), rm.put(self.val))]
        return self._placed[key]


def shard_ell_rows(mesh: Mesh, A, dtype=None) -> ShardedELL:
    """Pack a host CSR into ELL with rows padded to the ``rows`` axis size,
    one row block a rank."""
    D = mesh.D
    Ap = pad_rows(A, D)
    e = ell_from_csr(Ap, dtype=dtype, device="cpu")
    nb = Ap.nrows // D
    return ShardedELL(mesh, e.indices.numpy().reshape(D, nb, -1),
                      e.values.numpy().reshape(D, nb, -1), Ap.nrows, A.ncols)


def sharded_spmv(mesh: Mesh, A: ShardedELL, x) -> torch.Tensor:
    """y = A x with A row-sharded: x replicated in (every rank a copy), y
    row-sharded out, returned as the (padded) vector of the ranks' blocks
    in rank order."""
    x = torch.as_tensor(x)
    ys = []
    for g, ell, xg in zip(mesh.groups(), A.group_ells(0, x.shape[0]),
                          mesh.replicate(x)):
        ys.append(sliced_ell_sub_mrhs(ell, xg.reshape(-1, 1)).view(
            g.size, A.nb))
    return mesh.collect(ys).reshape(-1)


def to_device(obj, dev: torch.device):
    """A pack's operands (tensors inside dataclasses, lists and tuples) on
    ``dev``: the same object where nothing moves."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(o, dev) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def make_sharded_ir_step(mesh: Mesh, n: int):
    """The multi-rank IR step ``X <- X + M^{-1}(B - A X)`` with A row-sharded
    over ``rows`` and the RHS batch split over ``rhs``.

    Returns ``step(A, levels, tail, X, B) -> X_new`` for a
    :class:`ShardedELL` A and the ``levels``/``tail`` of a
    :class:`~hifir_tpu_torch.alg.prec.DevicePrec` on the mesh's device.
    X and B are (n_padded, nrhs) with nrhs divisible by the ``rhs`` axis
    size and n_padded by the ``rows`` axis size; rhs-row i's ranks each
    take a copy of columns ``[i * nrhs / rhs, (i + 1) * nrhs / rhs)``.
    A call is a replay of the step's graph in ``mesh``'s cache, one a
    ``(A, levels, tail, X.shape, dtype)`` key (eager where the mesh's
    graphs are off or it has no capture backend); the pack's copy on
    another card is made by the first call's warm-up and kept."""
    R, D = mesh.shape["rhs"], mesh.D
    copies = {}    # (pack, device) -> the pack on that device

    def pack_on(levels, tail, dev):
        if (levels[0].p if levels else tail.Q).device == dev:
            return levels, tail
        key = (id(levels), id(tail), dev)
        if key not in copies:
            copies[key] = (levels, tail, to_device((levels, tail), dev))
        return copies[key][2]

    def ir_step(A: ShardedELL, levels, tail, X, B) -> torch.Tensor:
        npad, nrhs = X.shape
        w = nrhs // R
        out = torch.empty_like(X)
        for i in range(R):
            rm = mesh.row_mesh(i)
            cols = slice(i * w, (i + 1) * w)
            Xr = rm.replicate(X[:, cols])            # (g, npad, w) copies
            Bv = B[:, cols].reshape(D, A.nb, w)
            Rloc = []
            for g, ell, xg in zip(rm.groups(), A.group_ells(i, npad), Xr):
                Bg = Bv[g.lo:g.hi].to(g.device).reshape(-1, w)
                # R_local = B_local - A_local X in one K1 launch
                Rloc.append(sliced_ell_sub_mrhs(
                    ell, xg.reshape(-1, w), Bg).view(g.size, A.nb, w))
            Rs = rm.all_gather(Rloc)                # (g, npad, w) each
            for g, xg, Rg in zip(rm.groups(), Xr, Rs):
                # the replicated M-solve: the ranks' copies as columns
                Y = Rg[:, :n].permute(1, 0, 2).reshape(n, g.size * w)
                dX = prec_solve_mrhs(*pack_on(levels, tail, Rg.device), Y)
                xg[:, :n] += dX.reshape(n, g.size, w).permute(1, 0, 2)
            out[:, cols] = Xr[0][0].to(out.device)
        return out

    def step(A: ShardedELL, levels, tail, X, B) -> torch.Tensor:
        npad, nrhs = X.shape
        if nrhs % R or npad != A.nrows:
            raise ValueError(f"X is {tuple(X.shape)}: needs {A.nrows} rows "
                             f"and columns divisible by rhs={R}")
        return jit(mesh, ir_step)(A, levels, tail, X, B)

    return step
