"""Neighbour-only halo-exchange SpMV.

The port of ``hifir_tpu/parallel/halo.py``.  For banded orderings a row
shard only references x entries of its two ring neighbours: each rank sends
its head to the left and its tail to the right (:meth:`Mesh.shift`, the
``ppermute`` legs), and multiplies its row block against
``[halo_l | local | halo_r | 0]`` with kernel K1, the ranks of a device in
one launch.  Host preprocessing computes the halo width; a sparsity that
needs more than one neighbour shard raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..graphs import jit
from ..ops.spmv import ELL, sliced_ell_sub_mrhs
from .mesh import Mesh
from .sharded import pad_rows, stacked_ell

__all__ = ["HaloSpMV", "build_halo_spmv", "halo_spmv"]


@dataclasses.dataclass
class HaloSpMV:
    """Row-sharded operator with halo-local column coordinates."""

    mesh: Mesh
    idx: List[torch.Tensor]   # per group (g, nb, K) int32 local coords into
    #                           [halo_l | local | halo_r], pad = width
    val: List[torch.Tensor]   # per group (g, nb, K)
    n: int                    # logical size
    nb: int                   # rows per shard
    halo: int                 # one-sided halo width (symmetric)
    ells: List[ELL] = dataclasses.field(default_factory=list, repr=False)

    @property
    def width(self) -> int:
        return self.nb + 2 * self.halo


def build_halo_spmv(mesh: Mesh, A, dtype=None) -> HaloSpMV:
    """Pack a host CSR for halo SpMV; raises ValueError when the sparsity
    needs more than one neighbour shard of halo."""
    D = mesh.D
    n = A.nrows
    Ap = pad_rows(A, D)
    npad = Ap.nrows
    nb = npad // D

    rows = np.repeat(np.arange(npad, dtype=np.int64), np.diff(Ap.indptr))
    shard_of_row = rows // nb
    cols = Ap.indices.astype(np.int64)
    lo = shard_of_row * nb - cols
    hi = cols - ((shard_of_row + 1) * nb - 1)
    halo = int(max(lo.max(initial=0), hi.max(initial=0), 0))
    if halo > nb:
        raise ValueError(
            f"bandwidth needs halo {halo} > shard size {nb}; use the "
            "all_gather SpMV instead")

    counts = np.diff(Ap.indptr)
    K = max(int(counts.max()) if npad else 0, 1)
    width = nb + 2 * halo
    idx = np.full((npad, K), width, dtype=np.int32)
    val = np.zeros((npad, K), dtype=Ap.data.dtype if dtype is None else dtype)
    if Ap.indices.size:
        offs = (np.arange(Ap.indices.size, dtype=np.int64)
                - np.repeat(Ap.indptr[:-1], counts))
        local = cols - (shard_of_row * nb - halo)
        idx[rows, offs] = local.astype(np.int32)
        val[rows, offs] = Ap.data
    H = HaloSpMV(mesh, mesh.put(idx.reshape(D, nb, K)),
                 mesh.put(val.reshape(D, nb, K)), n, nb, halo)
    H.ells = [stacked_ell(i, v, width, width + 1)
              for i, v in zip(H.idx, H.val)]
    return H


def halo_spmv(H: HaloSpMV, x) -> torch.Tensor:
    """y = A x with x and y row-sharded: ``x`` is the padded vector of the
    ranks' blocks (rank order), split into one block a rank; only
    neighbour halos move.  Returns y the same way.  One program of the
    mesh's graph cache for each shape and dtype of x (the JAX package jits
    it), replayed."""
    x = torch.as_tensor(x, device=H.mesh.device)
    return jit(H.mesh, _halo_spmv)(H, x)


def _halo_spmv(H: HaloSpMV, x: torch.Tensor) -> torch.Tensor:
    mesh, nb, halo = H.mesh, H.nb, H.halo
    xs = [x.view(mesh.D, nb)[g.lo:g.hi].to(g.device) for g in mesh.groups()]
    # each rank's [halo_l | local | halo_r | 0]
    ext = [xl.new_zeros((xl.shape[0], H.width + 1)) for xl in xs]
    for e, xl in zip(ext, xs):
        e[:, halo:halo + nb] = xl
    if halo:
        # tail to the right neighbour, head to the left; edge ranks get 0
        mesh.shift([xl[:, nb - halo:] for xl in xs], 1,
                   out=[e[:, :halo] for e in ext])
        mesh.shift([xl[:, :halo] for xl in xs], -1,
                   out=[e[:, halo + nb:H.width] for e in ext])
    ys = [sliced_ell_sub_mrhs(ell, e.reshape(-1, 1)).view(-1, nb)
          for ell, e in zip(H.ells, ext)]
    return mesh.collect(ys).reshape(-1)
