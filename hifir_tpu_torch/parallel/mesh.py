"""A ``(rhs, rows)`` grid of ranks over torch devices, and its collectives.

The port of ``hifir_tpu/parallel/mesh.py``.  The JAX package runs its
distribution single-controller, ``shard_map`` over a ``Mesh`` of local
devices; here a :class:`Mesh` lays ranks out over a list of
``torch.device`` s that may repeat one device (eight ranks on ``cuda:0``,
or on ``cpu`` in the tests, as the JAX tests' eight virtual CPU devices).

Every rank keeps its own buffers.  The ranks of a ``rows`` axis that share
a device keep theirs as the rows of one tensor (a *group*): a distributed
value is a list with one tensor of shape ``(ranks in the group, ...)`` per
group, so that one operation covers every rank of a device.  The
collectives the JAX code uses are written over such lists:

- :meth:`Mesh.shift` (``ppermute`` to the right or left neighbour, or
  around the ring), :meth:`Mesh.all_gather` (tiled), :meth:`Mesh.psum`;
- within a group they are gathers and copies; between groups, peer copies
  (``.to(device, non_blocking=True)``), which torch issues on the current
  streams of both ends.  Inside a captured graph
  (:mod:`~hifir_tpu_torch.graphs`) every card's current stream is one that
  the capture forked, so each copy is a node of the graph and runs at
  every replay.

A mesh owns the graph cache (``graphs``, ``graph_cache``) of the programs
over it that the JAX package jits on its own: the distributed trsv and
SpMV applies, the sharded IR step, the ring Schur step and rotation.
``mesh.graphs = False`` runs them eagerly.

A group's card is :func:`device_index` of its device (``"cuda"`` is the
current card, so ``"cuda:0"`` and ``"cuda"`` are two groups of one card);
:meth:`Mesh.peer_access` says which groups can store into each other's
memory, which decides how a distributed trsv runs its chunk loop.

Axes: ``rhs`` splits right-hand sides (no communication), ``rows`` splits
the rows of the sparse operators.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Group", "Mesh", "make_mesh", "device_index",
           "can_device_access_peer"]


def device_index(dev: torch.device) -> Optional[int]:
    """The card of a CUDA device (``"cuda"`` without an index is the current
    card), None for the CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.current_device() if dev.index is None else dev.index


def can_device_access_peer(a: torch.device, b: torch.device) -> bool:
    """Whether a kernel running on ``a`` can store into ``b``'s memory: one
    card, two CPU devices (one host memory), or two cards with peer access
    (``torch.cuda.can_device_access_peer``)."""
    if a.type == b.type == "cpu":
        return True
    if a.type == b.type == "cuda":
        ia, ib = device_index(a), device_index(b)
        return ia == ib or torch.cuda.can_device_access_peer(ia, ib)
    return False


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks ``lo .. hi - 1`` of a ``rows`` axis, all on ``device``."""

    device: torch.device
    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


class Mesh:
    """``(rhs, rows)`` grid of ranks; ``devices`` holds each rank's device,
    rhs-major (rank ``i * rows + k`` is rows-rank k of rhs-row i)."""

    def __init__(self, devices: Sequence, rhs: int = 1):
        devs = [torch.device(d) for d in devices]
        if not devs or len(devs) % rhs:
            raise ValueError(f"{len(devs)} ranks do not split into rhs={rhs}")
        self.devices = tuple(devs)
        self.shape = {"rhs": rhs, "rows": len(devs) // rhs}
        self.graphs = True
        self.graph_cache = None

    @property
    def D(self) -> int:
        """Ranks along ``rows``."""
        return self.shape["rows"]

    @property
    def device(self) -> torch.device:
        """The first rank's device: where a caller's replicated input and
        rank 0's result live."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={list(self.devices)})"

    def groups(self, i: int = 0) -> List[Group]:
        """The groups of rhs-row ``i``: runs of ranks on one device."""
        D = self.D
        devs = self.devices[i * D:(i + 1) * D]
        out, lo = [], 0
        for k in range(1, D + 1):
            if k == D or devs[k] != devs[lo]:
                out.append(Group(devs[lo], lo, k))
                lo = k
        return out

    def peer_access(self, i: int = 0) -> np.ndarray:
        """(G, G) bool: whether group g of rhs-row ``i`` can store into group
        h's memory (:func:`can_device_access_peer`; True on the diagonal)."""
        gs = self.groups(i)
        return np.array([[g is h or can_device_access_peer(g.device,
                                                            h.device)
                          for h in gs] for g in gs])

    def row_mesh(self, i: int) -> "Mesh":
        """The one-row mesh of rhs-row ``i``."""
        D = self.D
        return Mesh(self.devices[i * D:(i + 1) * D])

    # -- placing -------------------------------------------------------------
    def put(self, arr, dtype=None) -> List[torch.Tensor]:
        """Rank-major host array ``arr`` (leading axis D) as a distributed
        value: each group's rows on its device."""
        a = np.ascontiguousarray(arr)
        if a.shape[0] != self.D:
            raise ValueError(f"leading axis {a.shape[0]} != {self.D} ranks")
        return [torch.as_tensor(a[g.lo:g.hi], dtype=dtype, device=g.device)
                for g in self.groups()]

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A copy of ``t`` for every rank."""
        return [t.to(g.device).unsqueeze(0).expand(g.size, *t.shape)
                .contiguous() for g in self.groups()]

    def collect(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """The distributed value as one (D, ...) tensor on the first group's
        device (for a caller outside the mesh)."""
        dev = self.groups()[0].device
        return torch.cat([x.to(dev) for x in xs])

    # -- collectives ---------------------------------------------------------
    def shift(self, xs: List[torch.Tensor], step: int, ring: bool = False,
              out: Optional[List[torch.Tensor]] = None
              ) -> List[torch.Tensor]:
        """``ppermute``: rank k receives rank (k - step)'s block.  Without
        ``ring`` the ranks with no sender (k - step outside [0, D)) receive
        zeros, as the JAX package's edge devices do.  ``out`` (a list of
        per-group views, possibly of a larger buffer) receives the blocks."""
        D, groups = self.D, self.groups()
        if out is None:
            out = [torch.empty_like(x) for x in xs]
        for g, o in zip(groups, out):
            k = g.lo
            while k < g.hi:
                src = k - step
                if ring:
                    src %= D
                if not 0 <= src < D:
                    o[k - g.lo:k - g.lo + 1].zero_()
                    k += 1
                    continue
                sg = next(s for s, h in enumerate(groups)
                          if h.lo <= src < h.hi)
                h = groups[sg]
                # the longest run of ranks whose senders lie in group h
                run = min(g.hi - k, h.hi - src)
                blk = xs[sg][src - h.lo:src - h.lo + run]
                o[k - g.lo:k - g.lo + run].copy_(
                    blk if h.device == g.device
                    else blk.to(g.device, non_blocking=True))
                k += run
        return out

    def all_gather(self, xs: List[torch.Tensor],
                   out: Optional[List[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
        """Tiled ``all_gather`` along each rank's first block axis: every
        rank receives the concatenation of all ranks' blocks (rank order),
        shape (D * W, ...) for blocks of shape (W, ...)."""
        groups = self.groups()
        res = []
        for i, g in enumerate(groups):
            if len(groups) == 1:
                full = xs[0].reshape(-1, *xs[0].shape[2:])
            else:
                full = torch.cat([
                    (x if groups[j].device == g.device
                     else x.to(g.device, non_blocking=True))
                    .reshape(-1, *x.shape[2:]) for j, x in enumerate(xs)])
            if out is None:
                res.append(full.unsqueeze(0).expand(g.size, *full.shape)
                           .contiguous())
            else:
                res.append(out[i].copy_(full))   # broadcast over the ranks
        return res

    def psum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over the ranks, the result on every rank."""
        groups = self.groups()
        dev = groups[0].device
        total = sum(x.to(dev).sum(0) for x in xs)
        return [total.to(g.device).unsqueeze(0).expand(g.size, *total.shape)
                .contiguous() for g in groups]

    def axis_index(self) -> List[torch.Tensor]:
        """Each rank's index along ``rows``."""
        return [torch.arange(g.lo, g.hi, device=g.device)
                for g in self.groups()]


def make_mesh(n_ranks: Optional[int] = None, rhs: int = 1, device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(rhs, rows)`` mesh of ``n_ranks`` ranks.

    ``devices`` lists each rank's device (it may repeat one; its length is
    the default rank count); without it every rank lives on ``device``,
    eight ranks by default (the JAX tests' eight virtual devices), so that
    one card runs every exchange path."""
    if devices is None:
        dev = resolve_device(device)
        devices = [dev] * (8 if n_ranks is None else n_ranks)
    else:
        devices = [resolve_device(d) for d in devices]
        if n_ranks is not None:
            devices = devices[:n_ranks]
    return Mesh(devices, rhs=rhs)
