"""Sharded-vector exchange plans (neighbour packages + compact all_gather).

The port of ``hifir_tpu/parallel/exchange.py``.  A vector distributed by
producer blocks (rank o owns ``[o*blk, (o+1)*blk)``) is consumed by
per-rank need lists of arbitrary entry ids.  Instead of replicating the
whole vector, the host builds a three-leg plan sized to the real
cross-rank footprint (the transport mix of :mod:`.trsv_halo`): ring
neighbours' entries ride two neighbour sends, the far remainder one
compact all_gather, or a pure compact all_gather where the host count says
the mix is not cheaper.

:class:`~.prec_sharded.DistPrec` uses it for the inter-level link of the
M-solve's down-sweep: the E-product's output stays distributed and the next
level's permutation gather fetches exactly its footprint.  The plan equals
the JAX package's (``sends``, ``fetch``, ``meta``, the counts).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["XPlan", "build_exchange_plan", "xplan_fetch"]


@dataclasses.dataclass
class XPlan:
    """Exchange and fetch plan.

    A rank's receive buffer is ``[own block (blk) | zero (1) | from-left
    (Wl) | from-right (Wr) | all-gathered (D*Wag)]``; ``fetch`` holds each
    rank's need list in buffer coordinates.  Per-rank operands are lists
    with one (ranks, ...) tensor per group."""

    mesh: Mesh
    sends: Tuple[List[torch.Tensor], ...]  # up to 3 legs of (ranks, W)
    fetch: List[torch.Tensor]              # (ranks, need_len) int64
    meta: tuple                            # (Wl, Wr, Wag)
    blk: int
    D: int
    comm_elems: int                        # host-counted exchanged elements
    allgather_elems: int                   # what a tiled all_gather moves

    def nbytes(self) -> int:
        ts = [t for leg in self.sends for t in leg] + list(self.fetch)
        return sum(t.numel() * t.element_size() for t in ts)


def build_exchange_plan(mesh: Mesh, n: int, blk: int,
                        need: np.ndarray) -> XPlan:
    """The plan for a producer-block-distributed vector of ``n`` live
    entries (rank o owns ``[o*blk, (o+1)*blk)``; ids >= n fetch zero).

    ``need``: (D, need_len) int array of the entry ids each rank fetches."""
    D = mesh.D
    if need.shape[0] != D:
        raise ValueError(f"need has {need.shape[0]} rows for {D} ranks")
    LIVE = need < n
    owner = np.where(LIVE, need // blk, np.arange(D)[:, None])
    sentinel = blk  # own-block coordinate of the appended zero

    def by_owner(sets):
        u = np.unique(np.concatenate(sets)) if sets else np.empty(0, np.int64)
        start = np.searchsorted(u // blk, np.arange(D + 1))
        return u, start

    all_foreign = [np.unique(need[k][LIVE[k] & (owner[k] != k)])
                   for k in range(D)]
    fl, fr, far = [], [], []
    for k, f in enumerate(all_foreign):
        o = f // blk
        fl.append(f[o == k - 1])
        fr.append(f[o == k + 1])
        far.append(f[(o != k - 1) & (o != k + 1)])
    Wl = max((len(s) for s in fl), default=0)
    Wr = max((len(s) for s in fr), default=0)
    union, ustart = by_owner(far)
    Wag = int(np.diff(ustart).max(initial=0))
    union_all, ustart_all = by_owner(all_foreign)
    Wag_all = int(np.diff(ustart_all).max(initial=0))
    if D * Wag_all < Wl + Wr + D * Wag:
        fl = fr = [s[:0] for s in fl]
        far, union, ustart = all_foreign, union_all, ustart_all
        Wl = Wr = 0
        Wag = Wag_all

    off_l = blk + 1
    off_r = off_l + Wl
    off_ag = off_r + Wr
    comm = 0

    # every rank's buffer coordinate of every entry id
    loc = np.full((D, n + 1), sentinel, dtype=np.int64)
    for k in range(D):
        lo, hi = k * blk, min((k + 1) * blk, n)
        if hi > lo:
            loc[k, lo:hi] = np.arange(hi - lo)

    sends = []
    if Wl:
        send_r = np.full((D, Wl), sentinel, dtype=np.int64)
        for k in range(D):
            if k + 1 < D:
                send_r[k, :len(fl[k + 1])] = fl[k + 1] - k * blk
            loc[k, fl[k]] = off_l + np.arange(len(fl[k]))
        sends.append(send_r)
        comm += (D - 1) * Wl
    if Wr:
        send_l = np.full((D, Wr), sentinel, dtype=np.int64)
        for k in range(D):
            if k >= 1:
                send_l[k, :len(fr[k - 1])] = fr[k - 1] - k * blk
            loc[k, fr[k]] = off_r + np.arange(len(fr[k]))
        sends.append(send_l)
        comm += (D - 1) * Wr
    if Wag:
        send = np.full((D, Wag), sentinel, dtype=np.int64)
        for o in range(D):
            u = union[ustart[o]:ustart[o + 1]]
            send[o, :len(u)] = u - o * blk
        for k in range(D):
            s = far[k]
            o = s // blk
            loc[k, s] = off_ag + o * Wag + np.searchsorted(union, s) \
                - ustart[o]
        sends.append(send)
        comm += D * (D - 1) * Wag

    fetch = np.take_along_axis(
        loc, np.where(LIVE, need, 0).astype(np.int64), axis=1)
    fetch = np.where(LIVE, fetch, sentinel)
    return XPlan(mesh, tuple(mesh.put(s) for s in sends), mesh.put(fetch),
                 (Wl, Wr, Wag), blk, D, comm, (D - 1) * D * blk)


def xplan_fetch(plan: XPlan, ys: List[torch.Tensor]) -> List[torch.Tensor]:
    """Exchange and fetch: ``ys`` are the ranks' (blk,) producer blocks (per
    group (ranks, blk)); returns each rank's (need_len,) fetched entries."""
    mesh, D = plan.mesh, plan.D
    Wl, Wr, Wag = plan.meta
    blk = plan.blk
    bufs = []
    for y in ys:
        buf = y.new_zeros((y.shape[0], blk + 1 + Wl + Wr + D * Wag))
        buf[:, :blk] = y
        bufs.append(buf)
    legs = iter(plan.sends)
    off = blk + 1
    if Wl:
        pkg = [b.gather(1, s) for b, s in zip(bufs, next(legs))]
        mesh.shift(pkg, 1, out=[b[:, off:off + Wl] for b in bufs])
        off += Wl
    if Wr:
        pkg = [b.gather(1, s) for b, s in zip(bufs, next(legs))]
        mesh.shift(pkg, -1, out=[b[:, off:off + Wr] for b in bufs])
        off += Wr
    if Wag:
        pkg = [b.gather(1, s) for b, s in zip(bufs, next(legs))]
        mesh.all_gather(pkg, out=[b[:, off:off + D * Wag] for b in bufs])
    return [b.gather(1, f) for b, f in zip(bufs, plan.fetch)]
