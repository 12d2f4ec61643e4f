"""Distributed level-scheduled trsv with a compact per-chunk halo exchange.

The port of ``hifir_tpu/parallel/trsv_halo.py``.  Chunks of the level
schedule are split over the ``rows`` ranks as in :mod:`.trsv_sharded`
(rank k owns slots ``[c*C + k*Cloc, c*C + (k+1)*Cloc)`` of every chunk c),
but the working vector lives distributed: rank k keeps only its own slices
(``nchunks * Cloc`` entries) plus a halo region holding exactly the foreign
slots its rows read, counted on the host.  Every chunk carries its own
metadata: its dependency gather trimmed to its real fan-in ``K_c``, and an
exchange of up to three legs, each sized to the halo it carries:

- ring-neighbour dependencies ride two neighbour sends (``ppermute``);
- the far remainder rides one tiled all_gather of a compact package per
  rank (only the slots some non-neighbour rank reads);
- a pure compact all_gather is taken instead where the host count says the
  mix is not cheaper.

The host planning is the JAX package's, vectorized in numpy; ``meta``,
``sends``, ``comm_elems`` and ``allgather_elems`` equal the JAX plan's.

Each group's operands are packed chunk-major into flat buffers (a
:class:`~hifir_tpu_torch.ops.chunk.Sweep` of the ``halo`` form): every
chunk's (ranks, Cloc, K_c) dependency block at a 16-byte aligned offset,
its legs' send coordinates rank-major (ranks, Wl + Wr + Wag), and a record
per chunk on the device (its offsets, K_c and ``meta``).  The per-chunk
``gcols``, ``gvals`` and ``sends`` are views of those buffers.

The chunk loop (:func:`halo_op_kernel`) follows the factor's ``plan``,
laid out once from the mesh's topology
(:func:`~.trsv_sharded.loop_plan` over the packed sweeps):

- ``"sweep"``, one group (every ``rows`` rank on one device, as
  ``make_mesh`` puts them on the card): the whole loop is one call of
  :func:`~hifir_tpu_torch.ops.chunk.chunk_sweep`, on the card one launch of
  the redesigned K10a with the three legs inside it, on the CPU its plain
  version;
- ``"peer"``, several groups that reach each other's memory:
  :func:`~hifir_tpu_torch.ops.chunk.chunk_sweep_peer`, on the cards one
  launch a card, the legs of boundary ranks whose neighbour lies in
  another group and the compact all_gather stored through peer pointers;
- ``"chunk"``, some pair of cards without peer access, or asked for:
  :func:`halo_chunk_loop`, a K10a launch a chunk for each group, then the
  legs, each a gather of the package and a copy (peer copies across
  devices) into the receivers' halo regions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..graphs import jit
from ..ops.chunk import (ChunkSweep, Sweep, SweepPlan, chunk_sweep,
                         chunk_sweep_peer, with_slack)
from ..ops.trsv import build_trsv_schedule
from .mesh import Mesh
from .trsv_sharded import loop_plan

__all__ = ["HaloOp", "build_halo_op", "halo_op_kernel", "halo_chunk_loop",
           "halo_trsv_apply"]


@dataclasses.dataclass
class HaloOp:
    """One triangular factor's rank-distributed halo schedule.

    The per-rank operands are lists with one tensor per group of the mesh,
    the ranks of the group along the first axis."""

    mesh: Mesh
    in_rows: List[torch.Tensor]    # (ranks, own_len) int64 rows feeding own
    #                                slots (n: zero)
    out_slots: np.ndarray          # (n,) slot of each row (host)
    exit_pos: List[torch.Tensor]   # (n,) int64: each row's position in the
    #                                all_gathered own slices (rank-major)
    packed: List[Sweep]            # per group: the packed operands
    gcols: Tuple[List[torch.Tensor], ...]   # per chunk (ranks, Cloc, K_c)
    #                                 int32 local coordinates (packed views)
    gvals: Tuple[List[torch.Tensor], ...]   # per chunk (ranks, Cloc, K_c)
    sends: Tuple[Tuple[List[torch.Tensor], ...], ...]  # per chunk and leg
    #                               (ranks, W) int64 own coordinates to send
    #                               (packed views)
    meta: Tuple[tuple, ...]        # per chunk (off_l, Wl, off_r, Wr, off_ag,
    #   Wag): the legs' widths and halo offsets; ``sends`` holds the nonzero
    #   legs in that order
    nchunks: int
    Cloc: int
    own_len: int
    buf_len: int
    D: int
    n: int
    comm_elems: int                # host-counted exchanged elements
    allgather_elems: int           # what the tiled all_gather scheme moves
    plan: SweepPlan                # how the chunk loop runs (its sweeps are
    #                                ``packed``)

    def nbytes(self) -> int:
        """Bytes of the operand on all ranks (the packed buffers, which
        ``gcols``, ``gvals`` and ``sends`` view)."""
        ts = [t for p in self.packed for t in p.tensors()]
        ts += list(self.in_rows) + list(self.exit_pos)
        return sum(t.numel() * t.element_size() for t in ts)


def _plan(D: int, C: int, cols: np.ndarray, nchunks: int):
    """The JAX package's halo plan: per chunk meta and send coordinates
    (-1 unused), every rank's local coordinate of every slot (-1: none
    yet), the halo's end and the exchanged element count."""
    Cloc = C // D
    nslots = nchunks * C
    own_len = nchunks * Cloc
    K = cols.shape[2]
    slot = np.arange(nslots, dtype=np.int64)
    owner = (slot % C) // Cloc
    own_coord = (slot // C) * Cloc + (slot % C) - owner * Cloc

    dep = cols.reshape(nchunks, D, Cloc, K).transpose(1, 0, 2, 3)
    pad = dep >= nslots
    dep_owner = np.where(pad, -1, owner[np.minimum(dep, nslots - 1)])
    me = np.arange(D)[:, None, None, None]
    foreign = (~pad) & (dep_owner != me)

    # the foreign slots rank k reads, by the chunk that produced them
    need = []
    for k in range(D):
        f = np.unique(dep[k][foreign[k]])
        need.append((f, np.searchsorted(f // C, np.arange(nchunks + 1))))

    def by_owner(sets):
        """The union of ``sets`` (sorted: by owner, then slot) and where
        each owner's run starts in it."""
        u = np.unique(np.concatenate(sets))
        start = np.concatenate([[0], np.cumsum(np.bincount(
            owner[u], minlength=D))])
        return u, start

    loc = np.full((D, nslots + 1), -1, dtype=np.int64)
    meta, send_plans = [], []
    halo_off = own_len
    comm = 0
    empty = np.empty(0, np.int64)
    for c in range(nchunks):
        nd = [f[cut[c]:cut[c + 1]] for f, cut in need]
        if all(len(s) == 0 for s in nd):
            meta.append((0, 0, 0, 0, 0, 0))
            send_plans.append(())
            continue
        ow = [owner[s] for s in nd]
        fl = [nd[k][ow[k] == k - 1] for k in range(D)]
        fr = [nd[k][ow[k] == k + 1] for k in range(D)]
        far = [nd[k][(ow[k] != k - 1) & (ow[k] != k + 1)] for k in range(D)]
        Wl = max(len(s) for s in fl)
        Wr = max(len(s) for s in fr)
        union, ustart = by_owner(far)
        Wag = int(np.diff(ustart).max())
        union_all, ustart_all = by_owner(nd)
        Wag_all = int(np.diff(ustart_all).max())
        if D * Wag_all < Wl + Wr + D * Wag:
            fl = fr = [empty] * D
            far, union, ustart = nd, union_all, ustart_all
            Wl = Wr = 0
            Wag = Wag_all
        off_l = halo_off
        off_r = off_l + Wl
        off_ag = off_r + Wr
        halo_off = off_ag + D * Wag
        meta.append((off_l, Wl, off_r, Wr, off_ag, Wag))
        plan = []
        if Wl:
            send_r = np.full((D, Wl), -1, dtype=np.int64)
            for k in range(D):
                if k + 1 < D:
                    send_r[k, :len(fl[k + 1])] = own_coord[fl[k + 1]]
                loc[k, fl[k]] = off_l + np.arange(len(fl[k]))
            plan.append(send_r)
            comm += (D - 1) * Wl
        if Wr:
            send_l = np.full((D, Wr), -1, dtype=np.int64)
            for k in range(D):
                if k >= 1:
                    send_l[k, :len(fr[k - 1])] = own_coord[fr[k - 1]]
                loc[k, fr[k]] = off_r + np.arange(len(fr[k]))
            plan.append(send_l)
            comm += (D - 1) * Wr
        if Wag:
            send = np.full((D, Wag), -1, dtype=np.int64)
            for o in range(D):
                u = union[ustart[o]:ustart[o + 1]]
                send[o, :len(u)] = own_coord[u]
            for k in range(D):
                s = far[k]
                o = owner[s]
                rank = np.searchsorted(union, s) - ustart[o]
                loc[k, s] = off_ag + o * Wag + rank
            plan.append(send)
            comm += D * (D - 1) * Wag
        send_plans.append(tuple(plan))

    for k in range(D):
        mine = owner == k
        loc[k, :nslots][mine] = own_coord[mine]
    return meta, send_plans, loc, halo_off, comm, owner, own_coord, dep, pad


def _pack(g, lcs, lvs, Ks, legs, meta, Cloc: int, buf_len: int) -> Sweep:
    """Group ``g``'s share of the per-chunk operands (``lcs``/``lvs`` (D,
    Cloc, K_c), ``legs`` the nonzero legs' (D, W) send coordinates) packed
    chunk-major: each chunk's block at a 16-byte aligned offset of its flat
    buffer, and a record a chunk (coff, K_c, soff, meta, 0)."""
    R = g.size
    nchunks = len(Ks)
    csize = [R * Cloc * k for k in Ks]
    ssize = [R * sum(m[1::2]) for m in meta]
    up = lambda a, q: -(-a // q) * q  # noqa: E731
    coff = np.concatenate([[0], np.cumsum([up(n, 4) for n in csize])])
    soff = np.concatenate([[0], np.cumsum([up(n, 2) for n in ssize])])
    pc = np.zeros(coff[-1], np.int32)
    pv = np.zeros(coff[-1], lvs[0].dtype)
    ps = np.zeros(soff[-1], np.int64)
    for c in range(nchunks):
        pc[coff[c]:coff[c] + csize[c]] = lcs[c][g.lo:g.hi].ravel()
        pv[coff[c]:coff[c] + csize[c]] = lvs[c][g.lo:g.hi].ravel()
        if legs[c]:
            ps[soff[c]:soff[c] + ssize[c]] = np.concatenate(
                [s[g.lo:g.hi] for s in legs[c]], axis=1).ravel()
    desc = np.zeros((nchunks, 10), np.int64)
    desc[:, 0] = coff[:-1]
    desc[:, 1] = Ks
    desc[:, 2] = soff[:-1]
    desc[:, 3:9] = np.asarray(meta, np.int64).reshape(nchunks, 6)
    dev = g.device
    return Sweep("halo", R, nchunks, Cloc, with_slack(pc, device=dev),
                 with_slack(pv, device=dev), buf_len,
                 sends=with_slack(ps, device=dev),
                 desc=torch.as_tensor(desc, device=dev), desc_host=desc)


def build_halo_op(mesh: Mesh, T, lower: bool, chunk: int = 256,
                  dtype=None, max_chunks: Optional[int] = None,
                  form: Optional[str] = None) -> Optional[HaloOp]:
    """Build the per-chunk halo schedule for ``(I + strict(T))^{-1}``, its
    chunk loop laid out by :func:`~.trsv_sharded.loop_plan` (``form``).

    Returns ``None`` when the factor is empty, the mesh has one rank, or the
    schedule has more than ``max_chunks`` chunks (the caller then takes the
    all_gather op, as in the JAX package)."""
    D = mesh.D
    C = max(chunk, D)
    C -= C % D
    sched = build_trsv_schedule(T, lower=lower, chunk=C, dtype=dtype,
                                device="cpu")
    nchunks = sched.nchunks
    if nchunks == 0 or D == 1:
        return None
    if max_chunks is not None and nchunks > max_chunks:
        return None
    Cloc = C // D
    nslots = nchunks * C
    n = sched.n
    own_len = nchunks * Cloc
    cols = sched.cols.numpy()
    vals = sched.vals.numpy()
    K = cols.shape[2]
    (meta, send_plans, loc, halo_off, comm, owner, own_coord, dep,
     pad) = _plan(D, C, cols, nchunks)
    buf_len = halo_off + 1
    LPAD = buf_len - 1
    loc[loc < 0] = LPAD
    dvals = vals.reshape(nchunks, D, Cloc, K).transpose(1, 0, 2, 3)

    lcs, lvs, Ks = [], [], []
    for c in range(nchunks):
        # trim to the chunk's real fan-in
        Kc = max(int((~pad[:, c]).sum(axis=2).max()), 1)
        dk = np.where(pad[:, c, :, :Kc], nslots, dep[:, c, :, :Kc])
        lcs.append(np.take_along_axis(loc, dk.reshape(D, -1), axis=1)
                   .reshape(D, Cloc, Kc).astype(np.int32))
        lvs.append(dvals[:, c, :, :Kc])
        Ks.append(Kc)
    legs = [[np.where(s < 0, LPAD, s) for s in send_plans[c]]
            for c in range(nchunks)]
    packed = [_pack(g, lcs, lvs, Ks, legs, meta, Cloc, buf_len)
              for g in mesh.groups()]
    views = [[p.halo_chunk(c) for p in packed] for c in range(nchunks)]
    gcols = tuple([v[0] for v in vc] for vc in views)
    gvals = tuple([v[1] for v in vc] for vc in views)
    sends = []
    for c, vc in enumerate(views):
        cuts = np.cumsum([0] + [W for W in meta[c][1::2] if W]).tolist()
        sends.append(tuple([v[2][:, a:e] for v in vc]
                           for a, e in zip(cuts[:-1], cuts[1:])))

    in_rows = sched.in_rows.numpy().reshape(nchunks, D, Cloc) \
        .transpose(1, 0, 2).reshape(D, own_len)
    out_slots = sched.out_slots.numpy().astype(np.int64)
    exit_pos = owner[out_slots] * own_len + own_coord[out_slots]
    return HaloOp(
        mesh=mesh, in_rows=mesh.put(in_rows.astype(np.int64)),
        out_slots=out_slots,
        exit_pos=[torch.as_tensor(exit_pos, device=g.device)
                  for g in mesh.groups()],
        packed=packed, gcols=gcols, gvals=gvals, sends=tuple(sends),
        meta=tuple(meta), nchunks=nchunks, Cloc=Cloc, own_len=own_len,
        buf_len=buf_len, D=D, n=n, comm_elems=comm,
        allgather_elems=nchunks * D * (C - Cloc),
        plan=loop_plan(mesh, packed, form))


def halo_op_kernel(op: HaloOp, bs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Solve (I + strict(T)) x = b on the ranks: ``bs`` replicated (per
    group (ranks, n)); the working vector distributed (own slices + halo);
    the result replicated (one exit all_gather)."""
    mesh = op.mesh
    xs = []
    for b, ir in zip(bs, op.in_rows):
        x = b.new_zeros((b.shape[0], op.buf_len))   # the halo starts zero
        ext = torch.cat([b, b.new_zeros((b.shape[0], 1))], 1)
        x[:, :op.own_len] = ext.gather(1, ir)
        xs.append(x)
    form = op.plan.form
    if form == "sweep":
        chunk_sweep(xs[0], op.packed[0])
    elif form == "peer":
        chunk_sweep_peer(xs, op.plan)
    else:
        halo_chunk_loop(op, xs)
    full = mesh.all_gather([x[:, :op.own_len] for x in xs])
    return [f.index_select(1, e) for f, e in zip(full, op.exit_pos)]


def halo_chunk_loop(op: HaloOp, xs: List[torch.Tensor]) -> None:
    """The chunk loop a chunk at a time, in place on the distributed
    working vectors ``xs``: each chunk's K10a step for every group, then its
    legs through the mesh's collectives."""
    mesh, D, Cloc = op.mesh, op.D, op.Cloc
    sweeps = [ChunkSweep(x) for x in xs]
    off = 0
    for c in range(op.nchunks):
        for sweep, cc, vv in zip(sweeps, op.gcols[c], op.gvals[c]):
            sweep(cc, vv, off)
        off_l, Wl, off_r, Wr, off_ag, Wag = op.meta[c]
        legs = iter(op.sends[c])
        if Wl:
            pkg = [x.gather(1, s) for x, s in zip(xs, next(legs))]
            mesh.shift(pkg, 1, out=[x[:, off_l:off_l + Wl] for x in xs])
        if Wr:
            pkg = [x.gather(1, s) for x, s in zip(xs, next(legs))]
            mesh.shift(pkg, -1, out=[x[:, off_r:off_r + Wr] for x in xs])
        if Wag:
            pkg = [x.gather(1, s) for x, s in zip(xs, next(legs))]
            mesh.all_gather(pkg, out=[x[:, off_ag:off_ag + D * Wag]
                                      for x in xs])
        off += Cloc


def _halo_apply(op: HaloOp, b: torch.Tensor) -> torch.Tensor:
    return halo_op_kernel(op, op.mesh.replicate(b))[0][0]


def halo_trsv_apply(op: HaloOp, b) -> torch.Tensor:
    """Apply one halo-trsv operator on its ranks; ``b`` replicated in (every
    rank a copy), rank 0's copy of x returned.  One program of the mesh's
    graph cache for each shape and dtype of b (the JAX package jits it):
    the entry gather, the chunk loop in its form and the exit all_gather,
    replayed."""
    b = torch.as_tensor(b, dtype=op.gvals[0][0].dtype, device=op.mesh.device)
    return jit(op.mesh, _halo_apply)(op, b)
