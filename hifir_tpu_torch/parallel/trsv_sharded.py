"""Distributed level-scheduled triangular solve (tiled all_gather form).

The port of ``hifir_tpu/parallel/trsv_sharded.py``.  Rows within a
dependency level are independent, so every chunk of the level schedule is
split over the ``rows`` ranks: rank k computes slots ``[c*C + k*Cloc,
c*C + (k+1)*Cloc)`` of chunk c from its shard of the factor (kernel K10a,
the ranks of a device in one launch), then a tiled all_gather reassembles
the chunk on every rank before the next chunk.  The solution stays
replicated (every rank a copy); the factor is the sharded operand.

A rank's shard of the factor is its ``Cloc`` rows of every chunk; the
shards of a device's ranks are kept chunk-major, ``(nchunks, ranks, Cloc,
K)``, so that one chunk of all of them is one contiguous block.

The chunk loop (:func:`ag_sweep`) follows the factor's
:class:`~hifir_tpu_torch.ops.chunk.SweepPlan`, laid out once when the
factor is built (:func:`ag_plan`, through :func:`loop_plan`, the one place
that reads the mesh's layout):

- ``"sweep"``, one group (every ``rows`` rank on one device, as
  ``make_mesh`` puts them on the card): the whole loop is one call of
  :func:`~hifir_tpu_torch.ops.chunk.chunk_sweep`, on the card one launch of
  the redesigned K10a with the all_gather inside it, on the CPU its plain
  version;
- ``"peer"``, several groups whose devices reach each other's memory
  (several cards with peer access, several groups of one card, the CPU):
  :func:`~hifir_tpu_torch.ops.chunk.chunk_sweep_peer`, on the cards one
  launch a card, each step storing its slots into every rank's copy
  through peer pointers;
- ``"chunk"``, where some pair of cards cannot reach each other, or when
  asked for: :func:`ag_chunk_loop`, a K10a launch a chunk for each group,
  then the tiled all_gather as the mesh's copies.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..graphs import jit
from ..ops.chunk import (PEER_MAX_GROUPS, ChunkSweep, Sweep, SweepPlan,
                         chunk_sweep, chunk_sweep_peer, with_slack)
from ..ops.trsv import build_trsv_schedule
from .mesh import Mesh

__all__ = ["ShardedTrsv", "shard_trsv_schedule", "sharded_trsv_apply",
           "shard_chunks", "ag_sweep", "ag_chunk_loop", "ag_plan",
           "loop_plan"]


def shard_chunks(mesh: Mesh, a: np.ndarray, dtype=None) -> List[torch.Tensor]:
    """A schedule array (nchunks, C, K) split into the ranks' Cloc-row
    shards of every chunk, per group chunk-major (nchunks, ranks, Cloc, K),
    with the slack a sweep operand keeps after it."""
    nchunks, C, K = a.shape
    D = mesh.D
    v = a.reshape(nchunks, D, C // D, K)
    return [with_slack(v[:, g.lo:g.hi], dtype, g.device)
            for g in mesh.groups()]


def loop_plan(mesh: Mesh, sweeps: List[Sweep],
              form: Optional[str] = None) -> SweepPlan:
    """The layout of a factor's chunk loop over ``mesh`` (``sweeps`` each
    group's share of the operands), decided from the topology before any
    launch: ``"sweep"`` for one group; ``"chunk"`` when ``form="chunk"``
    asks for it, when some pair of groups cannot reach each other's memory
    (:meth:`Mesh.peer_access`) or when the groups outnumber the peer
    sweep's table; else ``"peer"``."""
    if form not in (None, "chunk"):
        raise ValueError(f"form {form!r}: None (by the layout) or 'chunk'")
    groups = mesh.groups()
    lo = tuple(g.lo for g in groups) + (mesh.D,)
    if form == "chunk":
        kind = "chunk"
    elif len(groups) == 1:
        kind = "sweep"
    elif len(groups) > PEER_MAX_GROUPS or not mesh.peer_access().all():
        kind = "chunk"
    else:
        kind = "peer"
    return SweepPlan(kind, list(sweeps), lo)


def ag_plan(mesh: Mesh, cols, vals, chunk: int,
            form: Optional[str] = None) -> SweepPlan:
    """The plan of a factor's shards (per group (nchunks, ranks, Cloc, K)
    cols and vals): :func:`loop_plan` over each group's all_gather
    sweep."""
    return loop_plan(mesh, [Sweep.all_gather(c, v, chunk, mesh.D)
                            for c, v in zip(cols, vals)], form)


def ag_sweep(op, xs: List[torch.Tensor]) -> None:
    """The chunk loop of ``op`` (an ``AGTrsvOp`` or :class:`ShardedTrsv`)
    on replicated slot vectors ``xs`` (per group (ranks, nslots + 1), the
    last slot zero), in place, as its plan's form says."""
    plan = op.plan
    if plan.form == "sweep":
        chunk_sweep(xs[0], plan.sweeps[0])
    elif plan.form == "peer":
        chunk_sweep_peer(xs, plan)
    else:
        ag_chunk_loop(op.mesh, xs, op.cols, op.vals, op.chunk, op.nchunks)


def ag_chunk_loop(mesh: Mesh, xs: List[torch.Tensor], cols, vals,
                  chunk: int, nchunks: int) -> None:
    """The chunk loop a chunk at a time: each chunk's K10a step on every
    rank's slice, its new values also into the rank's send package, then
    the tiled all_gather of the packages into every rank's copy of the
    chunk."""
    Cloc = chunk // mesh.D
    groups = mesh.groups()
    pkgs = [x.new_empty((g.size, Cloc)) for g, x in zip(groups, xs)]
    sweeps = [ChunkSweep(x, p) for x, p in zip(xs, pkgs)]
    for c in range(nchunks):
        c0 = c * chunk
        for g, sweep, cc, vv in zip(groups, sweeps, cols, vals):
            sweep(cc[c], vv[c], c0 + g.lo * Cloc, Cloc)
        mesh.all_gather(pkgs, out=[x[:, c0:c0 + chunk] for x in xs])


class ShardedTrsv:
    """Rank-sharded chunked schedule."""

    def __init__(self, mesh, in_rows, cols, vals, out_slots, n, nchunks,
                 chunk, nslots, form=None):
        self.mesh = mesh
        self.in_rows = in_rows      # per group (ranks, nslots) int64 copies
        self.cols = cols            # per group (nchunks, ranks, Cloc, K)
        self.vals = vals
        self.out_slots = out_slots  # per group (ranks, n) int64 copies
        self.n = n
        self.nchunks = nchunks
        self.chunk = chunk
        self.nslots = nslots
        self.plan = ag_plan(mesh, cols, vals, chunk, form)


def shard_trsv_schedule(mesh: Mesh, T, lower: bool, chunk: int = 256,
                        form: Optional[str] = None) -> ShardedTrsv:
    """Build a schedule whose chunks are divisible by the ``rows`` axis and
    place the factor shards on the ranks (``form``: :func:`loop_plan`)."""
    D = mesh.D
    C = max(chunk, D)
    C -= C % D
    s = build_trsv_schedule(T, lower=lower, chunk=C, k_cap="auto",
                            device="cpu")
    rep = lambda a: mesh.replicate(a.long())  # noqa: E731
    return ShardedTrsv(mesh, rep(s.in_rows),
                       shard_chunks(mesh, s.cols.numpy()),
                       shard_chunks(mesh, s.vals.numpy()),
                       rep(s.out_slots), s.n, s.nchunks, C,
                       int(s.in_rows.shape[0]), form)


def sharded_trsv_apply(st: ShardedTrsv, b) -> torch.Tensor:
    """Solve (I + strict(T)) x = b across the ranks; b replicated in (every
    rank a copy), x replicated out (rank 0's copy returned).  One program
    of the mesh's graph cache for each shape and dtype of b (the JAX
    package jits it), replayed."""
    b = torch.as_tensor(b, dtype=st.vals[0].dtype, device=st.mesh.device)
    if st.nchunks == 0:
        return b
    return jit(st.mesh, _sharded_apply)(st, b)


def _sharded_apply(st: ShardedTrsv, b: torch.Tensor) -> torch.Tensor:
    mesh = st.mesh
    xs = []
    for bg, ir in zip(mesh.replicate(b), st.in_rows):
        x = bg.new_zeros((bg.shape[0], st.nslots + 1))
        ext = torch.cat([bg, bg.new_zeros((bg.shape[0], 1))], 1)
        x[:, :st.nslots] = ext.gather(1, ir)
        xs.append(x)
    ag_sweep(st, xs)
    out = [x.gather(1, o) for x, o in zip(xs, st.out_slots)]
    return out[0][0]
