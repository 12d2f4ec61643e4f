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
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.chunk import ChunkSweep
from ..ops.trsv import build_trsv_schedule
from .mesh import Mesh

__all__ = ["ShardedTrsv", "shard_trsv_schedule", "sharded_trsv_apply",
           "shard_chunks", "ag_sweep"]


def shard_chunks(mesh: Mesh, a: np.ndarray, dtype=None) -> List[torch.Tensor]:
    """A schedule array (nchunks, C, K) split into the ranks' Cloc-row
    shards of every chunk, per group chunk-major (nchunks, ranks, Cloc, K)."""
    nchunks, C, K = a.shape
    D = mesh.D
    v = a.reshape(nchunks, D, C // D, K)
    return [torch.as_tensor(np.ascontiguousarray(v[:, g.lo:g.hi]),
                            dtype=dtype, device=g.device)
            for g in mesh.groups()]


def ag_sweep(mesh: Mesh, xs: List[torch.Tensor], cols, vals, chunk: int,
             nchunks: int) -> None:
    """The chunk loop on replicated slot vectors ``xs`` (per group
    (ranks, nslots + 1), the last slot zero), in place: each chunk's K10a
    step on every rank's slice, its new values also into the rank's send
    package, then the tiled all_gather of the packages into every rank's
    copy of the chunk."""
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
                 chunk, nslots):
        self.mesh = mesh
        self.in_rows = in_rows      # per group (ranks, nslots) int64 copies
        self.cols = cols            # per group (nchunks, ranks, Cloc, K)
        self.vals = vals
        self.out_slots = out_slots  # per group (ranks, n) int64 copies
        self.n = n
        self.nchunks = nchunks
        self.chunk = chunk
        self.nslots = nslots


def shard_trsv_schedule(mesh: Mesh, T, lower: bool, chunk: int = 256
                        ) -> ShardedTrsv:
    """Build a schedule whose chunks are divisible by the ``rows`` axis and
    place the factor shards on the ranks."""
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
                       int(s.in_rows.shape[0]))


def sharded_trsv_apply(st: ShardedTrsv, b) -> torch.Tensor:
    """Solve (I + strict(T)) x = b across the ranks; b replicated in (every
    rank a copy), x replicated out (rank 0's copy returned)."""
    mesh = st.mesh
    b = torch.as_tensor(b, dtype=st.vals[0].dtype)
    if st.nchunks == 0:
        return b
    xs = []
    for bg, ir in zip(mesh.replicate(b), st.in_rows):
        x = bg.new_zeros((bg.shape[0], st.nslots + 1))
        ext = torch.cat([bg, bg.new_zeros((bg.shape[0], 1))], 1)
        x[:, :st.nslots] = ext.gather(1, ir)
        xs.append(x)
    ag_sweep(mesh, xs, st.cols, st.vals, st.chunk, st.nchunks)
    out = [x.gather(1, o) for x, o in zip(xs, st.out_slots)]
    return out[0][0]
