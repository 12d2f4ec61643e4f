"""Triangular solves with a unit-diagonal factor, in three forms.

The port of ``hifir_tpu/ops/trsv.py``.  The builders are copied from the
reference with its constants (``_STEP_ELEMS``, the 0.7 margin), so the
layouts equal the reference's arrays:

- :class:`TrsvSchedule`: the level schedule in slot order.  Besides the
  reference's arrays it keeps ``level_slots``, the slot range of every
  effective level, which the JAX pytree drops, and each level's K and
  first entry, on the host and on the device: kernel K2
  (``csrc/kernels.cu:trsv_solve``) walks those ranges, from B to X with
  the entry and exit gathers, in one launch per solve.  Two builders lay
  it out: :func:`build_trsv_schedule`, the reference's chunked schedule,
  and :func:`build_trsv_schedule_card`, the card's (a K and a split a
  level, no chunk), which CUDA packs take by default.
- :class:`TrsvDense`: an explicit dense inverse, applied by ``torch.matmul``.
- :class:`TrsvBlockDense`: W-row blocks, each an off-diagonal sliced-ELL
  product (kernel K1) and a dense ``torch.matmul`` with the block's inverse.

Every form packs real or complex factors (``dtype=None`` keeps the factor's
own); the explicit inverses are computed in float64 or complex128 and cast.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..kernels.build import check, kernel_fn

__all__ = ["TrsvSchedule", "TrsvDense", "TrsvBlockDense",
           "build_trsv_schedule", "build_trsv_schedule_card",
           "build_trsv_dense",
           "build_trsv_block_dense", "trsv_apply_mrhs", "trsv_apply_plain",
           "trsv_shape", "trsv_team", "trsv_tile", "tile_shape"]


@dataclasses.dataclass
class TrsvSchedule:
    """Level schedule of a unit-diagonal triangular factor, in slot order.

    Effective level l is slots ``[level_slots[l], level_slots[l + 1])``;
    each of its slots has ``level_K[l]`` (col, val) entries, from entry
    ``level_off[l]`` of ``cols`` and ``vals`` on.  Two layouts:

    - uniform (:func:`build_trsv_schedule`, the reference's arrays): every
      level padded to a chunk of slots, every slot to the factor-wide K;
      ``cols`` and ``vals`` are (nchunks, chunk, K), ``level_K`` is K and
      ``level_off`` is ``level_slots * K`` (filled in here);
    - ragged (:func:`build_trsv_schedule_card`): each level takes its own
      slots (``chunk`` 1) and its own K; ``cols`` and ``vals`` are flat.
    """

    in_rows: torch.Tensor     # (nslots,) int32: row feeding a slot (pad: n)
    cols: torch.Tensor        # dep slots, int32 (pad: nslots)
    vals: torch.Tensor
    out_slots: torch.Tensor   # (n,) int32: slot holding each row's solution
    n: int
    nchunks: int
    chunk: int
    nlevels: int
    level_slots: np.ndarray   # (nlevels + 1,) int64 host: level l is slots
    #                           [level_slots[l], level_slots[l + 1])
    level_slots_dev: torch.Tensor   # the same, int64, on the device
    level_K: np.ndarray = None      # (nlevels,) int32 host: entries a slot
    level_off: np.ndarray = None    # (nlevels + 1,) int64 host: first entry
    level_K_dev: torch.Tensor = None     # the same two on the device
    level_off_dev: torch.Tensor = None

    def __post_init__(self):
        if self.level_K is None:          # the uniform layout
            K = int(self.cols.shape[-1])
            self.level_K = np.full(self.nlevels, K, dtype=np.int32)
            self.level_off = self.level_slots * K
            dev = self.level_slots_dev.device
            self.level_K_dev = torch.from_numpy(self.level_K).to(dev)
            self.level_off_dev = torch.from_numpy(self.level_off).to(dev)

    @property
    def nslots(self) -> int:
        return self.nchunks * self.chunk

    @property
    def K(self) -> int:
        """The widest level's entries a slot."""
        return int(self.level_K.max()) if self.nlevels else 0

    @functools.cached_property
    def level_passes(self) -> np.ndarray:
        """K2's passes of its block over each level: ``ceil(slots / (1024
        / tps))``, tps the level's team (:func:`trsv_team`)."""
        per = TRSV_THREADS // _teams(self.level_K)
        return -(-np.diff(self.level_slots) // per)


@dataclasses.dataclass
class TrsvDense:
    """Explicit dense inverse of a unit-diagonal triangular factor (safe for
    HIF factors: the inverse-based condition control bounds its norm)."""

    inv: torch.Tensor   # (n, n)
    n: int


@dataclasses.dataclass
class TrsvBlockDense:
    """Blocked explicit-inverse triangular apply for mid-size factors."""

    invs: Tuple[torch.Tensor, ...]   # per block (W, W) inverse (padded)
    offs: tuple                      # per block SlicedELL (W x n_pad)
    starts: Tuple[int, ...]          # row start of each block, process order
    n: int                           # true size
    W: int                           # block width (last block padded)


def build_trsv_block_dense(T, lower: bool, W: int = 2048, dtype=None,
                           device="cuda") -> TrsvBlockDense:
    """Build the blocked explicit-inverse apply for ``(I + strict(T))``."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    from ..ds.csr import CSR
    from .spmv import sliced_ell_from_csr

    dev = resolve_device(device)
    n = T.nrows
    zdt = np.dtype(T.data.dtype if dtype is None else dtype)
    S = T.to_scipy().tocsr()
    S = (sp.tril(S, -1) if lower else sp.triu(S, 1)).tocsr()
    nblk = max(1, -(-n // W))
    npad = nblk * W
    order = range(nblk) if lower else range(nblk - 1, -1, -1)
    invs, offs, starts = [], [], []
    eyeW = np.eye(W)
    for b in order:
        lo, hi = b * W, min((b + 1) * W, n)
        w = hi - lo
        blk = S[lo:hi, lo:hi].toarray()
        Mb = np.eye(w) + (np.tril(blk, -1) if lower else np.triu(blk, 1))
        inv = sla.solve_triangular(Mb, np.eye(w, dtype=Mb.dtype),
                                   lower=lower, unit_diagonal=True)
        if w < W:  # pad to W with identity (padded x entries stay zero)
            invp = eyeW.astype(inv.dtype).copy()
            invp[:w, :w] = inv
            inv = invp
        # off-diagonal part: cols outside the block, already computed when
        # this block runs (prefix for lower, suffix for upper)
        off = (S[lo:hi, :lo] if lower else S[lo:hi, hi:]).tocsr()
        offp = sp.csr_matrix((off.data, off.indices + (0 if lower else hi),
                              np.concatenate([off.indptr,
                                              [off.indptr[-1]] * (W - w)])),
                             shape=(W, npad))
        offs.append(sliced_ell_from_csr(CSR.from_scipy(offp), dtype=zdt,
                                        device=dev))
        invs.append(torch.from_numpy(inv.astype(zdt)).to(dev))
        starts.append(lo)
    return TrsvBlockDense(tuple(invs), tuple(offs), tuple(starts), n, W)


def _block_dense_apply(bd: TrsvBlockDense, B: torch.Tensor) -> torch.Tensor:
    """X = (I + strict T)^{-1} B block by block: S = B_b - Off_b X (K1, its
    epilogue fused), then X_b = Inv_b S (``torch.matmul``).

    X is written block by block into one buffer of the padded height, which
    Off_b's columns index; they lie outside the block's own rows, so K1
    never writes a row it reads.  Only the w real rows of a block enter the
    product (the padded inverse is the identity past them), so B is never
    padded: a block whose Off_b is empty multiplies B's rows directly, and
    the last block, when it is short and not empty, copies its rows into
    the scratch S first.  Every branch is on the pack's shapes, so the
    whole apply can be captured (:mod:`..graphs`)."""
    from .spmv import sliced_ell_sub_mrhs

    n, W = bd.n, bd.W
    B = B.contiguous()
    x = B.new_empty((W * len(bd.starts), B.shape[1]))
    S = B.new_empty((W, B.shape[1]))
    for inv, off, lo in zip(bd.invs, bd.offs, bd.starts):
        w = min(W, n - lo)
        if off.nnz == 0:
            seg = B[lo:lo + w]
        elif w == W:
            seg = sliced_ell_sub_mrhs(off, x, B[lo:lo + W], out=S)
        else:
            S[:w] = B[lo:n]
            seg = sliced_ell_sub_mrhs(off, x, S, out=S)[:w]
        torch.matmul(inv[:w, :w], seg, out=x[lo:lo + w])
    return x[:n]


def build_trsv_dense(T, lower: bool, dtype=None, device="cuda") -> TrsvDense:
    """Materialize (I + strict(T))^{-1} on host (n^3/3 flops: gate callers
    on n)."""
    import scipy.linalg as sla

    dev = resolve_device(device)
    n = T.nrows
    zdt = np.dtype(T.data.dtype if dtype is None else dtype)
    if n == 0:
        return TrsvDense(torch.zeros((0, 0), dtype=torch_dtype(zdt),
                                     device=dev), 0)
    M = T.to_scipy().toarray().astype(
        np.complex128 if np.iscomplexobj(T.data) else np.float64)
    M = (np.tril(M, -1) if lower else np.triu(M, 1)) + np.eye(n)
    inv = sla.solve_triangular(M, np.eye(n, dtype=M.dtype), lower=lower,
                               unit_diagonal=True)
    return TrsvDense(torch.from_numpy(inv.astype(zdt)).to(dev), n)


def _compute_levels(n, indptr, indices, lower: bool) -> np.ndarray:
    """Dependency level of every row: 0 without strict dependencies, else one
    more than the deepest row it depends on.

    Kahn's algorithm, one vectorized wavefront per level: a row is released
    in the sweep after its last dependency, which is exactly
    ``1 + max(level of its dependencies)``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = (indices < rows) if lower else (indices > rows)
    dep_row, dep_col = rows[keep], indices[keep]
    # dependents of each row, grouped by the row they depend on
    by_col = np.argsort(dep_col, kind="stable")
    dependents = dep_row[by_col]
    dptr = _cumsum0(np.bincount(dep_col, minlength=n))
    pending = np.bincount(dep_row, minlength=n)
    lev = np.zeros(n, dtype=np.int64)
    front = np.flatnonzero(pending == 0)
    level = 0
    while front.size:
        lev[front] = level
        starts = dptr[front]
        nxt = dependents[_segment_gather(starts, dptr[front + 1] - starts)]
        rows_u, hits = np.unique(nxt, return_counts=True)
        pending[rows_u] -= hits
        front = rows_u[pending[rows_u] == 0]
        level += 1
    return lev


def _segment_gather(starts, lens):
    """Flat positions of the segments [starts_i, starts_i + lens_i)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    seg_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.repeat(starts, lens)
            + np.arange(total, dtype=np.int64) - np.repeat(seg_off, lens))


def _cumsum0(a):
    return np.concatenate([[0], np.cumsum(a)])


# The reference builder's cost model, with the reference's TPU-tuned
# constants: its layouts must equal the JAX package's arrays (the CPU pack,
# an explicit chunk or cap, and the distributed layouts of parallel/*,
# which the tests hold to the reference); the card schedule has its own.
_STEP_ELEMS = 2500  # ~60us scan-step latency floor / ~24ns-per-elem gather


def _packed_slot_count(dcount, lev, chunk, cap):
    """Total padded slots of the schedule if rows wider than ``cap`` split."""
    L = int(lev.max()) + 1 if lev.size else 1
    d = dcount.astype(np.int64)
    stage_counts = [np.bincount(lev[d <= cap], minlength=L).astype(np.int64)]
    wl, wd = lev[d > cap], d[d > cap]
    s = 0
    while wl.size:
        if len(stage_counts) <= s + 1:
            stage_counts.append(np.zeros(L, np.int64))
        g = -(-wd // cap)
        stage_counts[s] += np.bincount(
            wl, weights=g, minlength=L).astype(np.int64)
        done = g <= cap
        stage_counts[s + 1] += np.bincount(wl[done], minlength=L)
        wl, wd = wl[~done], g[~done]
        s += 1
    total = 0
    for arr in stage_counts:
        nz = arr[arr > 0]
        total += int((-(-nz // chunk) * chunk).sum())
    return total


def _schedule_cost(slots, K, chunk):
    """Memory + step cost of a (slots, K) schedule, in element units."""
    nchunks = slots // chunk
    return slots * K + nchunks * max(_STEP_ELEMS, chunk * K)


def _choose_k_cap(dcount, lev, chunk):
    """Deps-per-slot cap minimizing the schedule cost model (None: unsplit)."""
    cap, _ = _best_cap_and_cost(dcount, lev, chunk)
    return cap


def _best_cap_and_cost(dcount, lev, chunk):
    kmax = int(dcount.max()) if dcount.size else 0
    if kmax <= 4:
        K = max(kmax, 1)
        return None, _schedule_cost(
            _packed_slot_count(dcount, lev, chunk, max(K, 1)), K, chunk)
    base = _schedule_cost(_packed_slot_count(dcount, lev, chunk, kmax),
                          kmax, chunk)
    caps = []
    cap = 4
    while cap < kmax:
        caps.append(cap)
        cap *= 2
    best_cap, best_cost = None, base
    for cap in reversed(caps):  # descending: ties keep the larger cap
        cost = _schedule_cost(_packed_slot_count(dcount, lev, chunk, cap),
                              cap, chunk)
        if cost < best_cost:
            best_cap, best_cost = cap, cost
    if best_cap is not None and best_cost > 0.7 * base:
        return None, base
    return best_cap, best_cost


def _choose_chunk(dcount, lev, multiple: int, upper: int):
    """Joint (chunk, k_cap) choice minimizing the schedule cost model over
    the power-of-two multiples of ``multiple`` (the mesh's rank count for a
    distributed schedule) from 8 up to ``upper``."""
    c = multiple
    while c < 8:
        c *= 2
    best = (c, None, float("inf"))
    while c <= max(upper, multiple):
        cap, cost = _best_cap_and_cost(dcount, lev, c)
        if cost < best[2]:
            best = (c, cap, cost)
        c *= 2
    return best[0], best[1]


def _dependencies(T, lower: bool, zdt):
    """The strict triangle's dependencies, row by row: ``(dcount, dstart,
    pool_ids, pool_vals)``, row r's in ``pool_*[dstart[r]:dstart[r + 1]]``."""
    n = T.nrows
    indptr, indices, data = T.indptr, T.indices, T.data
    rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = (indices < rows_of) if lower else (indices > rows_of)
    dep_rows = rows_of[keep]
    pool_ids = indices[keep].astype(np.int64)
    pool_vals = data[keep].astype(zdt, copy=False)
    dcount = np.bincount(dep_rows, minlength=n)
    return dcount, _cumsum0(dcount), pool_ids, pool_vals


def _split_rows(n, dcount, dstart, pool_ids, pool_vals, cap, zdt):
    """The node table: rows first, then the partial-sum nodes of the rows
    wider than ``cap`` (a scalar, or one cap a row; None: no split).

    A row wider than its cap splits into ceil(len / cap) partial nodes over
    contiguous slices of its dependencies, one stage earlier; the row itself
    becomes the node that combines them (val -1), again split while wider
    than the cap.  Returns ``(pool_ids, pool_vals, node_start, node_len,
    node_row, node_init, node_stage)``: node i applies pool entries
    ``[node_start[i], node_start[i] + node_len[i])``, belongs to row
    ``node_row[i]``, starts from B's row ``node_init[i]`` (n: from 0) and
    runs in sub-stage ``node_stage[i]`` of its row's level."""
    node_start = dstart[:-1].copy()
    node_len = dcount.astype(np.int64).copy()
    node_row = np.arange(n, dtype=np.int64)      # owner row (init b[row])
    node_init = np.arange(n, dtype=np.int64)     # in_rows value (n = init 0)
    node_stage = np.zeros(n, dtype=np.int64)
    if cap is None or not np.any(node_len > cap):
        return (pool_ids, pool_vals, node_start, node_len, node_row,
                node_init, node_stage)
    cap = np.broadcast_to(np.asarray(cap, dtype=np.int64), (n,))
    pool_parts = [pool_ids]
    val_parts = [pool_vals]
    pool_off = pool_ids.size
    starts = [node_start]
    lens = [node_len]
    rows = [node_row]
    inits = [node_init]
    stages = [node_stage]
    nnodes = n
    # wide nodes this layer: split each into ceil(len/cap) partial nodes
    # over contiguous slices of its current dep list; the node itself is
    # rewritten to combine the partials (val -1) one stage later
    wide = np.flatnonzero(node_len > cap)
    w_start, w_len = node_start[wide], node_len[wide]
    w_row, w_cap = node_row[wide], cap[wide]
    layer = 0
    while wide.size:
        g = -(-w_len // w_cap)
        npart = int(g.sum())
        p_owner = np.repeat(np.arange(wide.size), g)
        p_idx = (np.arange(npart, dtype=np.int64)
                 - np.repeat(_cumsum0(g)[:-1], g))
        p_cap = w_cap[p_owner]
        starts.append(w_start[p_owner] + p_idx * p_cap)
        lens.append(np.minimum(p_cap, w_len[p_owner] - p_idx * p_cap))
        rows.append(w_row[p_owner])
        inits.append(np.full(npart, n, dtype=np.int64))   # init 0
        stages.append(np.full(npart, layer, dtype=np.int64))
        p_node = nnodes + np.arange(npart, dtype=np.int64)
        nnodes += npart
        pool_parts.append(p_node)
        val_parts.append(np.full(npart, -1, dtype=zdt))
        node_start_new = pool_off + _cumsum0(g)[:-1]
        pool_off += npart
        if layer == 0:
            node_start[wide] = node_start_new
            node_len[wide] = g
            node_stage[wide] = 1
            combine_ids = wide
        else:
            starts[0][combine_ids] = node_start_new
            lens[0][combine_ids] = g
            stages[0][combine_ids] = layer + 1
        deep = g > w_cap
        combine_ids = combine_ids[deep]
        w_start = node_start_new[deep]
        w_len = g[deep]
        w_cap = w_cap[deep]
        w_row = w_row[deep] if layer == 0 else rows[0][combine_ids]
        wide = combine_ids
        layer += 1
    return (np.concatenate(pool_parts), np.concatenate(val_parts),
            np.concatenate(starts), np.concatenate(lens),
            np.concatenate(rows), np.concatenate(inits),
            np.concatenate(stages))


def _effective_levels(lev, node_row, node_stage):
    """``(nlev, nlev_map)``: each node's effective level, its row's level
    and then its sub-stage, compacted to the levels that hold a node."""
    max_stage = int(node_stage.max()) + 1 if node_row.size else 1
    key = lev[node_row] * max_stage + node_stage
    eff = np.unique(key)
    return eff.size, np.searchsorted(eff, key)


def build_trsv_schedule(T, lower: bool, chunk: int = 256, dtype=None,
                        k_cap=None, device="cuda",
                        chunk_multiple: int = 1) -> TrsvSchedule:
    """Build the device schedule for ``(I + strict(T))^{-1}``.

    ``T`` is a host CSR whose strict lower (or upper) triangle is the factor.
    ``k_cap`` splits rows with more than ``k_cap`` dependencies into
    partial-sum slots in earlier sub-stages of the same level (``"auto"``:
    the cost model's choice; ``None``: unsplit).  ``chunk="auto"`` picks the
    chunk jointly with the cap, a multiple of ``chunk_multiple``.
    """
    dev = resolve_device(device)
    n = T.nrows
    indptr, indices, data = T.indptr, T.indices, T.data
    zdt = np.dtype(data.dtype if dtype is None else dtype)
    if n == 0:
        c0 = 256 if chunk == "auto" else chunk
        i32 = dict(dtype=torch.int32, device=dev)
        return TrsvSchedule(torch.zeros((0,), **i32),
                            torch.zeros((0, c0, 1), **i32),
                            torch.zeros((0, c0, 1), dtype=torch_dtype(zdt),
                                        device=dev),
                            torch.zeros((0,), **i32), 0, 0, c0, 0,
                            np.zeros(1, np.int64),
                            torch.zeros(1, dtype=torch.int64, device=dev))

    dcount, dstart, pool_ids, pool_vals = _dependencies(T, lower, zdt)
    lev = _compute_levels(n, indptr, indices, lower)

    if chunk == "auto":
        chunk, auto_cap = _choose_chunk(dcount, lev, max(chunk_multiple, 1),
                                        upper=1024)
        if k_cap == "auto":
            k_cap = auto_cap
    elif k_cap == "auto":
        k_cap = _choose_k_cap(dcount, lev, chunk)

    (pool_ids, pool_vals, node_start, node_len, node_row, node_init,
     node_stage) = _split_rows(n, dcount, dstart, pool_ids, pool_vals,
                               k_cap, zdt)

    nnodes = node_row.size
    nlev, nlev_map = _effective_levels(lev, node_row, node_stage)

    # nodes sorted by effective level; pad each level to a chunk boundary
    node_order = np.argsort(nlev_map, kind="stable")
    lev_sizes = np.bincount(nlev_map, minlength=nlev)
    padded_sizes = -(-lev_sizes // chunk) * chunk
    total_slots = int(padded_sizes.sum())
    all_init = np.full(total_slots, n, dtype=np.int64)
    level_slots = _cumsum0(padded_sizes).astype(np.int64)
    out_start = level_slots[:-1]
    pos_in_level = (np.arange(nnodes, dtype=np.int64)
                    - _cumsum0(lev_sizes)[:-1][nlev_map[node_order]])
    slot_of = np.empty(nnodes, dtype=np.int64)
    slots = out_start[nlev_map[node_order]] + pos_in_level
    all_init[slots] = node_init[node_order]
    slot_of[node_order] = slots

    nchunks = total_slots // chunk
    K = max(int(node_len.max()) if nnodes else 0, 1)
    cols2d = np.full((total_slots, K), total_slots, dtype=np.int32)
    vals2d = np.zeros((total_slots, K), dtype=zdt)

    lens_s = node_len[node_order]
    flat = _segment_gather(node_start[node_order], lens_s)
    out_slot = np.repeat(slots, lens_s)
    out_off = (np.arange(flat.size, dtype=np.int64)
               - np.repeat(_cumsum0(lens_s)[:-1], lens_s))
    cols2d[out_slot, out_off] = slot_of[pool_ids[flat]]
    vals2d[out_slot, out_off] = pool_vals[flat]

    out_slots = slot_of[:n]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return TrsvSchedule(t(all_init.astype(np.int32)),
                        t(cols2d.reshape(nchunks, chunk, K)),
                        t(vals2d.reshape(nchunks, chunk, K)),
                        t(out_slots.astype(np.int32)),
                        n, nchunks, chunk, nlev, level_slots, t(level_slots))


# K2's cost of a schedule on the H100, for the card schedule's choice of a
# split cap a level: T_LEVEL a level (its barrier and bookkeeping), T_ROUND
# a round (one pass of the block's teams over a level's slots, one 4-entry
# line a lane), in microseconds, by where x lives (trsv_shape).  The least
# squares fit of K2's column-form time (one intercept a factor and width)
# over the benchmark's 16 factors at their cells' widths, under the card
# schedule and every forced cap, on an H100 80GB HBM3 at 700 W
# (tools/probe_k2_schedule.py; 97 schedules with x global, 19 shared, 2.8%
# and 0.8% median error).  Card schedules built with pairs from (0.5,
# 0.8) to (3.0, 0.8) timed within 3% of each other on every cell's
# factors together: a cap a level, a K a level and no padding matter, the
# pair's exact values little.
T_LEVEL = {"shared": 0.48, "global": 0.51}
T_ROUND = {"shared": 0.41, "global": 0.79}
_UNSPLIT = np.iinfo(np.int64).max


def _teams(K):
    """:func:`trsv_team` of every K in an array."""
    K = np.asarray(K, dtype=np.int64)
    tps = np.ones_like(K)
    for _ in range(5):
        tps = np.where((tps < 32) & (tps * DEPS_PER_LANE < K), 2 * tps, tps)
    return tps


def _rounds(slots, K):
    """K2's rounds over stages of ``slots`` slots of ``K`` entries (arrays):
    its passes (1024 / tps slots a pass) times ``ceil(K / (4 tps))``."""
    slots = np.asarray(slots, dtype=np.int64)
    tps = _teams(K)
    return (-(-slots // (TRSV_THREADS // tps))
            * -(-np.asarray(K, dtype=np.int64) // (DEPS_PER_LANE * tps)))


def _level_caps(dcount, lev, t_level: float, t_round: float) -> np.ndarray:
    """The split cap of each dependency level (``_UNSPLIT``: none) that
    minimises ``stages * t_level + rounds * t_round`` on the card schedule,
    from 4, 8, 16, ... below the level's widest row, or unsplit (ties keep
    the fewer stages, then the larger cap).

    Under cap c a level's rows wider than c split as :func:`_split_rows`
    splits them: stage 0 holds its narrow rows and the first partial sums
    (K = c), stage s the combine nodes of width ceil(d / c^s) and the
    partial sums of those still wider than c (K = min(c, that width))."""
    L = int(lev.max()) + 1
    d = dcount.astype(np.int64)
    rows = np.bincount(lev, minlength=L)
    dmax = np.zeros(L, dtype=np.int64)
    np.maximum.at(dmax, lev, d)
    best = t_level + _rounds(rows, -(-dmax // 4) * 4) * t_round
    caps = np.full(L, _UNSPLIT, dtype=np.int64)
    cands = []
    c = 4
    while c < dmax.max():
        cands.append(c)
        c *= 2
    for c in reversed(cands):
        wide = d > c
        wl, g = lev[wide], -(-d[wide] // c)
        n0 = (rows - np.bincount(wl, minlength=L)
              + np.bincount(wl, weights=g, minlength=L).astype(np.int64))
        cost = t_level + _rounds(n0, np.full(L, c)) * t_round
        w = dmax
        while wl.size:
            w = -(-w // c)             # the stage's widest combine node
            done = g <= c
            ns = (np.bincount(wl[done], minlength=L) + np.bincount(
                wl[~done], weights=-(-g[~done] // c), minlength=L)
                .astype(np.int64))
            Ks = -(-np.minimum(c, w) // 4) * 4
            cost = cost + np.where(ns > 0,
                                   t_level + _rounds(ns, Ks) * t_round, 0)
            wl, g = wl[~done], -(-g[~done] // c)
        better = (dmax > c) & (cost < best)
        best = np.where(better, cost, best)
        caps = np.where(better, c, caps)
    return caps


def build_trsv_schedule_card(T, lower: bool, dtype=None,
                             device="cuda") -> TrsvSchedule:
    """The schedule of ``(I + strict(T))^{-1}`` laid out for K2 on the card
    (the ragged layout of :class:`TrsvSchedule`).

    Each dependency level is split by its own cap (:func:`_level_caps`,
    under the constants of where x will live, judged from the row count)
    into sub-stages as :func:`build_trsv_schedule` splits, and each
    effective level takes its own slots, padded to no chunk, and its own K:
    its widest node rounded up to a multiple of 4, so that every row of
    (col, val) entries is whole 16-byte lines for K2's ring.  Why: on the
    card a level costs a barrier of the block, ~1.5 us, where the TPU's
    scan step cost ~60 us; the reference's one cap and one K a factor
    doubled the levels of narrow factors, or, unsplit, padded every slot to
    the widest row."""
    zdt = np.dtype(T.data.dtype if dtype is None else dtype)
    place = trsv_shape(T.nrows, zdt.itemsize)
    return _card_schedule(T, lower, zdt, resolve_device(device),
                          lambda dcount, lev: _level_caps(
                              dcount, lev, T_LEVEL[place], T_ROUND[place]))


def _card_schedule(T, lower: bool, zdt, dev, level_caps) -> TrsvSchedule:
    """:func:`build_trsv_schedule_card` with the split caps of
    ``level_caps(dcount, lev)``, one a dependency level (``_UNSPLIT``:
    none); a probe forces other caps through it."""
    n = T.nrows

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if n == 0:
        i32 = np.zeros(0, np.int32)
        return TrsvSchedule(t(i32), t(i32), t(np.zeros(0, zdt)), t(i32), 0,
                            0, 1, 0, np.zeros(1, np.int64),
                            t(np.zeros(1, np.int64)))
    dcount, dstart, pool_ids, pool_vals = _dependencies(T, lower, zdt)
    lev = _compute_levels(n, T.indptr, T.indices, lower)
    caps = level_caps(dcount, lev)
    (pool_ids, pool_vals, node_start, node_len, node_row, node_init,
     node_stage) = _split_rows(n, dcount, dstart, pool_ids, pool_vals,
                               caps[lev], zdt)
    nslots = node_row.size
    nlev, nlev_map = _effective_levels(lev, node_row, node_stage)

    # slots in effective-level order, each level's slots unpadded
    order = np.argsort(nlev_map, kind="stable")
    sizes = np.bincount(nlev_map, minlength=nlev)
    level_slots = _cumsum0(sizes).astype(np.int64)
    slot_of = np.empty(nslots, dtype=np.int64)
    slot_of[order] = np.arange(nslots, dtype=np.int64)
    lens = node_len[order]
    level_K = -(-np.maximum.reduceat(lens, level_slots[:-1]) // 4) * 4
    level_off = _cumsum0(sizes * level_K).astype(np.int64)

    # each slot's first entry, then every dependency's
    slot_lev = np.repeat(np.arange(nlev), sizes)
    first = (level_off[:-1][slot_lev] + level_K[slot_lev]
             * (np.arange(nslots) - level_slots[:-1][slot_lev]))
    flat = _segment_gather(node_start[order], lens)
    at = np.repeat(first, lens) + (np.arange(flat.size, dtype=np.int64)
                                   - np.repeat(_cumsum0(lens)[:-1], lens))
    cols = np.full(int(level_off[-1]), nslots, dtype=np.int32)
    vals = np.zeros(int(level_off[-1]), dtype=zdt)
    cols[at] = slot_of[pool_ids[flat]]
    vals[at] = pool_vals[flat]
    level_K = level_K.astype(np.int32)
    return TrsvSchedule(t(node_init[order].astype(np.int32)), t(cols),
                        t(vals), t(slot_of[:n].astype(np.int32)), n, nslots,
                        1, nlev, level_slots, t(level_slots), level_K,
                        level_off, t(level_K), t(level_off))


# ---------------------------------------------------------------------------
# K2 and its plain version

def trsv_apply_plain(sched: TrsvSchedule, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch solve (I + strict(T)) X = B on the schedule: gather B
    into slot order with a zero sentinel slot, then level by level
    x[slots] -= sum_k vals * x[cols], then gather X out of slot order;
    ``trsv_apply_plain.calls`` counts its calls."""
    trsv_apply_plain.calls += 1
    zero = B.new_zeros((1, B.shape[1]))
    x = torch.cat([torch.cat([B, zero])[sched.in_rows], zero])
    cols = sched.cols.reshape(-1)
    vals = sched.vals.reshape(-1)
    for s0, s1, K, e0 in zip(sched.level_slots[:-1].tolist(),
                             sched.level_slots[1:].tolist(),
                             sched.level_K.tolist(),
                             sched.level_off[:-1].tolist()):
        e1 = e0 + (s1 - s0) * K
        g = x[cols[e0:e1].view(s1 - s0, K)]             # (S, K, nrhs)
        x[s0:s1] -= torch.einsum("sk,skj->sj",
                                 vals[e0:e1].view(s1 - s0, K), g)
    return x[sched.out_slots]


trsv_apply_plain.calls = 0


# The shared memory a thread block of K2 may hold its column's slot vector
# in (227 KB on the H100).
SMEM_BYTES = 227 * 1024


def trsv_shape(nslots: int, itemsize: int) -> str:
    """Where K2 keeps a column's slot vector of ``nslots`` + 1 elements of
    ``itemsize`` bytes: "shared" memory while it fits, else "global".  Either
    way the kernel copies the next levels' dependencies ahead into shared
    memory (the ring): into what x leaves, or, with x in global memory,
    into at most 128 KB, so that L1 keeps room for x."""
    return "shared" if (nslots + 1) * itemsize <= SMEM_BYTES else "global"


# K2's block: its threads, and the dependencies a lane gathers a pass
TRSV_THREADS = 1024
DEPS_PER_LANE = 4
# The tile form: a tile's slot of x is at most one 32-byte sector; a launch
# aims at TILE_CTAS blocks (about half the H100's 132 SMs: on the 1M and
# 3-D factors, 64 blocks beat 32 and 128 at 8, 64 and 128 columns), in
# clusters of at most TILE_MAX_CLUSTER (the portable size); a schedule
# takes it where its levels take on the mean at least TILE_MIN_PASSES
# passes of the block (narrower levels lost to the column form: a split
# level pays a cluster barrier for little work).  On an H100 at 700 W,
# over the benchmark's factors at their cells' widths under the reference,
# card and forced-cap schedules (tools/probe_k2_schedule.py, three runs,
# 162 schedules timed in both forms), 1.9 took the faster form in 154 and
# on every card schedule: it lies between Stokes' level-1 U (1.82 passes a
# level, the median level 37 slots: 25% slower in tiles) and p3d64's
# level-0 U (1.99: 12% faster in tiles); the reference's 1.5 (on slots
# over a pass's) missed Stokes' level-1 U
SECTOR_BYTES = 32
TILE_CTAS = 64
TILE_MAX_CLUSTER = 8
TILE_MIN_PASSES = 1.9
# The split: one column's levels over a cluster of SPLIT_CTAS blocks, where
# x is global and the same TILE_MIN_PASSES holds (see trsv_tile).  On an
# H100 at 700 W, one column of every benchmark factor with x global, f32
# and f64 (tools/probe_k2_tile.py --sweep; 16 schedules, each split bit for
# bit equal to the column form), 8 CTAs beat 2 and 4 on each of the 14
# whose levels take 1.75 passes or more on the mean (p3d64's f64 level-0
# L, 2.51 passes a level: 4.46 -> 3.06 us a level; U, 1.99: 3.61 -> 2.77;
# the 1M factors' level 0, 6.4-8.4 passes: about 3x faster); one-pass
# levels lost (p3d64's f64 level 1, 1.06 and 1.08: 1.43 -> 2.80).  1.9
# picks the faster shape on 15 of the 16 and gives up 5% on the 1M f64
# level-2 L (1.75 passes)
SPLIT_CTAS = TILE_MAX_CLUSTER


def _pow2_floor(v: int) -> int:
    return 1 << (v.bit_length() - 1) if v >= 1 else 0


def trsv_team(K: int) -> int:
    """K2's team of lanes a slot: the least power of two ``tps`` with
    ``tps * 4 >= K``, at most a warp (as ``kernels.cu:trsv_solve``)."""
    return int(_teams(K))


def trsv_tile(nslots: int, level_passes, itemsize: int,
              nrhs: int) -> Tuple[int, int]:
    """K2's launch shape, ``(G, C)``: a cluster of C blocks owns a tile of
    G columns.  ``(1, 1)`` is the column form (a block a column), where x
    lives in shared memory or the schedule's levels (``level_passes``,
    :attr:`TrsvSchedule.level_passes`) fill on the mean less than
    TILE_MIN_PASSES passes of the block.  Else, at one column, the split
    ``(1, SPLIT_CTAS)``: with x global the ring holds only 128 KB of a
    level's rows, so a wide level loads the rest from global memory on its
    chain; split over the cluster, each block's share of a level fits its
    own ring and takes about one pass.  At several columns, the tile form
    (:func:`tile_shape`)."""
    if trsv_shape(nslots, itemsize) == "shared":
        return 1, 1
    if not len(level_passes) or np.mean(level_passes) < TILE_MIN_PASSES:
        return 1, 1
    if nrhs == 1:
        return 1, SPLIT_CTAS
    return tile_shape(itemsize, nrhs)


def tile_shape(itemsize: int, nrhs: int) -> Tuple[int, int]:
    """The tile form's ``(G, C)``: G the largest power of two at most ``nrhs
    / 8``, held between 2 and one 32-byte sector of x a slot (``32 //
    itemsize``: 8 f32, 4 f64 and c64, 2 c128), so that a dependency's
    gather serves G columns and each entry of the factor is read once for
    them; C the power of two up to TILE_MAX_CLUSTER that brings the
    launch's blocks nearest below TILE_CTAS (at least 1), so that the
    cluster's blocks split each level's slots."""
    G = min(SECTOR_BYTES // itemsize, max(2, _pow2_floor(nrhs // 8)))
    tiles = -(-nrhs // G)
    C = min(TILE_MAX_CLUSTER, max(1, _pow2_floor(TILE_CTAS // tiles)))
    return G, C


def _ring_width(sched: TrsvSchedule) -> int:
    """The widest level, in entries, for K2's ring of copied dependencies;
    0 (no ring) when some level's entries do not start on a 16-byte line
    of cols (the TMA copies whole lines)."""
    if np.any(sched.level_off % 4):
        return 0
    return int(np.diff(sched.level_off).max())


def trsv_apply_cuda(sched: TrsvSchedule, B: torch.Tensor) -> torch.Tensor:
    """Launch K2 once for the whole solve, B to X, one thread block a
    column or a cluster a tile of columns (:func:`trsv_tile`);
    ``trsv_apply_cuda.launches`` counts its launches, ``.tile_launches``
    those in the tile form, ``.smem_launches`` those with x in shared
    memory, ``.split_launches`` those of one column on a cluster and
    ``.levels`` the effective levels they walk.  Safe inside a
    captured graph: the level table it reads on the host is numpy, and its
    scratch comes from the caching allocator (the graph's pool)."""
    n, nrhs = B.shape
    if n != sched.n:
        raise ValueError(f"B has {n} rows, the schedule {sched.n}")
    tile, ncta = trsv_tile(sched.nslots, sched.level_passes,
                           B.element_size(), nrhs)
    return _trsv_launch(sched, B, tile, ncta)


trsv_apply_cuda.launches = 0
trsv_apply_cuda.tile_launches = 0
trsv_apply_cuda.levels = 0
trsv_apply_cuda.smem_launches = 0
trsv_apply_cuda.split_launches = 0


def _trsv_launch(sched: TrsvSchedule, B: torch.Tensor, tile: int,
                 ncta: int = 1) -> torch.Tensor:
    """K2 with ``tile`` columns a cluster of ``ncta`` blocks (1 and 1: the
    column form; 1 and more: the split): :func:`trsv_apply_cuda`'s launch,
    which a probe may call with other shapes to time them."""
    n, nrhs = B.shape
    X = B.new_empty((n, nrhs))
    if nrhs == 0 or sched.nchunks == 0:
        return X
    nslots = sched.nslots
    scratch = None
    if trsv_shape(nslots, B.element_size()) == "global":
        scratch = B.new_empty((-(-nrhs // tile) * tile * (nslots + 1),))
    extra = {} if scratch is None else dict(scratch=scratch)
    fn = kernel_fn("trsv_solve", index_dtypes=(torch.int32,) * 3
                   + (torch.int64, torch.int32, torch.int64), B=B, X=X,
                   in_rows=sched.in_rows, cols=sched.cols, vals=sched.vals,
                   out_slots=sched.out_slots,
                   level_slots=sched.level_slots_dev,
                   level_K=sched.level_K_dev,
                   level_off=sched.level_off_dev, **extra)
    with torch.cuda.device(B.device):
        err = fn(B.data_ptr(), X.data_ptr(), sched.in_rows.data_ptr(),
                 sched.cols.data_ptr(), sched.vals.data_ptr(),
                 sched.out_slots.data_ptr(),
                 sched.level_slots_dev.data_ptr(),
                 sched.level_K_dev.data_ptr(),
                 sched.level_off_dev.data_ptr(), sched.nlevels, n, nrhs,
                 nslots, _ring_width(sched), tile, ncta,
                 None if scratch is None else scratch.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    check(err, "trsv_solve")
    trsv_apply_cuda.launches += 1
    trsv_apply_cuda.tile_launches += tile > 1
    trsv_apply_cuda.levels += sched.nlevels
    trsv_apply_cuda.smem_launches += scratch is None
    trsv_apply_cuda.split_launches += tile == 1 and ncta > 1
    return X


def trsv_apply_mrhs(sched, B: torch.Tensor) -> torch.Tensor:
    """Solve (I + strict(T)) X = B for B of shape (n, nrhs); on a schedule,
    kernel K2 for a CUDA tensor and the plain version for a CPU one."""
    if isinstance(sched, TrsvDense):
        return sched.inv @ B
    if isinstance(sched, TrsvBlockDense):
        return _block_dense_apply(sched, B)
    if sched.nchunks == 0:
        return B
    if B.device.type == "cpu":
        return trsv_apply_plain(sched, B)
    return trsv_apply_cuda(sched, B.contiguous())
