"""Distributed multilevel M-solve.

The port of ``hifir_tpu/parallel/prec_sharded.py``: a distributed
level-scheduled trsv and row-sharded E/F products composed into one
multilevel solve whose factor operands are sharded over the ``rows`` ranks.
Each level's L/U solve is carried by one of two operators:

- :class:`~.trsv_halo.HaloOp` (default): the working vector distributed
  (own slots + the exact host-counted halo), per-chunk neighbour packages
  and a compact all_gather;
- :class:`AGTrsvOp` (also ``halo=False``): the replicated working vector
  reassembled per chunk with a tiled all_gather.

Both run a factor's chunk loop as its plan says (``form``, read from the
mesh's topology when the factor is built, :func:`~.trsv_sharded.loop_plan`):
on a mesh whose ranks share one device, one launch of the chunk sweep (K10a
redesigned, the exchange inside it) a factor application; over several
groups whose devices reach each other's memory, the peer sweep, one launch
a card, the exchange stored through peer pointers inside it; otherwise (or
with ``form="chunk"``) a K10a launch a chunk for every group, the legs as
the mesh's copies.
The E and F products run kernel K1 on each rank's row block, the ranks of a
device in one launch (:func:`~.sharded.stacked_ell`); the dense tail is the
port's :class:`~hifir_tpu_torch.alg.prec.DevicePrec` tail, every rank's copy
a column of one batched solve.  Per-rank operands are lists with one
(ranks, ...) tensor per group of the mesh.  Real dtypes only, as the JAX
package (float64 by default, float32 allowed).

:meth:`DistPrec.solve` is one captured CUDA graph of :func:`_dist_solve` for
each shape and dtype of b (the JAX package jits the whole solve under
``shard_map``): the exchange plans, every factor's chunk loop in its form
(the sweep, the peer sweep with its epoch bump, or K10a a chunk with the
legs' copies), the E/F products and the dense tail of every group,
replayed from the pack's ``graph_cache`` (:mod:`~hifir_tpu_torch.graphs`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from ..alg.prec import DenseTail, _dense_tail, tail_solve_mrhs
from ..device import numpy_dtype, torch_dtype
from ..graphs import jit
from ..ops.chunk import SweepPlan
from ..ops.spmv import ELL, ell_from_csr, sliced_ell_sub_mrhs
from ..ops.trsv import build_trsv_schedule
from .exchange import XPlan, build_exchange_plan, xplan_fetch
from .mesh import Mesh
from .sharded import pad_rows, stacked_ell
from .trsv_halo import HaloOp, build_halo_op, halo_op_kernel
from .trsv_sharded import ag_plan, ag_sweep, shard_chunks

__all__ = ["DistPrec", "AGTrsvOp", "DistLevel", "ag_op_kernel"]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class AGTrsvOp:
    """Tiled-all_gather trsv operand (one level's L or U factor).

    With ``sharded`` (the from_host default) the entry and exit index maps
    are row-sharded too: each rank maps its slice and one tiled all_gather
    reassembles."""

    mesh: Mesh
    in_rows: List[torch.Tensor]    # (ranks, nslots / D) or (ranks, nslots)
    cols: List[torch.Tensor]       # (nchunks, ranks, Cloc, K) int32
    vals: List[torch.Tensor]
    out_slots: List[torch.Tensor]  # (ranks, n_pad / D) or (ranks, n)
    nchunks: int
    chunk: int
    n: int
    sharded: bool = False
    form: Optional[str] = None     # None: by the layout; "chunk": K10a
    plan: SweepPlan = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.plan = ag_plan(self.mesh, self.cols, self.vals, self.chunk,
                            self.form)

    @property
    def nslots(self) -> int:
        return self.nchunks * self.chunk

    def nbytes(self) -> int:
        return _nbytes(self.cols + self.vals + self.in_rows + self.out_slots)


def ag_op_kernel(op: AGTrsvOp, bs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tiled-all_gather trsv on replicated ``bs`` (per group
    (ranks, n)); the result replicated."""
    if op.nchunks == 0:
        return bs
    mesh, ns = op.mesh, op.nslots
    xs = []
    for b in bs:
        xs.append(b.new_zeros((b.shape[0], ns + 1)))
    exts = [torch.cat([b, b.new_zeros((b.shape[0], 1))], 1) for b in bs]
    if op.sharded:
        mesh.all_gather([e.gather(1, ir) for e, ir in zip(exts, op.in_rows)],
                        out=[x[:, :ns] for x in xs])
    else:
        for x, e, ir in zip(xs, exts, op.in_rows):
            x[:, :ns] = e.gather(1, ir)
    ag_sweep(op, xs)
    ys = [x.gather(1, o) for x, o in zip(xs, op.out_slots)]
    if op.sharded:
        return [y[:, :op.n] for y in mesh.all_gather(ys)]
    return ys


def _trsv_op_kernel(op, bs):
    if isinstance(op, HaloOp):
        return halo_op_kernel(op, bs)
    return ag_op_kernel(op, bs)


@dataclasses.dataclass
class DistLevel:
    """One level's distributed operands.

    With ``vec_sharded`` (the :meth:`DistPrec.from_host` default) the
    vectors ``p/q_inv/s_p/t/d`` are row-sharded (padded to the rank count):
    each rank keeps and computes its 1/D slice of the permute+scale work and
    one tiled all_gather reassembles the working vector; otherwise every
    rank keeps them whole.  ``E`` and ``F`` are each group's K1 operator of
    its ranks' row blocks."""

    p: List[torch.Tensor]
    q_inv: List[torch.Tensor]
    s_p: List[torch.Tensor]
    t: List[torch.Tensor]
    d: List[torch.Tensor]
    L_op: Union[AGTrsvOp, HaloOp]
    U_op: Union[AGTrsvOp, HaloOp]
    E: List[ELL]           # over the ranks' stacked x1 (m rows each)
    F: List[ELL]           # over the ranks' stacked x_tail (n - m rows)
    m: int
    n: int
    E_rows: int            # padded row count of E
    F_rows: int
    vec_sharded: bool = False
    # the inter-level link: this level's permuted input fetched from the
    # previous level's distributed E output
    xin: Optional[XPlan] = None
    # gathers of the sharded forms (None when the vectors are whole)
    d_idx: Optional[List[torch.Tensor]] = None    # (ranks, blk): x1 entry
    e_idx: Optional[List[torch.Tensor]] = None    # (ranks, E_rows/D): wb row

    def nbytes(self) -> dict:
        """Bytes of the level on all ranks: the sharded factor (L/U ops,
        E, F, the exchange plan), and the vectors."""
        fac = self.L_op.nbytes() + self.U_op.nbytes() + _nbytes(
            [t for e in self.E + self.F for t in (e.indices, e.values)])
        if self.xin is not None:
            fac += self.xin.nbytes()
        vec = _nbytes(self.p + self.q_inv + self.s_p + self.t + self.d
                      + (self.d_idx or []) + (self.e_idx or []))
        return dict(sharded=fac, vectors=vec)


def _ext(x: torch.Tensor) -> torch.Tensor:
    """x (ranks, n) with a zero column appended."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1))], 1)


def _permute_scale(mesh, scale, perm, vec, n, vec_sharded):
    """``scale * vec[perm]``: with sharded vectors each rank gathers and
    scales its slice, then one tiled all_gather reassembles."""
    if not vec_sharded:
        return [s * v.gather(1, p) for s, p, v in zip(scale, perm, vec)]
    loc = [s * _ext(v).gather(1, p) for s, p, v in zip(scale, perm, vec)]
    return [y[:, :n] for y in mesh.all_gather(loc)]


def _div_diag(mesh, x, d, d_idx, m, vec_sharded):
    """``x / d`` for the replicated trsv output against a possibly
    row-sharded diagonal."""
    if not vec_sharded:
        return [a / b for a, b in zip(x, d)]
    loc = [_ext(a).gather(1, i) / b for a, i, b in zip(x, d_idx, d)]
    return [y[:, :m] for y in mesh.all_gather(loc)]


def _spmv_local(ells, xs, C=None):
    """Each rank's row block times its copy of x (K1, a launch a group),
    ``C - A x`` with C; per group (ranks, rows per rank)."""
    out = []
    for i, (ell, x) in enumerate(zip(ells, xs)):
        c = None if C is None else C[i].reshape(-1, 1)
        y = sliced_ell_sub_mrhs(ell, x.reshape(-1, 1), c)
        out.append(y.view(x.shape[0], -1))
    return out


def _tail_solve(tails, rhs):
    """The dense tail on every rank's copy: a group's copies as the
    columns of one batched solve."""
    if tails is None:
        return rhs
    return [tail_solve_mrhs(t, r.T).T.contiguous()
            for t, r in zip(tails, rhs)]


def _dist_solve(mesh: Mesh, levels: List[DistLevel], tails, bs):
    wbs = []
    rhs = bs          # replicated inter-level vector
    rhs_loc = None    # distributed alternative (the E-output link)
    for i, lvl in enumerate(levels):
        m = lvl.m
        if lvl.xin is not None and rhs_loc is not None:
            f = xplan_fetch(lvl.xin, rhs_loc)
            wb = [y[:, :lvl.n] for y in mesh.all_gather(
                [s * v for s, v in zip(lvl.s_p, f)])]
        else:
            wb = _permute_scale(mesh, lvl.s_p, lvl.p, rhs, lvl.n,
                                lvl.vec_sharded)
        x1 = _trsv_op_kernel(lvl.L_op, [w[:, :m] for w in wb])
        x1 = _div_diag(mesh, x1, lvl.d, lvl.d_idx, m, lvl.vec_sharded)
        x1 = _trsv_op_kernel(lvl.U_op, x1)
        nxt = levels[i + 1].xin if i + 1 < len(levels) else None
        if nxt is not None:
            # keep the E output distributed; the next level fetches its
            # footprint through the exchange plan
            rows = [_ext(w).gather(1, e) for w, e in zip(wb, lvl.e_idx)]
            rhs_loc = _spmv_local(lvl.E, x1, rows)
            rhs = None
        else:
            y = mesh.all_gather(_spmv_local(lvl.E, x1))
            rhs = [w[:, m:] - a[:, :lvl.n - m] for w, a in zip(wb, y)]
            rhs_loc = None
        wbs.append(wb)
    x_tail = _tail_solve(tails, rhs)
    for lvl, wb in zip(reversed(levels), reversed(wbs)):
        m = lvl.m
        if lvl.n - m:
            y = mesh.all_gather(_spmv_local(lvl.F, x_tail))
            z = [w[:, :m] - a[:, :m] for w, a in zip(wb, y)]
        else:
            z = [w[:, :m] for w in wb]
        z = _trsv_op_kernel(lvl.L_op, z)
        z = _div_diag(mesh, z, lvl.d, lvl.d_idx, m, lvl.vec_sharded)
        z = _trsv_op_kernel(lvl.U_op, z)
        sol = [torch.cat([a, b], 1) for a, b in zip(z, x_tail)]
        x_tail = _permute_scale(mesh, lvl.t, lvl.q_inv, sol, lvl.n,
                                lvl.vec_sharded)
    return x_tail


def _solve(mesh: Mesh, levels: List[DistLevel], tails, b: torch.Tensor):
    """The solve's program: b (on rank 0's device) replicated, the
    multilevel solve, rank 0's copy of x."""
    return _dist_solve(mesh, levels, tails, mesh.replicate(b))[0][0]


class DistPrec:
    """Rank-distributed multilevel preconditioner.

    ``comm_elems`` / ``allgather_elems`` sum the host-counted exchange
    volume over the halo-carried factors and the exchange plans against
    what the tiled all_gather scheme would move for them (per solve, per
    trsv application); ``n_halo`` counts the halo-carried factors.

    With ``graphs`` on (the default) :meth:`solve` is a replay of its
    captured graph on a CUDA mesh (one card, or several:
    :func:`~hifir_tpu_torch.graphs.cache_of` picks the backend from
    ``devices``), the programs kept in ``graph_cache``; off, or on the CPU,
    it runs eagerly."""

    def __init__(self, mesh: Mesh, levels: List[DistLevel],
                 tails: Optional[List[DenseTail]], dtype: torch.dtype,
                 comm_elems: int = 0, allgather_elems: int = 0,
                 n_halo: int = 0, graphs: bool = True):
        self.mesh = mesh
        self.levels = levels
        self.tails = tails
        self.dtype = dtype
        self.comm_elems = comm_elems
        self.allgather_elems = allgather_elems
        self.n_halo = n_halo
        self.graphs = graphs
        self.graph_cache = None

    @property
    def devices(self):
        """Each rank's device (the mesh's): what the graph backend
        follows."""
        return self.mesh.devices

    @classmethod
    def from_host(cls, mesh: Mesh, M, dtype=None, chunk=256,
                  halo: bool = True, shard_vectors: bool = True,
                  max_halo_chunks: int = 128,
                  form: Optional[str] = None,
                  graphs: bool = True) -> "DistPrec":
        """Build from a factorized host :class:`hifir_tpu_torch.api.HIF` on
        the mesh's ranks (their devices).

        ``halo=True`` carries every level's L/U solve with the compact
        per-chunk halo exchange (:mod:`.trsv_halo`); factors it cannot carry
        (one rank, an empty factor, more than ``max_halo_chunks`` chunks)
        take the tiled all_gather op.  ``shard_vectors`` row-shards the
        per-level permutation, scaling and diagonal vectors and the trsv
        entry/exit maps, and links the levels through exchange plans.
        ``dtype`` is float64 (default) or float32; a complex ``M`` raises
        TypeError (the JAX package's DistPrec is real only).  ``form``
        lays out every factor's chunk loop: None by the mesh's topology
        (the sweep, the peer sweep or K10a a chunk), ``"chunk"`` K10a a
        chunk (:func:`~.trsv_sharded.loop_plan`).  ``graphs``: see the
        class docstring."""
        ndt = np.dtype(np.float64 if dtype is None else numpy_dtype(dtype))
        cplx = [p for p in M.precs if np.iscomplexobj(p.d)
                or (p.dense_matrix is not None
                    and np.iscomplexobj(p.dense_matrix))]
        if cplx or ndt.kind != "f":
            raise TypeError(
                f"DistPrec is real only (float32 or float64): got a "
                f"{'complex ' if cplx else ''}preconditioner and dtype "
                f"{ndt}")
        tdt = torch_dtype(ndt)
        D = mesh.D
        auto_chunk = chunk == "auto"
        C = max(256 if auto_chunk else chunk, D)
        C -= C % D
        comm = ag_comm = n_halo = 0

        def put_vec(arr, pad_val, dt):
            a = np.asarray(arr)
            if not shard_vectors:
                return mesh.replicate(torch.as_tensor(a, dtype=dt))
            padded = (-len(a)) % D
            if padded:
                a = np.concatenate([a, np.full(padded, pad_val,
                                               dtype=a.dtype)])
            return mesh.put(a.reshape(D, -1), dtype=dt)

        def make_op(T, lower):
            nonlocal comm, ag_comm, n_halo
            if halo:
                op = build_halo_op(mesh, T, lower=lower, chunk=C, dtype=ndt,
                                   max_chunks=max_halo_chunks, form=form)
                if op is not None:
                    comm += op.comm_elems
                    ag_comm += op.allgather_elems
                    n_halo += 1
                    return op
            s = build_trsv_schedule(T, lower=lower,
                                    chunk="auto" if auto_chunk else C,
                                    dtype=ndt, k_cap="auto", device="cpu",
                                    chunk_multiple=D)
            ins, outs = s.in_rows.long(), s.out_slots.long()
            if shard_vectors and s.nchunks:
                nslots = s.nchunks * s.chunk
                # the exit map padded to a rank multiple: the sentinel slot
                # nslots reads the zero slot and is trimmed by [:n]
                padded = (-len(outs)) % D
                outs = torch.cat([outs, torch.full((padded,), nslots)])
                ins_r, outs_r = (mesh.put(a.numpy().reshape(D, -1))
                                 for a in (ins, outs))
            else:
                ins_r, outs_r = mesh.replicate(ins), mesh.replicate(outs)
            return AGTrsvOp(mesh, ins_r, shard_chunks(mesh, s.cols.numpy()),
                            shard_chunks(mesh, s.vals.numpy()), outs_r,
                            s.nchunks, s.chunk, s.n,
                            sharded=bool(shard_vectors and s.nchunks),
                            form=form)

        def local_ell(A, xrows):
            Ap = pad_rows(A, D)
            e = ell_from_csr(Ap, dtype=ndt, device="cpu")
            nb = Ap.nrows // D
            ells = [stacked_ell(i, v, A.ncols, xrows) for i, v in zip(
                mesh.put(e.indices.numpy().reshape(D, nb, -1)),
                mesh.put(e.values.numpy().reshape(D, nb, -1)))]
            return ells, Ap.nrows

        levels = []
        prev_E_rows = None
        for prec in M.precs:
            m, n = prec.m, prec.n
            E, E_rows = local_ell(prec.E, m)
            F, F_rows = local_ell(prec.F, n - m)
            xin = None
            if (shard_vectors and D > 1 and prev_E_rows is not None
                    and prev_E_rows >= n):
                p_pad = np.asarray(prec.p)
                padded = (-len(p_pad)) % D
                if padded:
                    p_pad = np.concatenate(
                        [p_pad, np.full(padded, n, dtype=p_pad.dtype)])
                xin = build_exchange_plan(mesh, n, prev_E_rows // D,
                                          p_pad.reshape(D, -1))
                comm += xin.comm_elems
                ag_comm += xin.allgather_elems
            prev_E_rows = E_rows
            d_idx = e_idx = None
            if shard_vectors:
                blk = -(-m // D)
                i = np.arange(D * blk).reshape(D, blk)
                d_idx = mesh.put(np.where(i < m, i, m))
                blk_e = E_rows // D
                r = np.arange(D * blk_e).reshape(D, blk_e)
                e_idx = mesh.put(np.where(r < n - m, m + r, n))
            levels.append(DistLevel(
                p=put_vec(prec.p, n, torch.int64),
                q_inv=put_vec(prec.q_inv, n, torch.int64),
                s_p=put_vec(prec.s[prec.p], 0.0, tdt),
                t=put_vec(prec.t, 0.0, tdt),
                d=put_vec(prec.d, 1.0, tdt),
                L_op=make_op(prec.L_B, True),
                U_op=make_op(prec.U_B, False),
                E=E, F=F, m=m, n=n, E_rows=E_rows, F_rows=F_rows,
                vec_sharded=shard_vectors, xin=xin, d_idx=d_idx,
                e_idx=e_idx))
        tails = None
        if M.precs[-1].dense_solver is not None:
            tails = [_dense_tail(M.precs[-1], tdt, g.device)
                     for g in mesh.groups()]
        return cls(mesh, levels, tails, tdt, comm, ag_comm, n_halo, graphs)

    def solve(self, b) -> torch.Tensor:
        """x = M^{-1} b; b replicated to every rank, rank 0's copy of x
        returned (on its device; a fresh tensor when replayed)."""
        b = torch.as_tensor(b, dtype=self.dtype, device=self.mesh.device)
        return jit(self, _solve)(self.mesh, self.levels, self.tails, b)

    def nbytes_per_rank(self) -> dict:
        """Bytes a rank holds, on average over the ranks: the sharded factor
        (trsv ops, E and F, exchange plans), the replicated dense tail, and
        the per-level vectors and index maps."""
        D = self.mesh.D
        per = [lvl.nbytes() for lvl in self.levels]
        tail = 0
        if self.tails is not None:
            t = self.tails[0]
            tail = _nbytes([t.Q, t.R, t.jpvt, t.jpvt_inv, t.w])
        return dict(sharded=sum(p["sharded"] for p in per) / D,
                    replicated=tail,
                    vectors=sum(p["vectors"] for p in per) / D)
