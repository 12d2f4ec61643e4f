"""Distributed Schur-complement SpGEMM (ring over column panels).

The port of ``hifir_tpu/parallel/schur.py``: ``S = C - L_E diag(d) U_F``
with rank k owning row block k of L_E and C and column panel k of U_F, the
panels rotated around the ring of ranks (:meth:`Mesh.shift`), so that at
ring step e rank k holds panel ``(k + e) % D`` and computes the partial rows
``(L_E D U_F)[rows_k, panel]``.  One step on every rank of a device is one
launch of kernel K10b (:func:`schur_partial`): per local L_E row the
KL * KU candidates, sorted by column, runs of equal columns summed, in one
of three tiers by the row's width (:func:`schur_plan`: a warp a row, a CTA
a row, or a CTA a row on global scratch), so that no width is refused.  The
host packs the operands (``_ell_pack``, ``_panelize_uf``, copied from the
JAX package) and compresses each step's output before the next rotation,
merging the A-tail block C as the JAX package does.  The step (K10b on
every group, its output gathered on the first group's device) and the
rotation (the ring shift of the panels) are two captured graphs of the
mesh's cache, as the JAX package jits them apart; the ring loop stays on
the host, which reads each step's output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ds.csr import CSR
from ..graphs import jit
from ..kernels.build import check, kernel_fn
from .mesh import Mesh, make_mesh

__all__ = ["schur_spgemm_ring", "schur_partial", "schur_partial_plain",
           "schur_partial_cuda", "schur_plan", "SCHUR_TIERS",
           "ring_operands"]


def _ell_pack(M: CSR, nrows_pad: int, sentinel: int):
    """Row-major ELL pack with padded rows and a sentinel column id."""
    counts = np.diff(M.indptr)
    K = max(int(counts.max()) if M.nrows else 0, 1)
    idx = np.full((nrows_pad, K), sentinel, dtype=np.int32)
    val = np.zeros((nrows_pad, K), dtype=M.data.dtype)
    if M.indices.size:
        rows = np.repeat(np.arange(M.nrows, dtype=np.int64), counts)
        offs = (np.arange(M.indices.size, dtype=np.int64)
                - np.repeat(M.indptr[:-1], counts))
        idx[rows, offs] = M.indices
        val[rows, offs] = M.data
    return idx, val, K


def _panelize_uf(U_F: CSR, D: int, cb: int):
    """Column panels of U_F as (D, m+1, KU) ELL with *local* column ids;
    row m is an all-sentinel row fed by padded L_E entries."""
    m = U_F.nrows
    cols = U_F.indices.astype(np.int64)
    panel = cols // cb
    local = (cols - panel * cb).astype(np.int32)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(U_F.indptr))
    counts = np.zeros((D, m), dtype=np.int64)
    np.add.at(counts, (panel, rows), 1)
    KU = max(int(counts.max()) if counts.size else 0, 1)
    idx = np.full((D, m + 1, KU), cb, dtype=np.int32)
    val = np.zeros((D, m + 1, KU), dtype=U_F.data.dtype)
    order = np.lexsort((local, rows, panel))
    pnl, rws, loc = panel[order], rows[order], local[order]
    dat = U_F.data[order]
    if order.size:
        key = pnl * (m + 1) + rws
        new = np.empty(order.size, dtype=bool)
        new[0] = True
        new[1:] = key[1:] != key[:-1]
        grp_start = np.repeat(np.flatnonzero(new),
                              np.diff(np.append(np.flatnonzero(new),
                                                order.size)))
        slot = np.arange(order.size) - grp_start
        idx[pnl, rws, slot] = loc
        val[pnl, rws, slot] = dat
    return idx, val, KU


def _check(le_idx, le_val, d, uf_idx, uf_val):
    R, nb, KL = le_idx.shape
    if (le_val.shape != le_idx.shape or uf_idx.dim() != 3
            or uf_val.shape != uf_idx.shape or uf_idx.shape[0] != R
            or d.shape != (R, uf_idx.shape[1])):
        raise ValueError(
            f"schur_partial: le {tuple(le_idx.shape)}, d {tuple(d.shape)}, "
            f"uf {tuple(uf_idx.shape)} do not fit")


def schur_partial_plain(le_idx, le_val, d, uf_idx, uf_val, cb: int):
    """Plain PyTorch K10b on every rank of the group (the JAX kernel's
    arithmetic: a stable sort, runs summed as cumulative-sum differences);
    returns (cols, vals), each (ranks, nb, KL * KU).
    ``schur_partial_plain.calls`` counts its calls."""
    _check(le_idx, le_val, d, uf_idx, uf_val)
    schur_partial_plain.calls += 1
    R, nb, KL = le_idx.shape
    KU = uf_idx.shape[2]
    W = KL * KU
    li = le_idx.long()
    ld = le_val * d.gather(1, li.view(R, -1)).view(R, nb, KL)
    rk = torch.arange(R, device=li.device)[:, None, None]
    cand_c = uf_idx[rk, li].reshape(R, nb, W)
    cand_v = (-(ld[..., None] * uf_val[rk, li])).reshape(R, nb, W)
    sc, order = torch.sort(cand_c, dim=-1, stable=True)
    sv = cand_v.gather(-1, order)
    prev = torch.cat([torch.full_like(sc[..., :1], -1), sc[..., :-1]], -1)
    nxt = torch.cat([sc[..., 1:], torch.full_like(sc[..., :1], cb + 1)], -1)
    pos = torch.arange(W, device=sc.device).expand_as(sc)
    cs = torch.cumsum(sv, -1)
    start = torch.cummax(torch.where(sc != prev, pos, 0), -1).values
    base = (cs - sv).gather(-1, start)
    valid = (sc != nxt) & (sc < cb)
    return (torch.where(valid, sc, cb).to(torch.int32),
            torch.where(valid, cs - base, torch.zeros_like(cs)))


schur_partial_plain.calls = 0


# K10b's tiers (csrc/kernels.cu: kSchurWarp, kSchurBlock, kSchurGlobal) and
# the padded widths P each takes: a warp a row up to kSchurWarpMax, a CTA a
# row up to kSchurTile, beyond it a CTA a row on a global scratch of
# kSchurTile-pair tiles.
SCHUR_TIERS = ("warp", "block", "global")
_P_RANGE = {"warp": (32, 512), "block": (512, 8192), "global": (16384, None)}
_ROWS_PER_CTA = 8      # kernels.cu:kSchurRowsPerCta
_GLOBAL_CTAS_PER_SM = 2


def schur_plan(W: int, rows: int, itemsize: int, sms: int, cb: int,
               tier=None) -> dict:
    """K10b's launch for ``rows`` rows of W = KL * KU candidates in panels
    of ``cb`` columns: the tier (the first of :data:`SCHUR_TIERS` whose
    range holds W, or ``tier``; the warp tier packs a column and a position
    in a word, so it also needs (cb + 2) P <= 2**31), the padded width P (a
    power of two >= W, at least the tier's least), the grid and the bytes
    of global scratch (the global tier's, P pairs a CTA).  Plain
    arithmetic; every row of a launch has the same W, so the tier is chosen
    once a launch, and no W is refused."""
    if W < 1 or rows < 0 or cb < 0:
        raise ValueError(f"schur_plan: W = {W}, rows = {rows}, cb = {cb}")
    P = 1 << (W - 1).bit_length()

    def fits(x):
        lo, hi = _P_RANGE[x]
        return ((hi is None or P <= hi)
                and (x != "warp" or (cb + 2) * max(P, lo) <= 2**31))

    if tier is None:
        tier = next(x for x in SCHUR_TIERS if fits(x))
    elif tier not in SCHUR_TIERS:
        raise ValueError(f"schur_plan: tier {tier!r} not in {SCHUR_TIERS}")
    elif not fits(tier):
        raise ValueError(f"schur_plan: W = {W} (cb = {cb}) does not fit the "
                         f"{tier} tier")
    P = max(P, _P_RANGE[tier][0])
    grid = {"warp": -(-rows // _ROWS_PER_CTA), "block": rows,
            "global": min(rows, _GLOBAL_CTAS_PER_SM * sms)}[tier]
    scratch = grid * P * (4 + itemsize) if tier == "global" else 0
    return dict(tier=tier, P=P, grid=grid, scratch=scratch)


def schur_partial_cuda(le_idx, le_val, d, uf_idx, uf_val, cb: int,
                       tier=None):
    """Launch K10b for every rank of the group, in the tier that
    :func:`schur_plan` picks for W = KL * KU (or ``tier``); no width is
    refused.  ``schur_partial_cuda.launches`` counts its launches."""
    _check(le_idx, le_val, d, uf_idx, uf_val)
    R, nb, KL = le_idx.shape
    KU = uf_idx.shape[2]
    W = KL * KU
    if R * nb * W >= 2**31 or uf_idx.shape[1] * KU >= 2**31:
        raise ValueError("schur_partial: operands reach 2**31 entries")
    dev = le_idx.device
    out_c = torch.empty((R, nb, W), dtype=torch.int32, device=dev)
    out_v = le_val.new_empty((R, nb, W))
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    plan = schur_plan(W, R * nb, le_val.element_size(), sms, cb, tier)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
    fn = kernel_fn("schur_partial",
                   index_dtypes=(torch.int32,) * 2 + (torch.uint8,
                                                      torch.int32),
                   le_idx=le_idx, le_val=le_val, d=d, uf_idx=uf_idx,
                   uf_val=uf_val, scratch=scratch, out_c=out_c, out_v=out_v)
    with torch.cuda.device(dev):
        err = fn(le_idx.data_ptr(), le_val.data_ptr(), d.data_ptr(),
                 d.shape[1], uf_idx.data_ptr(), uf_val.data_ptr(),
                 uf_idx.shape[1] * KU, R * nb, nb, KL, KU, cb,
                 SCHUR_TIERS.index(plan["tier"]), plan["P"], plan["grid"],
                 scratch.data_ptr(), out_c.data_ptr(), out_v.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    check(err, f"schur_partial ({plan['tier']} tier, P = {plan['P']})")
    schur_partial_cuda.launches += 1
    return out_c, out_v


schur_partial_cuda.launches = 0


def schur_partial(le_idx, le_val, d, uf_idx, uf_val, cb: int):
    """One ring step on every rank of a group: masked (col, val) pairs of
    ``-(L_E D U_F)[rows, panel]``, columns local to the panel (``cb``
    where masked).  ``le_idx``/``le_val`` (ranks, nb, KL), ``d``
    (ranks, m + 1), ``uf_idx``/``uf_val`` (ranks, m + 1, KU).  Kernel K10b
    for CUDA tensors, the plain version for CPU ones."""
    if le_idx.device.type == "cpu":
        return schur_partial_plain(le_idx, le_val, d, uf_idx, uf_val, cb)
    return schur_partial_cuda(le_idx, le_val, d, uf_idx, uf_val, cb)


class _Ring:
    """The ring's fixed operands (per group: ``le_idx``/``le_val`` and the
    replicated ``d``), its panel width and mesh: one key item of its
    programs."""

    def __init__(self, mesh, le_idx, le_val, d, cb):
        self.mesh, self.le_idx, self.le_val, self.d, self.cb = (
            mesh, le_idx, le_val, d, cb)


def ring_operands(L_E: CSR, d: np.ndarray, U_F: CSR, mesh: Mesh):
    """The ring's operands on ``mesh``'s ranks: the fixed ones (a
    :class:`_Ring`) and the panels ``uf_idx``/``uf_val`` as rank k holds
    them at step 0, for L_E with rows (``nm`` > 0)."""
    D = mesh.D
    nm, m = L_E.nrows, L_E.ncols
    nmp = -(-nm // D) * D
    nb = nmp // D
    cb = nmp // D  # panel width (the same padded split of the tail columns)
    le_idx_h, le_val_h, KL = _ell_pack(L_E, nmp, sentinel=m)
    uf_idx_h, uf_val_h, KU = _panelize_uf(U_F, D, cb)
    d_ext = np.concatenate([np.asarray(d), np.zeros(1, dtype=L_E.data.dtype)])
    ring = _Ring(mesh, mesh.put(le_idx_h.reshape(D, nb, KL)),
                 mesh.put(le_val_h.reshape(D, nb, KL)),
                 mesh.replicate(torch.as_tensor(d_ext)), cb)
    return ring, mesh.put(uf_idx_h), mesh.put(uf_val_h)


def _ring_step(ring: _Ring, uf_idx, uf_val):
    """One ring step on every group (K10b a group), the masked (col, val)
    pairs of every rank gathered on the first group's device, (D, nb, W)
    each."""
    outs = [schur_partial(*a, ring.cb) for a in zip(
        ring.le_idx, ring.le_val, ring.d, uf_idx, uf_val)]
    return (ring.mesh.collect([c for c, _ in outs]),
            ring.mesh.collect([v for _, v in outs]))


def _ring_rotate(ring: _Ring, uf_idx, uf_val):
    """The panels one step around the ring: rank k receives rank k + 1's."""
    return (ring.mesh.shift(uf_idx, -1, ring=True),
            ring.mesh.shift(uf_val, -1, ring=True))


def schur_spgemm_ring(C_tail: CSR, L_E: CSR, d: np.ndarray, U_F: CSR,
                      mesh: Optional[Mesh] = None, device="cuda") -> CSR:
    """S = C_tail - L_E diag(d) U_F by the ring SpGEMM over ``mesh``'s
    ``rows`` ranks (default: :func:`make_mesh` on ``device``).  Inputs and
    result are host CSR; D - 1 panel rotations move U_F around the ring.
    Equal to the host Schur to rounding (the runs are summed in another,
    fixed order)."""
    if mesh is None:
        mesh = make_mesh(device=device)
    D = mesh.D
    nm = L_E.nrows
    if nm == 0:
        return C_tail
    dtype = np.result_type(L_E.data.dtype, U_F.data.dtype)
    if np.dtype(dtype).kind != "f":
        raise TypeError(f"schur_spgemm_ring is real only, got {dtype}")
    nmp = -(-nm // D) * D
    nb = nmp // D
    ring, uf_idx, uf_val = ring_operands(L_E, d, U_F, mesh)
    cb = ring.cb
    step, rotate = jit(mesh, _ring_step), jit(mesh, _ring_rotate)
    rows_acc, cols_acc, vals_acc = [], [], []
    for e in range(D):
        oc, ov = step(ring, uf_idx, uf_val)
        oc = oc.cpu().numpy().reshape(D * nb, -1)
        ov = ov.cpu().numpy().reshape(D * nb, -1)
        keep = oc < cb
        if keep.any():
            r, k = np.nonzero(keep)
            # rank r // nb holds panel (r // nb + e) % D at this step
            panel = (r // nb + e) % D
            rows_acc.append(r.astype(np.int64))
            cols_acc.append(panel * cb + oc[r, k].astype(np.int64))
            vals_acc.append(ov[r, k])
        if e < D - 1:
            # rank k receives panel k + 1's holder's panel
            uf_idx, uf_val = rotate(ring, uf_idx, uf_val)

    # merge the A-tail block on the host (duplicates coalesce in from_coo)
    c_rows = np.repeat(np.arange(nm, dtype=np.int64), np.diff(C_tail.indptr))
    rows_acc.append(c_rows)
    cols_acc.append(C_tail.indices.astype(np.int64))
    vals_acc.append(C_tail.data)
    S = CSR.from_coo(nmp, nmp, np.concatenate(rows_acc),
                     np.concatenate(cols_acc), np.concatenate(vals_acc))
    if nmp != nm:
        return CSR(nm, nm, S.indptr[:nm + 1], S.indices[:S.indptr[nm]],
                   S.data[:S.indptr[nm]])
    return CSR(nm, nm, S.indptr, S.indices, S.data)
