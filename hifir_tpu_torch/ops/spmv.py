"""Sparse matrix times dense block in padded (sliced) ELL form.

The port of ``hifir_tpu/ops/spmv.py``: the packers are copied as they are,
so the arrays equal the reference's.  The product and the subtraction every
caller makes after it are one function, :func:`sliced_ell_sub_mrhs`
(``out = C - A X``, ``out = C + A X`` with ``sign=1``, or ``A X`` without
C): kernel K1 (``csrc/kernels.cu:sell_spmv``) on the card and its plain
PyTorch version on the CPU, in float32, float64, complex64 and complex128
(the sign is a real +-1 in every dtype).

A :class:`SlicedELL` keeps the reference's per-bucket ELL blocks and, for
the kernel, a table by position in the concatenation of the buckets (the
row there, its first flat entry and its true entry count): the blocks are
views of that concatenation, so the table costs three int32 vectors and no
second copy of the entries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import check, kernel_fn

__all__ = ["ELL", "SlicedELL", "ell_from_csr", "sliced_ell_from_csr",
           "ell_matvec", "ell_matvec_mrhs", "sliced_ell_sub_mrhs", "sliced_ell_sub_mrhs_plain",
           "sliced_ell_matvec_mrhs_plain", "ell_matvec_mrhs_plain"]


@dataclasses.dataclass
class ELL:
    """Padded sparse matrix: row r holds columns ``indices[r, :]`` with values
    ``values[r, :]``; padding uses column ``ncols`` and value 0."""

    indices: torch.Tensor   # (nrows, K) int32, pad = ncols
    values: torch.Tensor    # (nrows, K)
    nrows: int
    ncols: int

    @property
    def k(self) -> int:
        return self.indices.shape[1]


@dataclasses.dataclass
class SlicedELL:
    """Row-length-bucketed ELL (sliced ELLPACK)."""

    blocks: Tuple[ELL, ...]      # one ELL per bucket (rows sorted by length)
    inv_order: torch.Tensor      # (nrows,) int32: position of row i in concat
    nrows: int
    ncols: int
    flat_indices: torch.Tensor   # all buckets' indices, flattened in order
    flat_values: torch.Tensor
    # K1's table, by position p in the concatenation of the buckets (rows
    # sorted by entry count, so the nempty rows without entries come first)
    order: torch.Tensor          # (nrows,) int32: the row at position p
    pos_ptr: torch.Tensor        # (nrows,) int32: its first flat entry
    pos_nnz: torch.Tensor        # (nrows,) int32: its true entry count
    nempty: int                  # rows without entries
    max_nnz: int                 # entries of the longest row
    nnz: int                     # entries in all


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def ell_from_csr(A, dtype=None, min_k: int = 1, device="cuda") -> ELL:
    """Pack a host CSR matrix into padded ELL device arrays."""
    dev = resolve_device(device)
    n = A.nrows
    counts = np.diff(A.indptr)
    K = max(int(counts.max()) if n else 0, min_k)
    idx = np.full((n, K), A.ncols, dtype=np.int32)
    val = np.zeros((n, K), dtype=A.data.dtype if dtype is None else dtype)
    if A.indices.size:
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        offs = np.arange(A.indices.size, dtype=np.int64) - np.repeat(
            A.indptr[:-1], counts)
        idx[rows, offs] = A.indices
        val[rows, offs] = A.data
    return ELL(_tensor(idx, dev), _tensor(val, dev), n, A.ncols)


def sliced_ell_from_csr(A, dtype=None, base_k: int = 8,
                        device="cuda") -> SlicedELL:
    """Bucket rows by nnz (powers of two from ``base_k``) and pack each bucket
    as an ELL block; bounds padding waste to 2x within a bucket."""
    dev = resolve_device(device)
    zdt = np.dtype(A.data.dtype if dtype is None else dtype)
    n = A.nrows
    counts = np.diff(A.indptr)
    order = np.argsort(counts, kind="stable")
    inv_order = np.empty(n, dtype=np.int64)
    inv_order[order] = np.arange(n)

    packed: List[Tuple[np.ndarray, np.ndarray]] = []
    pos_ptr = np.empty(n, dtype=np.int64)
    base = 0
    start = 0
    while start < n:
        k_lo = counts[order[start]]
        cap = base_k
        while cap < k_lo:
            cap *= 2
        end = int(np.searchsorted(counts[order], cap, side="right"))
        rows = order[start:end]
        sub_counts = counts[rows]
        K = max(int(sub_counts.max()) if rows.size else 1, 1)
        idx = np.full((rows.size, K), A.ncols, dtype=np.int32)
        val = np.zeros((rows.size, K), dtype=zdt)
        if rows.size and sub_counts.sum():
            rr = np.repeat(np.arange(rows.size, dtype=np.int64), sub_counts)
            flat = (np.repeat(A.indptr[rows], sub_counts)
                    + np.arange(int(sub_counts.sum()), dtype=np.int64)
                    - np.repeat(np.concatenate(
                        [[0], np.cumsum(sub_counts)[:-1]]), sub_counts))
            offs = (np.arange(int(sub_counts.sum()), dtype=np.int64)
                    - np.repeat(np.concatenate(
                        [[0], np.cumsum(sub_counts)[:-1]]), sub_counts))
            idx[rr, offs] = A.indices[flat]
            val[rr, offs] = A.data[flat]
        packed.append((idx, val))
        pos_ptr[start:end] = base + np.arange(rows.size, dtype=np.int64) * K
        base += idx.size
        start = end

    flat_idx = _tensor(np.concatenate([i.ravel() for i, _ in packed])
                       if packed else np.empty(0, np.int32), dev)
    flat_val = _tensor(np.concatenate([v.ravel() for _, v in packed])
                       if packed else np.empty(0, zdt), dev)
    blocks = []
    off = 0
    for idx, _ in packed:
        r, K = idx.shape
        blocks.append(ELL(flat_idx[off:off + r * K].view(r, K),
                          flat_val[off:off + r * K].view(r, K), r, A.ncols))
        off += r * K
    if base >= 2**31:
        raise ValueError(f"{base} packed slots: K1 indexes them in 32 bits")
    i32 = np.int32
    return SlicedELL(tuple(blocks), _tensor(inv_order.astype(i32), dev),
                     n, A.ncols, flat_idx, flat_val,
                     _tensor(order.astype(i32), dev),
                     _tensor(pos_ptr.astype(i32), dev),
                     _tensor(counts[order].astype(i32), dev),
                     int(np.count_nonzero(counts == 0)),
                     int(counts.max()) if n else 0, int(counts.sum()))


# ---------------------------------------------------------------------------
# K1 and its plain version

def sliced_ell_matvec_mrhs_plain(A: SlicedELL,
                                 X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A X: the reference's per-bucket gather, multiply
    and reduce, concatenated and gathered back to row order."""
    if not A.blocks:  # empty operator (0 rows): e.g. a level with m == n
        return X.new_zeros((A.nrows, X.shape[1]))
    X_ext = torch.cat([X, X.new_zeros((1, X.shape[1]))])
    parts = [torch.einsum("rk,rkj->rj", blk.values, X_ext[blk.indices])
             for blk in A.blocks]
    return torch.cat(parts)[A.inv_order]


def ell_matvec_mrhs_plain(A: ELL, X: torch.Tensor) -> torch.Tensor:
    X_ext = torch.cat([X, X.new_zeros((1, X.shape[1]))])
    return torch.einsum("rk,rkj->rj", A.values, X_ext[A.indices])


def sliced_ell_sub_mrhs_plain(A, X: torch.Tensor, C=None, out=None,
                              sign: int = -1) -> torch.Tensor:
    """Plain PyTorch ``C + sign A X`` (``A X`` when C is None), written into
    ``out`` when it is given; ``sliced_ell_sub_mrhs_plain.calls`` counts its
    calls."""
    _check_sign(sign)
    sliced_ell_sub_mrhs_plain.calls += 1
    Y = (sliced_ell_matvec_mrhs_plain(A, X) if isinstance(A, SlicedELL)
         else ell_matvec_mrhs_plain(A, X))
    if C is not None:
        Y = torch.add(C, Y, alpha=sign, out=out)
    elif out is not None:
        Y = out.copy_(Y)
    return Y


sliced_ell_sub_mrhs_plain.calls = 0


def _check_sign(sign: int) -> None:
    if sign not in (-1, 1):
        raise ValueError(f"sell_spmv: sign must be -1 or +1, got {sign}")


# The column counts K1 runs in its narrow shape (a group of lanes a row);
# every other count runs in the wide shape (a warp a row).
NARROW_NRHS = (1, 2, 4, 8)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of two contiguous tensors intersect."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def sell_spmv_cuda(A, X: torch.Tensor, C=None, out=None,
                   sign: int = -1) -> torch.Tensor:
    """Launch K1: ``out = C + sign A X`` with sign -1 or +1 (``A X`` when C
    is None) for a SlicedELL or a uniform ELL; ``sell_spmv_cuda.launches``
    counts its launches and ``sell_spmv_cuda.plus_launches`` those with
    ``sign=1`` among them.

    ``out`` (allocated when None) may be C itself: the kernel then reads and
    writes only the rows that have entries.  Otherwise it must not overlap
    C.  It must never overlap X (checked): a row of out could be a row of X
    that A reads.  An operator without entries launches nothing; the result
    is C (or zeros), copied into ``out`` unless ``out`` is C.

    Safe inside a captured CUDA graph (:mod:`..graphs`): no host read, and
    every branch depends on shapes or on operand pointers, which a graph's
    static buffers and pool keep fixed from capture to replay."""
    _check_sign(sign)
    nrhs = X.shape[1]
    shape = (A.nrows, nrhs)
    if X.shape[0] != A.ncols:
        raise ValueError(f"X has {X.shape[0]} rows, operator {A.ncols} cols")
    for name, t in (("C", C), ("out", out)):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
    # the kernel forms row * nrhs and c * nrhs in 32 bits
    for name, rows in (("X", X.shape[0]), ("C", A.nrows)):
        if rows * nrhs >= 2**31:
            raise ValueError(f"sell_spmv: {name} rows x columns = {rows} x "
                             f"{nrhs} reach 2**31, beyond K1's 32-bit "
                             "offsets")
    if out is None:
        out = X.new_empty(shape)
    in_place = C is not None and C.data_ptr() == out.data_ptr()
    if _overlap(out, X) and out.numel() and X.numel():
        raise ValueError("sell_spmv: out overlaps X")
    if C is not None and not in_place and _overlap(out, C) and out.numel():
        raise ValueError("sell_spmv: out partly overlaps C")
    sliced = isinstance(A, SlicedELL)
    if sliced:
        idx, val, k_uni = A.flat_indices, A.flat_values, 0
        tables = dict(order=A.order, pos_ptr=A.pos_ptr, pos_nnz=A.pos_nnz)
        first = A.nempty if in_place else 0
        max_nnz, empty = A.max_nnz, A.nnz == 0
    else:
        idx, val, k_uni = A.indices, A.values, A.k
        tables, first, max_nnz = {}, 0, A.k
        empty = A.nrows * A.k == 0
    if A.nrows * k_uni >= 2**31:
        raise ValueError(f"sell_spmv: {A.nrows} x {k_uni} ELL entries reach "
                         "2**31, beyond K1's 32-bit offsets")
    if empty or nrhs == 0:
        if C is None:
            return out.zero_()
        return out if in_place else out.copy_(C)
    # rows of whole 16 bytes (element_size 4, 8 or 16: complex128 always)
    lines = nrhs * X.element_size() % 16 == 0
    if lines and nrhs in NARROW_NRHS and X.data_ptr() % 16:
        X = X.clone()      # the narrow shape loads such X rows in 16 bytes
    vec = lines and all(t.data_ptr() % 16 == 0 for t in (X, out)
                        + (() if C is None else (C,)))
    operands = dict(X=X, out=out) if C is None else dict(X=X, C=C, out=out)
    fn = kernel_fn("sell_spmv", index_dtypes=(torch.int32,) * (1 + len(tables)),
                   idx=idx, val=val, **tables, **operands)
    ptrs = ([t.data_ptr() for t in tables.values()] if sliced
            else [None] * 3)
    with torch.cuda.device(X.device):
        err = fn(idx.data_ptr(), val.data_ptr(), *ptrs, k_uni, first,
                 A.nrows, max_nnz, nrhs, A.ncols, X.data_ptr(),
                 None if C is None else C.data_ptr(), out.data_ptr(), sign,
                 int(vec), torch.cuda.current_stream(X.device).cuda_stream)
    check(err, "sell_spmv")
    sell_spmv_cuda.launches += 1
    if C is not None and sign == 1:
        sell_spmv_cuda.plus_launches += 1
    return out


sell_spmv_cuda.launches = 0
sell_spmv_cuda.plus_launches = 0


def sliced_ell_sub_mrhs(A, X: torch.Tensor, C=None, out=None,
                        sign: int = -1) -> torch.Tensor:
    """``out = C - A X`` (``C + A X`` with ``sign=1``) for a SlicedELL or a
    uniform ELL A, X of shape (ncols, nrhs); ``A X`` when C is None.
    ``out`` may be C (in place) and must not overlap X.  Kernel K1 for a
    CUDA tensor, the plain version for a CPU one."""
    if X.device.type == "cpu":
        return sliced_ell_sub_mrhs_plain(A, X, C, out, sign)
    if C is not None and C is not out:
        C = C.contiguous()
    return sell_spmv_cuda(A, X.contiguous(), C, out, sign)


def ell_matvec_mrhs(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for X of shape (ncols, nrhs); A may be ELL, SlicedELL or BSR
    (recognised by its ``block_cols`` attribute)."""
    if hasattr(A, "block_cols"):
        from .bsr_spmv import bsr_matvec_mrhs

        npad = A.nbr * A.bs
        Xp = torch.nn.functional.pad(X, (0, 0, 0, npad - X.shape[0]))
        return bsr_matvec_mrhs(A, Xp)[:A.n]
    return sliced_ell_sub_mrhs(A, X)


def ell_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a vector x (the one-column :func:`ell_matvec_mrhs`)."""
    return ell_matvec_mrhs(A, x[:, None])[:, 0]
