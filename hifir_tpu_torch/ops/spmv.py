"""Sparse matrix times dense block in padded (sliced) ELL form.

The port of ``hifir_tpu/ops/spmv.py``: the packers are copied as they are,
so the arrays equal the reference's; the product is kernel K1
(``csrc/kernels.cu:sell_spmv``) on the card and its plain PyTorch version,
:func:`sliced_ell_matvec_mrhs_plain`, on the CPU.

A :class:`SlicedELL` keeps the reference's per-bucket ELL blocks and, for
the kernel, a per-row table into the concatenation of the buckets: the
blocks are views of that concatenation, so the table costs two vectors and
no second copy of the entries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import check, kernel_fn

__all__ = ["ELL", "SlicedELL", "ell_from_csr", "sliced_ell_from_csr",
           "ell_matvec", "ell_matvec_mrhs", "sliced_ell_matvec_mrhs",
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
    row_ptr: torch.Tensor        # (nrows,) int64: row's first flat entry
    row_len: torch.Tensor        # (nrows,) int32: its bucket's width K


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
    row_ptr = np.empty(n, dtype=np.int64)
    row_len = np.empty(n, dtype=np.int32)
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
        row_ptr[rows] = base + np.arange(rows.size, dtype=np.int64) * K
        row_len[rows] = K
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
    return SlicedELL(tuple(blocks), _tensor(inv_order.astype(np.int32), dev),
                     n, A.ncols, flat_idx, flat_val, _tensor(row_ptr, dev),
                     _tensor(row_len, dev))


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


def sell_spmv_cuda(A, X: torch.Tensor) -> torch.Tensor:
    """Launch K1 over a SlicedELL (row table) or a uniform ELL;
    ``sell_spmv_cuda.launches`` counts its launches."""
    if X.shape[0] != A.ncols:
        raise ValueError(f"X has {X.shape[0]} rows, operator {A.ncols} cols")
    nrhs = X.shape[1]
    Y = X.new_empty((A.nrows, nrhs))
    if A.nrows == 0 or nrhs == 0:
        return Y
    if isinstance(A, SlicedELL):
        idx, val, k_uni = A.flat_indices, A.flat_values, 0
        tables = (A.row_ptr, A.row_len)
        ptrs = (A.row_ptr.data_ptr(), A.row_len.data_ptr())
        index_dtypes = (torch.int32, torch.int64, torch.int32)
    else:
        idx, val, k_uni = A.indices, A.values, A.k
        tables, ptrs = (), (None, None)
        index_dtypes = (torch.int32,)
    fn = kernel_fn("sell_spmv", idx, val, *tables, X, Y,
                   index_dtypes=index_dtypes)
    err = fn(idx.data_ptr(), val.data_ptr(), *ptrs, k_uni, A.nrows, nrhs,
             A.ncols, X.data_ptr(), Y.data_ptr(),
             torch.cuda.current_stream(X.device).cuda_stream)
    check(err, "sell_spmv")
    sell_spmv_cuda.launches += 1
    return Y


sell_spmv_cuda.launches = 0


def sliced_ell_matvec_mrhs(A: SlicedELL, X: torch.Tensor) -> torch.Tensor:
    """Y = A X: kernel K1 for a CUDA tensor, the plain version for a CPU
    one."""
    if X.device.type == "cpu":
        return sliced_ell_matvec_mrhs_plain(A, X)
    return sell_spmv_cuda(A, X.contiguous())


def ell_matvec_mrhs(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for X of shape (ncols, nrhs); A may be ELL, SlicedELL or BSR
    (recognised by its ``block_cols`` attribute)."""
    if hasattr(A, "block_cols"):
        from .bsr_spmv import bsr_matvec_mrhs

        npad = A.nbr * A.bs
        Xp = torch.nn.functional.pad(X, (0, 0, 0, npad - X.shape[0]))
        return bsr_matvec_mrhs(A, Xp)[:A.n]
    if isinstance(A, SlicedELL):
        return sliced_ell_matvec_mrhs(A, X)
    if X.device.type == "cpu":
        return ell_matvec_mrhs_plain(A, X)
    return sell_spmv_cuda(A, X.contiguous())


def ell_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a vector x (the one-column :func:`ell_matvec_mrhs`)."""
    return ell_matvec_mrhs(A, x[:, None])[:, 0]
