"""Block-sparse (BSR) matrix times dense block.

The port of ``hifir_tpu/ops/pallas_spmv.py``: ``bsr_from_csr`` is copied as
it is; the product is kernel K7 (``csrc/kernels.cu:bsr_spmv``) on the card
and its plain PyTorch version, :func:`bsr_matvec_mrhs_plain`, on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import check, kernel_fn

__all__ = ["BSR", "bsr_from_csr", "bsr_matvec_mrhs", "bsr_matvec_mrhs_plain"]


@dataclasses.dataclass
class BSR:
    """Block-sparse row format with a uniform per-row-block count (padded
    with zero blocks pointing at block-column 0)."""

    blocks: torch.Tensor       # (nblocks_rows, KB, BS, BS) dense blocks
    block_cols: torch.Tensor   # (nblocks_rows, KB) int32 block-column ids
    n: int                     # original size (rows == cols, padded to BS)
    bs: int                    # block size

    @property
    def nbr(self) -> int:
        return self.blocks.shape[0]

    @property
    def kb(self) -> int:
        return self.blocks.shape[1]


def bsr_from_csr(A, bs: int = 128, dtype=None, device="cuda") -> BSR:
    """Blockify a host CSR into uniform-KB BSR (zero-padded)."""
    dev = resolve_device(device)
    n = A.nrows
    nb = -(-n // bs)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    brow = rows // bs
    bcol = A.indices.astype(np.int64) // bs
    key = brow * nb + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    ub_row = (uniq // nb).astype(np.int64)
    ub_col = (uniq % nb).astype(np.int64)
    kb_counts = np.bincount(ub_row, minlength=nb)
    KB = max(int(kb_counts.max()) if uniq.size else 1, 1)
    zdt = A.data.dtype if dtype is None else dtype
    blocks = np.zeros((nb, KB, bs, bs), dtype=zdt)
    bcols = np.zeros((nb, KB), dtype=np.int32)
    order = np.argsort(ub_row, kind="stable")
    slot_of_uniq = np.empty(uniq.size, dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(kb_counts)[:-1]])
    slot_of_uniq[order] = np.arange(uniq.size) - start[ub_row[order]]
    bcols[ub_row, slot_of_uniq] = ub_col.astype(np.int32)
    blk = slot_of_uniq[inv]
    blocks[brow, blk, rows % bs, A.indices % bs] = A.data.astype(zdt)
    return BSR(torch.from_numpy(blocks).to(dev),
               torch.from_numpy(bcols).to(dev), n, bs)


def bsr_matvec_mrhs_plain(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A X for X of shape (nbr*bs, nrhs): gather the X
    slab of every block and contract block by block."""
    Xb = X.reshape(A.nbr, A.bs, -1)
    G = Xb[A.block_cols]                              # (nbr, KB, bs, nrhs)
    Y = torch.einsum("ikab,ikbj->iaj", A.blocks, G)
    return Y.reshape(A.nbr * A.bs, -1)


def bsr_spmv_cuda(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Launch K7; ``bsr_spmv_cuda.launches`` counts its launches."""
    nrhs = X.shape[1]
    Y = X.new_empty((A.nbr * A.bs, nrhs))
    if A.nbr == 0 or nrhs == 0:
        return Y
    fn = kernel_fn("bsr_spmv", A.blocks, A.block_cols, X, Y,
                   index_dtypes=(torch.int32,))
    err = fn(A.blocks.data_ptr(), A.block_cols.data_ptr(), X.data_ptr(),
             Y.data_ptr(), A.nbr, A.kb, A.bs, nrhs,
             torch.cuda.current_stream(X.device).cuda_stream)
    check(err, "bsr_spmv")
    bsr_spmv_cuda.launches += 1
    return Y


bsr_spmv_cuda.launches = 0


def bsr_matvec_mrhs(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for X of shape (nbr*bs, nrhs): kernel K7 for a CUDA tensor,
    the plain version for a CPU one."""
    if X.shape[0] != A.nbr * A.bs:
        raise ValueError(f"X has {X.shape[0]} rows, BSR needs {A.nbr * A.bs}")
    if X.device.type == "cpu":
        return bsr_matvec_mrhs_plain(A, X)
    return bsr_spmv_cuda(A, X.contiguous())
