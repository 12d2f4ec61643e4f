"""Block-sparse (BSR) matrix times dense block.

The port of ``hifir_tpu/ops/pallas_spmv.py``: ``bsr_from_csr`` is copied as
it is; the product is kernel K7 (``csrc/kernels.cu:bsr_spmv``) on the card
and its plain PyTorch version, :func:`bsr_matvec_mrhs_plain`, on the CPU.
K7 has three paths, chosen by :func:`bsr_path`: DMMA tensor cores (f64) and
3xTF32 tensor cores (f32) for blocks of right-hand sides, and a streaming
kernel bound by the blocks' bytes for one or two.

K7 is real only, as the TPU kernel it replaces (Mosaic has no complex type):
the packer, the kernel's wrapper and the plain version all refuse complex
operands, so that the card and the CPU agree.  A complex operator goes as
sliced ELL (kernel K1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import check, kernel_fn

__all__ = ["BSR", "bsr_from_csr", "bsr_matvec_mrhs", "bsr_matvec_mrhs_plain",
           "bsr_path"]


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


def _real_only(dtype, what: str) -> None:
    """Raise TypeError for a complex dtype (numpy or torch)."""
    cplx = (dtype.is_complex if isinstance(dtype, torch.dtype)
            else np.issubdtype(np.dtype(dtype), np.complexfloating))
    if cplx:
        raise TypeError(f"{what}: K7 (BSR SpMV) is real only, as the TPU "
                        f"kernel it replaces; got {dtype}.  Pack a complex "
                        "operator as sliced ELL (kernel K1)")


def bsr_from_csr(A, bs: int = 128, dtype=None, device="cuda") -> BSR:
    """Blockify a host CSR into uniform-KB BSR (zero-padded); real dtypes
    only."""
    _real_only(A.data.dtype if dtype is None else dtype, "bsr_from_csr")
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
    slab of every block and contract block by block;
    ``bsr_matvec_mrhs_plain.calls`` counts its calls."""
    _real_only(X.dtype, "bsr_matvec_mrhs_plain")
    bsr_matvec_mrhs_plain.calls += 1
    Xb = X.reshape(A.nbr, A.bs, -1)
    G = Xb[A.block_cols]                              # (nbr, KB, bs, nrhs)
    Y = torch.einsum("ikab,ikbj->iaj", A.blocks, G)
    return Y.reshape(A.nbr * A.bs, -1)


bsr_matvec_mrhs_plain.calls = 0


# Widest block of right-hand sides that the streaming kernel takes; up to
# here it beat the tensor-core tile in both dtypes on the H100 at the main
# path's bs=128 (chip_smoke.py's K7 path sweep).
STREAM_MAX_NRHS = 2


def bsr_path(dtype: torch.dtype, nrhs: int) -> str:
    """K7's path for a block of ``nrhs`` right-hand sides: "stream" for
    narrow blocks, else the tensor cores, "dmma" (f64) or "tf32x3" (f32)."""
    if nrhs <= STREAM_MAX_NRHS:
        return "stream"
    return "dmma" if dtype == torch.float64 else "tf32x3"


def bsr_spmv_cuda(A: BSR, X: torch.Tensor, path: str = None) -> torch.Tensor:
    """Launch K7 on ``path`` (default :func:`bsr_path`);
    ``bsr_spmv_cuda.launches`` counts its launches.  ``path`` is there for
    chip_smoke.py, which times both sides of :func:`bsr_path`'s choice at
    1, 2 and 4 right-hand sides on every run, each checked against the
    plain version, so that ``STREAM_MAX_NRHS`` stays measured.  Safe inside
    a captured graph, as K1's wrapper is (the 16-byte test reads pointers
    that replays keep fixed)."""
    _real_only(X.dtype, "bsr_spmv")
    if X.shape[0] != A.nbr * A.bs:
        raise ValueError(f"X has {X.shape[0]} rows, BSR needs {A.nbr * A.bs}")
    nrhs = X.shape[1]
    Y = X.new_empty((A.nbr * A.bs, nrhs))
    if A.nbr == 0 or nrhs == 0:
        return Y
    fn = kernel_fn("bsr_spmv", index_dtypes=(torch.int32,), blocks=A.blocks,
                   block_cols=A.block_cols, X=X, Y=Y)
    path = path or bsr_path(X.dtype, nrhs)
    tensor = "dmma" if X.dtype == torch.float64 else "tf32x3"
    stream = path == "stream"
    if path not in ("stream", tensor):
        raise ValueError(f"bsr_spmv: path {path!r} for {X.dtype}: "
                         f"'stream' or {tensor!r}")
    if stream and nrhs > STREAM_MAX_NRHS:
        raise ValueError(f"bsr_spmv: the streaming path takes at most "
                         f"{STREAM_MAX_NRHS} right-hand sides, got {nrhs}")
    # 16-byte loads need 16-byte rows and base addresses in the blocks and
    # X (whose rows the tensor-core paths read 16 bytes at a time)
    v = 16 // X.element_size()
    vec = (A.bs % v == 0 and (stream or nrhs % v == 0)
           and all(t.data_ptr() % 16 == 0 for t in (A.blocks, X)))
    with torch.cuda.device(X.device):
        err = fn(A.blocks.data_ptr(), A.block_cols.data_ptr(),
                 X.data_ptr(), Y.data_ptr(), A.nbr, A.kb, A.bs, nrhs,
                 int(stream), int(vec),
                 torch.cuda.current_stream(X.device).cuda_stream)
    check(err, "bsr_spmv")
    bsr_spmv_cuda.launches += 1
    return Y


bsr_spmv_cuda.launches = 0


def bsr_matvec_mrhs(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for X of shape (nbr*bs, nrhs): kernel K7 for a CUDA tensor,
    the plain version for a CPU one."""
    if X.device.type == "cpu":
        if X.shape[0] != A.nbr * A.bs:
            raise ValueError(f"X has {X.shape[0]} rows, BSR needs "
                             f"{A.nbr * A.bs}")
        return bsr_matvec_mrhs_plain(A, X)
    return bsr_spmv_cuda(A, X.contiguous())
