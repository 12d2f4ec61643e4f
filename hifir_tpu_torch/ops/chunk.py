"""One chunk of a distributed level-scheduled triangular solve: kernel K10a.

The chunk step of the JAX package's distributed solves
(``hifir_tpu/parallel/trsv_halo.py:halo_op_kernel``,
``prec_sharded.py:ag_op_kernel``, ``trsv_sharded.py:_kernel``): every rank
updates its slice of the chunk, ``x[own] -= sum_k vals * x[cols]``.  Here
the ranks that share a device keep their working vectors as the rows of one
tensor ``x`` (R, L), and one call updates all of them:

    x[r, out_off + r * out_step + j] -= sum_k vals[r, j, k] * x[r, cols[r, j, k]]

for r < R and j < cloc, with ``cols`` and ``vals`` of shape (R, cloc, K)
(``out_step`` 0: each rank's own slots at ``out_off``, the halo layout;
``out_step = cloc``: rank r's slice of a replicated chunk, the all_gather
layout).  With a package buffer ``pkg`` (R, cloc) the new values go there
too: the tiled all_gather's send buffer (the JAX kernel's
``cur - contrib``).  Padded entries point at a zero slot with value 0.
Kernel K10a (``csrc/kernels.cu:chunk_fma``) on the card, the plain version
on the CPU, float32 and float64.

:class:`ChunkSweep` is the one entry: a solve runs thousands of chunks on one
buffer, so it checks the buffer once and each launch only its chunk's
operands.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.build import check, dtype_suffix, kernel_fn, load_kernels

__all__ = ["chunk_fma_plain", "ChunkSweep"]


def _check(x, cols, vals, out_off, out_step, pkg=None):
    if x.dim() != 2 or cols.dim() != 3 or vals.shape != cols.shape:
        raise ValueError(f"chunk_fma: x {tuple(x.shape)}, cols "
                         f"{tuple(cols.shape)}, vals {tuple(vals.shape)}")
    R, cloc, _ = cols.shape
    if x.shape[0] != R:
        raise ValueError(f"chunk_fma: x has {x.shape[0]} ranks, cols {R}")
    if pkg is not None and tuple(pkg.shape) != (R, cloc):
        raise ValueError(f"chunk_fma: pkg is {tuple(pkg.shape)}, expected "
                         f"{(R, cloc)}")
    last = out_off + (R - 1) * out_step + cloc
    if R and (out_off < 0 or last > x.shape[1]):
        raise ValueError(f"chunk_fma: slots up to {last} outside the "
                         f"{x.shape[1]}-slot vector")


def chunk_fma_plain(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                    out_off: int, out_step: int = 0,
                    pkg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K10a, in place on ``x`` (and ``pkg``);
    ``chunk_fma_plain.calls`` counts its calls."""
    _check(x, cols, vals, out_off, out_step, pkg)
    chunk_fma_plain.calls += 1
    R, cloc, K = cols.shape
    g = x.gather(1, cols.reshape(R, cloc * K).long()).view(R, cloc, K)
    contrib = (vals * g).sum(-1)
    pos = (out_off + out_step * torch.arange(R, device=x.device)[:, None]
           + torch.arange(cloc, device=x.device))
    y = x.gather(1, pos) - contrib
    x.scatter_(1, pos, y)
    if pkg is not None:
        pkg.copy_(y)
    return x


chunk_fma_plain.calls = 0


class ChunkSweep:
    """K10a on the rows of one working-vector buffer ``x`` (R, L), and the
    package buffer ``pkg`` (R, cloc) when given, for chunk after chunk.

    The buffers are checked once, as :func:`~hifir_tpu_torch.kernels.build.
    kernel_fn` checks a launch's operands (a contiguous CUDA tensor of a
    dtype the kernel is built for, no lazy conjugate or negative bit);
    each call then checks its chunk's ``cols`` (int32) and ``vals`` (x's
    dtype): device, dtype, contiguity and shape.  On a CPU tensor every call
    runs the plain version.  ``ChunkSweep.launches`` counts K10a's
    launches."""

    launches = 0

    def __init__(self, x: torch.Tensor, pkg: Optional[torch.Tensor] = None):
        self.x, self.pkg = x, pkg
        self.cpu = x.device.type == "cpu"
        if self.cpu:
            return
        bufs = dict(x=x) if pkg is None else dict(x=x, pkg=pkg)
        kernel_fn("chunk_fma", index_dtypes=(), **bufs)
        if x.shape[1] >= 2**31:
            raise ValueError("chunk_fma: a rank's slots reach 2**31, beyond "
                             "K10a's 32-bit indices")
        self.fn = load_kernels().fn("chunk_fma",
                                    dtype_suffix("chunk_fma", x.dtype))
        self.stream = torch.cuda.current_stream(x.device).cuda_stream
        self.pkg_ptr = None if pkg is None else pkg.data_ptr()

    def __call__(self, cols: torch.Tensor, vals: torch.Tensor, out_off: int,
                 out_step: int = 0) -> torch.Tensor:
        x = self.x
        if self.cpu:
            return chunk_fma_plain(x, cols, vals, out_off, out_step,
                                   self.pkg)
        if (cols.dtype != torch.int32 or vals.dtype != x.dtype
                or cols.device != x.device or vals.device != x.device
                or not (cols.is_contiguous() and vals.is_contiguous())):
            raise ValueError(
                f"chunk_fma: cols ({cols.dtype}, {cols.device}) and vals "
                f"({vals.dtype}, {vals.device}) must be contiguous int32 "
                f"and {x.dtype} on {x.device}")
        _check(x, cols, vals, out_off, out_step, self.pkg)
        R, cloc, K = cols.shape
        err = self.fn(x.data_ptr(), x.shape[1], out_off, out_step,
                      cols.data_ptr(), vals.data_ptr(), cloc * K, R, cloc, K,
                      self.pkg_ptr, self.stream)
        check(err, "chunk_fma")
        ChunkSweep.launches += 1
        return x

