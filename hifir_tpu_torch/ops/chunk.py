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

:class:`ChunkSweep` is K10a's one entry: a solve runs thousands of chunks on
one buffer, so it checks the buffer once and each launch only its chunk's
operands.  A mesh whose ``rows`` ranks lie on several devices runs it, a
chunk a launch, with the exchange legs as peer copies between launches.

:class:`Sweep` is one factor's whole chunk loop on a group that holds every
rank of the ``rows`` axis (all on one device), in either form:

- ``all_gather``: ``cols``/``vals`` (nchunks, R, cloc, K); chunk c's step
  writes rank r's slots ``c * chunk + r * cloc + j`` into every rank's copy
  (the tiled all_gather);
- ``halo``: ``cols``/``vals`` flat, chunk c's (R, cloc, K_c) block at the
  16-byte aligned offset ``coff``; the step writes rank r's own slots
  ``c * cloc + j``, then the legs of the chunk's ``meta`` (off_l, Wl,
  off_r, Wr, off_ag, Wag) carry the values at rank r's send coordinates
  (``sends``, flat int64, chunk c's (R, Wl + Wr + Wag) block at ``soff``)
  to rank r + 1 at off_l, rank r - 1 at off_r and every rank at
  ``off_ag + r * Wag``.  ``desc`` (nchunks, 10) int64 holds each chunk's
  record ``(coff, K_c, soff, off_l, Wl, off_r, Wr, off_ag, Wag, 0)``.

:func:`chunk_sweep` runs it in place on the group's slot vectors: on a CPU
tensor :func:`chunk_sweep_plain` (the chunk steps with K10a's plain
arithmetic and the legs as torch copies), on a CUDA tensor one launch of
the redesigned K10a (``csrc/kernels.cu:chunk_sweep``, one thread block
cluster a group, the legs inside) through :class:`ChunkSweepKernel`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.build import check, dtype_suffix, kernel_fn, load_kernels

__all__ = ["chunk_fma_plain", "ChunkSweep", "Sweep", "chunk_sweep",
           "chunk_sweep_plain", "ChunkSweepKernel", "with_slack"]

# Bytes of storage a sweep operand keeps past its last element: the sweep's
# TMA copies move whole 16-byte lines.
SLACK = 16
# Stages of the sweep's ring (chunks of operands in shared memory ahead of
# the step); fewer when they do not fit, at least 2.
SWEEP_STAGES = 4


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
    return _chunk_fma(x, cols, vals, out_off, out_step, pkg)


def _chunk_fma(x, cols, vals, out_off, out_step=0, pkg=None):
    """K10a's plain arithmetic, unchecked and uncounted (the sweep's plain
    version steps through it)."""
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


def with_slack(a, dtype=None, device="cpu") -> torch.Tensor:
    """``a`` as a contiguous tensor on ``device`` whose storage runs
    :data:`SLACK` bytes (zeros) past its last element, as a sweep operand
    must."""
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    pad = -(-SLACK // t.element_size())
    flat = torch.zeros(t.numel() + pad, dtype=t.dtype, device=device)
    flat[:t.numel()].copy_(t.reshape(-1))
    return flat[:t.numel()].view(t.shape)


@dataclasses.dataclass(eq=False)
class Sweep:
    """One triangular factor's chunk loop on a group of ``ranks`` ranks that
    is the whole ``rows`` axis (see the module docstring for the forms).
    ``min_len`` is the slot-vector length the loop reaches (its last slot
    the zero slot)."""

    form: str                      # "all_gather" or "halo"
    ranks: int
    nchunks: int
    cloc: int
    cols: torch.Tensor             # int32
    vals: torch.Tensor
    min_len: int
    chunk: int = 0                 # all_gather: slots a chunk
    sends: Optional[torch.Tensor] = None     # halo: flat int64
    desc: Optional[torch.Tensor] = None      # halo: (nchunks, 10) int64
    desc_host: Optional[np.ndarray] = None   # halo: desc on the host
    _kernel: Optional["ChunkSweepKernel"] = dataclasses.field(
        default=None, repr=False)

    @classmethod
    def all_gather(cls, cols: torch.Tensor, vals: torch.Tensor,
                   chunk: int) -> "Sweep":
        """The tiled-all_gather loop over ``cols``/``vals`` (nchunks, R,
        cloc, K) with chunks of ``chunk`` = R * cloc slots."""
        nchunks, R, cloc, _ = cols.shape
        if chunk != R * cloc:
            raise ValueError(f"chunk_sweep: a chunk of {chunk} slots is not "
                             f"{R} ranks x {cloc}: the group must hold "
                             "every rank")
        return cls("all_gather", R, nchunks, cloc, cols, vals,
                   nchunks * chunk + 1, chunk=chunk)

    def halo_chunk(self, c: int):
        """Chunk c's (ranks, cloc, K_c) cols and vals and (ranks, Wl + Wr +
        Wag) send coordinates: views of the packed buffers (halo form)."""
        coff, K, soff, _, Wl, _, Wr, _, Wag, _ = self.desc_host[c].tolist()
        R, n = self.ranks, self.ranks * self.cloc * K
        return (self.cols[coff:coff + n].view(R, self.cloc, K),
                self.vals[coff:coff + n].view(R, self.cloc, K),
                self.sends[soff:soff + R * (Wl + Wr + Wag)]
                .view(R, Wl + Wr + Wag))

    def tensors(self):
        """The sweep's operands (for byte counts)."""
        return [t for t in (self.cols, self.vals, self.sends, self.desc)
                if t is not None]


def chunk_sweep_plain(x: torch.Tensor, sw: Sweep) -> torch.Tensor:
    """Plain PyTorch chunk loop, in place on the group's slot vectors ``x``
    (ranks, L): each chunk's step with K10a's plain arithmetic, then its
    exchange as the mesh's torch copies do it (edge ranks with no sender
    receive zeros).  ``chunk_sweep_plain.calls`` counts its calls."""
    _check_sweep_x(x, sw)
    chunk_sweep_plain.calls += 1
    R, cloc = sw.ranks, sw.cloc
    if sw.form == "all_gather":
        pkg = x.new_empty((R, cloc))
        for c in range(sw.nchunks):
            c0 = c * sw.chunk
            _chunk_fma(x, sw.cols[c], sw.vals[c], c0, cloc, pkg)
            x[:, c0:c0 + sw.chunk].copy_(pkg.reshape(-1))
        return x
    for c in range(sw.nchunks):
        cols, vals, s = sw.halo_chunk(c)
        off_l, Wl, off_r, Wr, off_ag, Wag = sw.desc_host[c, 3:9].tolist()
        _chunk_fma(x, cols, vals, c * cloc)
        if Wl:     # to the right neighbour; rank 0 has no sender
            pkg = x.gather(1, s[:, :Wl])
            x[1:, off_l:off_l + Wl] = pkg[:-1]
            x[:1, off_l:off_l + Wl] = 0
        if Wr:     # to the left neighbour; the last rank has no sender
            pkg = x.gather(1, s[:, Wl:Wl + Wr])
            x[:-1, off_r:off_r + Wr] = pkg[1:]
            x[-1:, off_r:off_r + Wr] = 0
        if Wag:    # the compact all_gather
            pkg = x.gather(1, s[:, Wl + Wr:])
            x[:, off_ag:off_ag + R * Wag].copy_(pkg.reshape(-1))
    return x


chunk_sweep_plain.calls = 0


def _check_sweep_x(x, sw):
    if x.dim() != 2 or x.shape[0] != sw.ranks or x.shape[1] < sw.min_len:
        raise ValueError(f"chunk_sweep: slot vectors {tuple(x.shape)}, "
                         f"expected ({sw.ranks}, >= {sw.min_len})")
    if x.dtype != sw.vals.dtype:
        raise TypeError(f"chunk_sweep: slot vectors are {x.dtype}, the "
                        f"factor {sw.vals.dtype}")


def _tail_room(t: torch.Tensor) -> int:
    """Bytes of ``t``'s storage past its last element."""
    st = t.untyped_storage()
    return (st.data_ptr() + st.nbytes()
            - (t.data_ptr() + t.numel() * t.element_size()))


class ChunkSweepKernel:
    """The redesigned K10a for one :class:`Sweep` on the card: its operands
    are checked once (contiguous CUDA tensors on one device, int32 cols,
    cols and vals of one real dtype, int64 sends and records, each 16-byte
    aligned with :data:`SLACK` bytes of storage after it), and the ring's
    stages are fitted to the shared memory; each call checks the slot
    vectors and launches the whole chunk loop once.  The halo regions of
    ``x`` must hold zeros (edge ranks keep them).
    ``ChunkSweepKernel.launches`` counts its launches."""

    launches = 0

    def __init__(self, sw: Sweep):
        halo = sw.form == "halo"
        ops = dict(cols=sw.cols, vals=sw.vals)
        idx = (torch.int32,)
        if halo:
            ops.update(sends=sw.sends, desc=sw.desc)
            idx += (torch.int64, torch.int64)
        kernel_fn("chunk_sweep", index_dtypes=idx, **ops)
        for k, t in ops.items():
            if t.data_ptr() % 16:
                raise ValueError(f"chunk_sweep: {k} is not 16-byte aligned")
            if k != "desc" and _tail_room(t) < SLACK:
                raise ValueError(f"chunk_sweep: {k} needs {SLACK} bytes of "
                                 "storage after it (build it with "
                                 "with_slack)")
        if sw.min_len >= 2**31:
            raise ValueError("chunk_sweep: a rank's slots reach 2**31, "
                             "beyond the kernel's 32-bit indices")
        if halo:
            d = sw.desc_host
            self.K = 0
            self.kmax = int(d[:, 1].max())
            self.wmax = int((d[:, 4] + d[:, 6] + d[:, 8]).max())
        else:
            self.K = self.kmax = int(sw.cols.shape[3])
            self.wmax = 0
        lib = load_kernels().lib
        room = lib.hifir_max_smem()
        es = sw.vals.element_size()
        need = {s: lib.chunk_sweep_smem(sw.ranks, sw.cloc, self.kmax,
                                        self.wmax, es, int(halo), s)
                for s in range(SWEEP_STAGES, 1, -1)}
        fits = [s for s, b in need.items() if b <= room]
        if not fits:
            raise ValueError(
                f"chunk_sweep: a ring of 2 stages of {sw.cloc} slots x K "
                f"{self.kmax} (and {self.wmax} send coordinates) a rank "
                f"needs {need[2]} bytes of shared memory a CTA, more than "
                f"the {room} a block may hold")
        self.stages = fits[0]
        self.smem = need[self.stages]
        self.sw = sw
        self.fn = load_kernels().fn("chunk_sweep",
                                    dtype_suffix("chunk_sweep",
                                                 sw.vals.dtype))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sw = self.sw
        _check_sweep_x(x, sw)
        if x.device != sw.vals.device or not x.is_contiguous():
            raise ValueError(f"chunk_sweep: slot vectors must be contiguous "
                             f"on {sw.vals.device}, got {x.device}")
        if x.shape[1] >= 2**31:
            raise ValueError("chunk_sweep: a rank's slots reach 2**31, "
                             "beyond the kernel's 32-bit indices")
        halo = sw.form == "halo"
        err = self.fn(
            x.data_ptr(), x.shape[1], sw.ranks, sw.nchunks, sw.cloc, self.K,
            sw.chunk, sw.cols.data_ptr(), sw.vals.data_ptr(),
            sw.sends.data_ptr() if halo else None,
            sw.desc.data_ptr() if halo else None, self.kmax, self.wmax,
            self.stages, torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "chunk_sweep")
        ChunkSweepKernel.launches += 1
        return x


def chunk_sweep(x: torch.Tensor, sw: Sweep) -> torch.Tensor:
    """One factor's whole chunk loop, in place on the group's slot vectors
    ``x`` (ranks, L): the plain version for a CPU tensor, one launch of the
    redesigned K10a for a CUDA one (its checked entry kept on ``sw``)."""
    if x.device.type == "cpu":
        return chunk_sweep_plain(x, sw)
    if sw._kernel is None:
        sw._kernel = ChunkSweepKernel(sw)
    return sw._kernel(x)
