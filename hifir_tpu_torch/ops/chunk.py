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

A :class:`SweepPlan` says how a factor's chunk loop runs on its mesh
(``form``): ``"sweep"`` (one group), ``"peer"`` (several groups whose
devices reach each other's memory: :func:`chunk_sweep_peer`, one
:class:`Sweep` a group, in which a group's operands are its ranks' share of
every chunk) or ``"chunk"`` (K10a a chunk, the legs as the mesh's copies).
The peer sweep runs on CPU tensors as :func:`chunk_sweep_peer_plain` (each
chunk's steps in every group, then the stores into the receiving groups'
vectors as torch copies) and on the card as ``csrc/kernels.cu:chunk_peer``
through :class:`PeerSweepKernel`: a cluster a group, one launch a card, the
stores through peer pointers and the steps ordered across groups by flags.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.build import check, dtype_suffix, kernel_fn, load_kernels

__all__ = ["chunk_fma_plain", "ChunkSweep", "Sweep", "chunk_sweep",
           "chunk_sweep_plain", "ChunkSweepKernel", "with_slack",
           "SweepPlan", "chunk_sweep_peer", "chunk_sweep_peer_plain",
           "PeerSweepKernel"]

# Bytes of storage a sweep operand keeps past its last element: the sweep's
# TMA copies move whole 16-byte lines.
SLACK = 16
# Stages of the sweep's ring (chunks of operands in shared memory ahead of
# the step); fewer when they do not fit, at least 2.
SWEEP_STAGES = 4
# Groups a peer sweep's table holds (``kernels.cu:kPeerMaxGroups``).
PEER_MAX_GROUPS = 16


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
        with torch.cuda.device(x.device):
            err = self.fn(x.data_ptr(), x.shape[1], out_off, out_step,
                          cols.data_ptr(), vals.data_ptr(), cloc * K, R,
                          cloc, K, self.pkg_ptr, self.stream)
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
                   chunk: int, ranks: Optional[int] = None) -> "Sweep":
        """The tiled-all_gather loop over ``cols``/``vals`` (nchunks, R,
        cloc, K) with chunks of ``chunk`` = ``ranks`` * cloc slots: the
        group's R ranks are all ``ranks`` (default) or, in a peer sweep,
        some of them."""
        nchunks, R, cloc, _ = cols.shape
        D = R if ranks is None else ranks
        if chunk != D * cloc or R > D:
            raise ValueError(f"chunk_sweep: a chunk of {chunk} slots is not "
                             f"{D} ranks x {cloc}: the groups must hold "
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
        self.K, self.kmax, self.wmax = _card_operands(sw)
        self.stages, self.smem = _fit_ring(sw, self.kmax, self.wmax)
        self.sw = sw
        self.fn = load_kernels().fn("chunk_sweep",
                                    dtype_suffix("chunk_sweep",
                                                 sw.vals.dtype))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sw = self.sw
        _check_card_x(x, sw)
        halo = sw.form == "halo"
        with torch.cuda.device(x.device):
            err = self.fn(
                x.data_ptr(), x.shape[1], sw.ranks, sw.nchunks, sw.cloc,
                self.K, sw.chunk, sw.cols.data_ptr(), sw.vals.data_ptr(),
                sw.sends.data_ptr() if halo else None,
                sw.desc.data_ptr() if halo else None, self.kmax, self.wmax,
                self.stages, torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "chunk_sweep")
        ChunkSweepKernel.launches += 1
        return x


def _card_operands(sw: Sweep):
    """Check a sweep's operands for the card (contiguous CUDA tensors on one
    device, int32 cols, cols and vals of one real dtype, int64 sends and
    records, each 16-byte aligned with :data:`SLACK` bytes of storage after
    it) and return its (K, widest fan-in, widest send run)."""
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
                             "storage after it (build it with with_slack)")
    if sw.min_len >= 2**31:
        raise ValueError("chunk_sweep: a rank's slots reach 2**31, beyond "
                         "the kernel's 32-bit indices")
    if halo:
        d = sw.desc_host
        return (0, int(d[:, 1].max()),
                int((d[:, 4] + d[:, 6] + d[:, 8]).max()))
    K = int(sw.cols.shape[3])
    return K, K, 0


def _fit_ring(sw: Sweep, kmax: int, wmax: int):
    """The most ring stages (at most :data:`SWEEP_STAGES`, at least 2) whose
    shared memory a CTA of ``sw``'s group may hold, and its bytes."""
    lib = load_kernels().lib
    room = lib.hifir_max_smem()
    es = sw.vals.element_size()
    need = {s: lib.chunk_sweep_smem(sw.ranks, sw.cloc, kmax, wmax, es,
                                    int(sw.form == "halo"), s)
            for s in range(SWEEP_STAGES, 1, -1)}
    fits = [s for s, b in need.items() if b <= room]
    if not fits:
        raise ValueError(
            f"chunk_sweep: a ring of 2 stages of {sw.cloc} slots x K {kmax} "
            f"(and {wmax} send coordinates) a rank needs {need[2]} bytes of "
            f"shared memory a CTA, more than the {room} a block may hold")
    return fits[0], need[fits[0]]


def _check_card_x(x: torch.Tensor, sw: Sweep) -> None:
    _check_sweep_x(x, sw)
    if x.device != sw.vals.device or not x.is_contiguous():
        raise ValueError(f"chunk_sweep: slot vectors must be contiguous on "
                         f"{sw.vals.device}, got {x.device}")
    if x.shape[1] >= 2**31:
        raise ValueError("chunk_sweep: a rank's slots reach 2**31, beyond "
                         "the kernel's 32-bit indices")


def chunk_sweep(x: torch.Tensor, sw: Sweep) -> torch.Tensor:
    """One factor's whole chunk loop, in place on the group's slot vectors
    ``x`` (ranks, L): the plain version for a CPU tensor, one launch of the
    redesigned K10a for a CUDA one (its checked entry kept on ``sw``)."""
    if x.device.type == "cpu":
        return chunk_sweep_plain(x, sw)
    if sw._kernel is None:
        sw._kernel = ChunkSweepKernel(sw)
    return sw._kernel(x)


@dataclasses.dataclass(eq=False)
class SweepPlan:
    """How one factor's chunk loop runs on its mesh, decided once when the
    factor is built (``parallel/trsv_sharded.py:loop_plan``): ``form``
    ``"sweep"`` (one group: :func:`chunk_sweep` on ``sweeps[0]``),
    ``"peer"`` (several groups that reach each other's memory:
    :func:`chunk_sweep_peer`) or ``"chunk"`` (K10a a chunk, the legs as the
    mesh's copies).  ``sweeps`` holds each group's share of the operands,
    ``lo`` each group's first rank and then the rank count."""

    form: str
    sweeps: List[Sweep]
    lo: Tuple[int, ...]
    _kernel: Optional["PeerSweepKernel"] = dataclasses.field(
        default=None, repr=False)


def chunk_sweep_peer_plain(xs: List[torch.Tensor],
                           plan: SweepPlan) -> List[torch.Tensor]:
    """Plain PyTorch peer sweep, in place on the groups' slot vectors
    ``xs`` (group g's (ranks, L) tensor): each chunk's step with K10a's
    plain arithmetic in every group, then the values each rank sends, taken
    into the receivers' vectors through the table ``plan.lo`` as torch
    copies (edge ranks with no sender receive zeros).
    ``chunk_sweep_peer_plain.calls`` counts its calls."""
    sws, lo = plan.sweeps, plan.lo
    for x, sw in zip(xs, sws, strict=True):
        _check_sweep_x(x, sw)
    chunk_sweep_peer_plain.calls += 1
    sw0 = sws[0]
    cloc = sw0.cloc
    if sw0.form == "all_gather":
        for c in range(sw0.nchunks):
            c0 = c * sw0.chunk
            pkgs = []
            for g, (x, sw) in enumerate(zip(xs, sws)):
                pkg = x.new_empty((sw.ranks, cloc))
                _chunk_fma(x, sw.cols[c], sw.vals[c], c0 + lo[g] * cloc,
                           cloc, pkg)
                pkgs.append(pkg)
            for x in xs:         # every rank's copy of the chunk
                x[:, c0:c0 + sw0.chunk] = torch.cat(
                    [p.to(x.device) for p in pkgs]).reshape(-1)
        return xs

    def legs(c, a, e):
        """Every rank's values at its send coordinates [a, e) of chunk c,
        (D, e - a) on each group's device."""
        pkgs = [x.gather(1, sw.halo_chunk(c)[2][:, a:e])
                for x, sw in zip(xs, sws)]
        return [torch.cat([p.to(x.device) for p in pkgs]) for x in xs]

    for c in range(sw0.nchunks):
        for x, sw in zip(xs, sws):
            cols, vals, _ = sw.halo_chunk(c)
            _chunk_fma(x, cols, vals, c * cloc)
        off_l, Wl, off_r, Wr, off_ag, Wag = sw0.desc_host[c, 3:9].tolist()
        if Wl:     # rank q receives rank q - 1's; rank 0 none
            for g, (x, full) in enumerate(zip(xs, legs(c, 0, Wl))):
                recv = torch.cat([full.new_zeros((1, Wl)), full[:-1]])
                x[:, off_l:off_l + Wl] = recv[lo[g]:lo[g + 1]]
        if Wr:     # rank q receives rank q + 1's; the last rank none
            for g, (x, full) in enumerate(zip(xs, legs(c, Wl, Wl + Wr))):
                recv = torch.cat([full[1:], full.new_zeros((1, Wr))])
                x[:, off_r:off_r + Wr] = recv[lo[g]:lo[g + 1]]
        if Wag:    # every rank receives every rank's
            for x, full in zip(xs, legs(c, Wl + Wr, Wl + Wr + Wag)):
                x[:, off_ag:off_ag + full.numel()] = full.reshape(-1)
    return xs


chunk_sweep_peer_plain.calls = 0


class PeerSweepKernel:
    """The peer sweep on the card for one :class:`SweepPlan` of the
    ``"peer"`` form.  Each group's operands are checked once (as
    :class:`ChunkSweepKernel` checks a sweep's), the ring's stages fitted
    to the largest group's CTAs, and each group gets G flag slots on its
    card (zeros; a launch's values are above every earlier one's, so they
    are never reset).  Each card gets one epoch counter in device memory
    (``epochs``, zero), which its launch bumps before the sweep reads it:
    the host arguments of a card's launch are the same at every call, so a
    launch captured in a CUDA graph replays as an eager call runs, and
    eager calls and replays may interleave.  Each call checks the groups'
    slot vectors, then launches once a card, every card's launch issued
    before anything waits: the groups on a card run as the clusters of its
    one launch.  ``PeerSweepKernel.launches`` counts the launches."""

    launches = 0

    def __init__(self, plan: SweepPlan):
        sws = self.sweeps = plan.sweeps
        G = len(sws)
        if not 1 < G <= PEER_MAX_GROUPS:
            raise ValueError(f"chunk_peer: {G} groups, the table holds 2 to "
                             f"{PEER_MAX_GROUPS}")
        dims = [_card_operands(sw) for sw in sws]
        if len({(sw.form, sw.nchunks, sw.cloc, sw.chunk, sw.min_len,
                 sw.vals.dtype) for sw in sws}) != 1:
            raise ValueError("chunk_peer: the groups' sweeps differ in form, "
                             "chunks, slots or dtype")
        self.K = dims[0][0]
        self.kmax = max(d[1] for d in dims)
        self.wmax = max(d[2] for d in dims)
        # the largest group's CTAs hold the most ranks
        self.stages, self.smem = _fit_ring(max(sws, key=lambda sw: sw.ranks),
                                           self.kmax, self.wmax)
        from ..parallel.mesh import device_index

        cards = [device_index(sw.vals.device) for sw in sws]
        self.flags = [torch.zeros(G, dtype=torch.int64, device=sw.vals.device)
                      for sw in sws]
        self.epochs = {card: torch.zeros(1, dtype=torch.int64,
                                         device=sws[cards.index(card)]
                                         .vals.device)
                       for card in dict.fromkeys(cards)}
        # the host arrays of the C entry: the table, then each card's groups
        self.lo = np.asarray(plan.lo, np.int32)
        self.cards = np.asarray(cards, np.int32)
        self.flagptr = np.array([f.data_ptr() for f in self.flags], np.int64)
        self.launch = []

        def ptr(ts):
            return np.array([0 if t is None else t.data_ptr() for t in ts],
                            np.int64)

        for card in dict.fromkeys(cards):
            loc = [g for g in range(G) if cards[g] == card]
            self.launch.append((card, np.asarray(loc, np.int32),
                                self.epochs[card].data_ptr(),
                                [ptr([sws[g].cols for g in loc]),
                                 ptr([sws[g].vals for g in loc]),
                                 ptr([sws[g].sends for g in loc]),
                                 ptr([sws[g].desc for g in loc])]))
        self.fn = load_kernels().fn("chunk_peer",
                                    dtype_suffix("chunk_peer",
                                                 sws[0].vals.dtype))

    def __call__(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        sws = self.sweeps
        if len(xs) != len(sws):
            raise ValueError(f"chunk_peer: {len(xs)} slot-vector groups for "
                             f"{len(sws)} groups")
        for x, sw in zip(xs, sws):
            _check_card_x(x, sw)
        if len({x.shape[1] for x in xs}) != 1:
            raise ValueError("chunk_peer: the groups' slot vectors differ "
                             "in length")
        xptr = np.array([x.data_ptr() for x in xs], np.int64)
        sw = sws[0]
        p = lambda a: a.ctypes.data  # noqa: E731
        for card, loc, epoch, (cols, vals, sends, desc) in self.launch:
            with torch.cuda.device(card):
                err = self.fn(
                    len(sws), p(xptr), p(self.flagptr), p(self.lo),
                    p(self.cards), xs[0].shape[1], len(loc), p(loc), p(cols),
                    p(vals), p(sends), p(desc), sw.nchunks, sw.cloc, self.K,
                    sw.chunk, self.kmax, self.wmax, self.stages,
                    int(sw.form == "halo"), epoch,
                    torch.cuda.current_stream(card).cuda_stream)
            check(err, f"chunk_peer on cuda:{card}")
            PeerSweepKernel.launches += 1
        return xs


def chunk_sweep_peer(xs: List[torch.Tensor],
                     plan: SweepPlan) -> List[torch.Tensor]:
    """One factor's whole chunk loop over several groups, in place on their
    slot vectors ``xs``: the plain version for CPU tensors, one launch a
    card of the peer sweep for CUDA ones (its checked entry kept on
    ``plan``)."""
    if all(x.device.type == "cpu" for x in xs):
        return chunk_sweep_peer_plain(xs, plan)
    if plan._kernel is None:
        plan._kernel = PeerSweepKernel(plan)
    return plan._kernel(xs)
