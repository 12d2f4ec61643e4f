"""Captured CUDA graphs: the port's counterpart of the JAX package's jit layer.

The JAX package compiles every ``DevicePrec`` solve and product
(``hifir_tpu/alg/prec.py:406-546``), HIFIR and each GMRES restart cycle
(``hifir_tpu/solvers/gmres.py:27-264``) with ``jax.jit``: one device program
a call, with static shapes.  In PyTorch such a program is a CUDA graph:
captured once, then replayed, every kernel of it launched by the device
without a trip through Python.

A :class:`GraphCache` belongs to one pack (a
:class:`~hifir_tpu_torch.alg.prec.DevicePrec` or a
:class:`~hifir_tpu_torch.parallel.DistPrec`) or one mesh (a
:class:`~hifir_tpu_torch.parallel.Mesh`, for the distributed trsv and SpMV
applies, the sharded IR step and the ring Schur step: the JAX package's
distributed jit sites); its graphs share one memory pool and are never
replayed concurrently.  Its programs are keyed like a jit cache: the
callable (the adjoint solve is a callable of its own), the identity of
every operand (lists of levels, a tail, an operator), and the shape, dtype
and device of every tensor (a list of tensors, a distributed value with
one tensor a group, item by item) or the value of every static argument (a
rank ``r``, ``nirs``, a segment's steps).  Two kinds:

- :meth:`GraphCache.call`, the jit-like call: the caller's tensors are
  copied into the program's static input buffers and the result comes back
  as a fresh tensor, never the static output, which the next replay
  overwrites;
- :meth:`GraphCache.step`, a program over persistent tensors that it reads
  and writes in place (a GMRES cycle's state, which lives outside the pool).

The first call of a key runs the program eagerly on a side stream (the
warm-up: the kernels' library is built and loaded, shared-memory limits are
raised, cuBLAS sets up its workspaces, all outside the graph) and returns
that run's result; then the program is captured.  Every later call replays.
A capture that fails raises :class:`GraphCaptureError`, naming the
program; nothing runs eagerly in its place.

The kernels count their launches in Python, which a replay does not run:
a capture records what each counter gained while the program was captured
(and takes it back, since nothing ran), and each replay adds it to the
counters it moved.  The cache's phases are spans of
:mod:`~hifir_tpu_torch.trace` (``hifir.graph.*``: the first call's warm-up
and capture, each call's key, input copy, replay and output clone), and
:meth:`GraphCache.call` counts the bytes it copies in and out
(``graph.copy_bytes``).

The backend follows the owner's devices (:func:`cache_of`): every device
on one card (a pack, a mesh whose groups all live on one card) is
:class:`CudaGraphs`, one graph and one pool; a mesh over several cards is
:class:`MultiCardGraphs`, one capture on the first card's stream that forks
every other card's stream through events, so that one graph holds the
nodes of every card, the copies between them included.

On a device without a capture backend (the CPU) :func:`cache_of` returns
None and the callers run their eager code.  A program that cannot take an
object raises :class:`GraphRefused` (the GMRES cycles given a
``DistPrec``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch

from .trace import add, launch_counters, span

__all__ = ["GraphCache", "GraphCaptureError", "GraphRefused", "CudaGraphs",
           "MultiCardGraphs", "BACKENDS", "cache_of", "jit",
           "read_counters"]


class GraphCaptureError(RuntimeError):
    """A program could not be captured as a CUDA graph."""


class GraphRefused(TypeError):
    """An object that cannot run inside a captured graph was handed to one."""


def read_counters() -> tuple:
    """The kernels' launch counters, in
    :func:`~hifir_tpu_torch.trace.launch_counters` order."""
    return tuple(getattr(o, a) for o, a, _ in launch_counters())


def _set_counters(values) -> None:
    for (o, a, _), v in zip(launch_counters(), values):
        setattr(o, a, v)


class CudaGraphs:
    """Capture and replay on one CUDA device: a side stream for the
    warm-ups and the captures, and one graph memory pool (``pool``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def warm(self, fn, args):
        """One eager run of ``fn(*args)`` on the side stream, ordered after
        the caller's stream's work and before its later work."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = fn(*args)
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn, args):
        """Capture ``fn(*args)``; returns the graph and its static output."""
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn(*args)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass    # the capture is already void; re-raise the cause
                raise
            graph.capture_end()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


class MultiCardGraphs(CudaGraphs):
    """Capture and replay of a program over several cards (a mesh whose
    groups live on more than one card) as one graph: a side stream a card
    and one pool id, the first card's the capture's own and every other
    card's allocations of the capturing thread routed to a pool of the same
    id on that card.

    The warm-up and the capture make every card's side stream its current
    stream, forked from the first card's (in the capture: an event recorded
    on the capturing stream, which each other stream waits for, so that it
    joins the capture) and joined back at the end.  Every kernel wrapper
    launches on its device's current stream and a copy between cards is
    issued on the current streams of both ends, so every launch and copy of
    the program lands in the graph.  A replay launches the graph on the
    first card's current stream, ordered after every card's current
    stream's earlier work and before its later work (events, no host
    wait)."""

    def __init__(self, cards):
        self.cards = [int(c) for c in cards]
        super().__init__(torch.device("cuda", self.cards[0]))
        self.streams = [self.stream] + [torch.cuda.Stream(c)
                                        for c in self.cards[1:]]
        self.routed = set()

    @contextlib.contextmanager
    def _current(self, fork):
        """Every card's side stream current (the first card's current device
        too); ``fork`` before and join after, as the first card's side
        stream waits for them."""
        lead = self.stream
        prev = [torch.cuda.current_stream(c) for c in self.cards]
        with torch.cuda.device(self.cards[0]):
            fork(prev)
            try:
                for s in self.streams:
                    torch.cuda.set_stream(s)
                torch.cuda.set_device(self.cards[0])
                yield
                for s in self.streams[1:]:
                    lead.wait_stream(s)
            finally:
                for s in prev:
                    torch.cuda.set_stream(s)
                torch.cuda.set_device(self.cards[0])

    def warm(self, fn, args):
        def fork(prev):
            for s, p in zip(self.streams, prev):
                s.wait_stream(p)

        with self._current(fork):
            out = fn(*args)
        for p in [torch.cuda.current_stream(c) for c in self.cards]:
            p.wait_stream(self.stream)
        return out

    def capture(self, fn, args):
        for c in self.cards:
            torch.cuda.synchronize(c)
        graph = torch.cuda.CUDAGraph()
        lead = self.stream

        def fork(prev):
            for s in self.streams[1:]:
                s.wait_stream(lead)

        with torch.cuda.device(self.cards[0]), torch.cuda.stream(lead):
            graph.capture_begin(pool=self.pool)
            try:
                for c in self.cards[1:]:
                    torch._C._cuda_beginAllocateCurrentThreadToPool(
                        c, self.pool)
                    self.routed.add(c)
                try:
                    with self._current(fork):
                        out = fn(*args)
                finally:
                    for c in self.cards[1:]:
                        torch._C._cuda_endAllocateToPool(c, self.pool)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass    # the capture is already void; re-raise the cause
                raise
            graph.capture_end()
        return graph, out

    def replay(self, graph) -> None:
        with torch.cuda.device(self.cards[0]):
            cur = [torch.cuda.current_stream(c) for c in self.cards]
            for s in cur[1:]:
                cur[0].wait_stream(s)
            CudaGraphs.replay(self, graph)
            for s in cur[1:]:
                s.wait_stream(cur[0])

    def __del__(self):
        # the other cards' pools outlive nothing that uses them
        for c in getattr(self, "routed", ()):
            try:
                torch._C._cuda_releasePool(c, self.pool)
            except Exception:
                pass


# the capture backend of each device type; a type without one runs eagerly
# (an owner whose devices span several cards takes MultiCardGraphs)
BACKENDS = {"cuda": CudaGraphs}


@dataclasses.dataclass
class _Entry:
    graph: object
    out: object       # the static output (overwritten by every replay)
    args: tuple       # the static inputs and the operands, kept alive
    delta: tuple      # what one run adds to each launch counter
    moved: tuple      # (wrapper, attribute, gain) of the counters it moves
    seconds: float = 0.0  # the first call's host seconds: warm-up, capture


def _tensors(a) -> bool:
    """A list of tensors (a distributed value: one tensor a group)."""
    return (isinstance(a, list) and len(a) > 0
            and all(torch.is_tensor(t) for t in a))


def _spec(a, by_shape: bool):
    """A key item: tensors by shape, dtype and device (``by_shape``) or by
    identity, a list of tensors item by item, static values by value, any
    other object by identity."""
    if torch.is_tensor(a):
        return (("t", tuple(a.shape), a.dtype, a.device) if by_shape
                else ("o", id(a)))
    if _tensors(a):
        return ("l",) + tuple(_spec(t, by_shape) for t in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device)):
        return ("v", type(a), a)
    return ("o", id(a))


def _fresh(out):
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_fresh(o) for o in out)
    return out


def _copy_in(static, a) -> None:
    """The caller's tensor (or list of tensors) ``a`` into the program's
    static input."""
    if torch.is_tensor(a):
        static.copy_(a)
    elif _tensors(a):
        for s, t in zip(static, a, strict=True):
            s.copy_(t)


def _nbytes(a) -> int:
    """Bytes of a tensor, a list of tensors or a tuple of either."""
    if torch.is_tensor(a):
        return a.nbytes
    if isinstance(a, tuple) or _tensors(a):
        return sum(_nbytes(t) for t in a)
    return 0


def _name(fn) -> str:
    return getattr(fn, "__qualname__", repr(fn))


class GraphCache:
    """The captured programs of one pack (see the module docstring);
    ``entries`` by key, ``workspaces`` the persistent state that
    :meth:`step` programs run on."""

    def __init__(self, backend):
        self.backend = backend
        self.entries = {}
        self.workspaces = {}

    def call(self, fn, *args):
        """``fn(*args)`` as a replay of its captured graph: the tensors of
        ``args`` are copied into the program's static inputs; the result
        is a fresh tensor (or tuple of them).  The bytes of both copies
        count in ``graph.copy_bytes``."""
        with span("hifir.graph.call"):
            with span("hifir.graph.key"):
                key = (fn,) + tuple(_spec(a, True) for a in args)
                ent = self.entries.get(key)
            if ent is None:
                static = tuple(_fresh(a) if torch.is_tensor(a) or _tensors(a)
                               else a for a in args)
                out = self._first(key, fn, static)
            else:
                with span("hifir.graph.copy_in"):
                    for s, a in zip(ent.args, args):
                        _copy_in(s, a)
                with span("hifir.graph.replay"):
                    out = self._replay(ent)
            with span("hifir.graph.out"):
                out = _fresh(out)
            add("graph.copy_bytes", _nbytes(args) + _nbytes(out))
            return out

    def step(self, fn, *args) -> None:
        """``fn(*args)`` on persistent tensors, read and written in place
        (they must outlive the cache's use of them; see
        :meth:`workspace`)."""
        with span("hifir.graph.step"):
            key = (fn,) + tuple(_spec(a, False) for a in args)
            ent = self.entries.get(key)
            if ent is None:
                self._first(key, fn, args)
            else:
                with span("hifir.graph.replay"):
                    self._replay(ent)

    def workspace(self, make, *args):
        """``make(*args)``, made once for each (make, args) key and kept:
        the persistent state of :meth:`step` programs (``args`` are
        static values: sizes, a dtype, a device)."""
        key = (make,) + tuple(_spec(a, False) for a in args)
        if key not in self.workspaces:
            self.workspaces[key] = make(*args)
        return self.workspaces[key]

    def drop(self, obj) -> None:
        """Forget the programs keyed on the operand ``obj`` (a pack's
        operand list that is being replaced)."""
        item = ("o", id(obj))
        for key in [k for k in self.entries if item in k[1:]]:
            del self.entries[key]

    def _first(self, key, fn, args):
        with span("hifir.graph.first") as first:
            with span("hifir.graph.warm"):
                out = self.backend.warm(fn, args)
            before = read_counters()
            try:
                with span("hifir.graph.capture"):
                    graph, static_out = self.backend.capture(fn, args)
            except Exception as e:
                raise GraphCaptureError(
                    f"capture of {_name(fn)} failed: {type(e).__name__}: "
                    f"{e}") from e
            finally:
                delta = tuple(a - b for a, b in zip(read_counters(), before))
                _set_counters(before)
            moved = tuple((o, a, d) for (o, a, _), d
                          in zip(launch_counters(), delta) if d)
            ent = self.entries[key] = _Entry(graph, static_out, args, delta,
                                             moved)
        ent.seconds = first.seconds
        return out

    def _replay(self, ent: _Entry):
        self.backend.replay(ent.graph)
        for o, a, d in ent.moved:
            setattr(o, a, getattr(o, a) + d)
        return ent.out


def _backend(devices):
    """The maker of the capture backend for an owner on ``devices``, or
    None where they run eagerly (a device type without a backend, or
    devices of several types)."""
    types = {d.type for d in devices}
    make = BACKENDS.get(devices[0].type) if len(types) == 1 else None
    if make is None or devices[0].type != "cuda":
        return None if make is None else functools.partial(make, devices[0])
    from .parallel.mesh import device_index

    cards = list(dict.fromkeys(device_index(d) for d in devices))
    if len(cards) > 1:
        return functools.partial(MultiCardGraphs, cards)
    return functools.partial(make, torch.device("cuda", cards[0]))


def cache_of(prec) -> Optional[GraphCache]:
    """The graph cache of a pack or a mesh (made at first use), or None
    when its programs run eagerly: ``prec.graphs`` is off, or its devices
    have no capture backend.  The devices are ``prec.devices`` (a mesh's
    ranks', a ``DistPrec``'s) or ``prec.device``."""
    if not getattr(prec, "graphs", False):
        return None
    make = _backend(tuple(getattr(prec, "devices", None) or (prec.device,)))
    if make is None:
        return None
    if prec.graph_cache is None:
        prec.graph_cache = GraphCache(make())
    return prec.graph_cache


def jit(prec, fn):
    """``fn`` compiled against ``prec``'s cache (a pack's or a mesh's), as
    ``jax.jit(fn)`` is: ``jit(prec, fn)(*args)`` is
    :meth:`GraphCache.call`, or ``fn(*args)`` where the owner runs
    eagerly."""
    @functools.wraps(fn)
    def compiled(*args):
        cache = cache_of(prec)
        return fn(*args) if cache is None else cache.call(fn, *args)

    return compiled
