"""Captured CUDA graphs: the port's counterpart of the JAX package's jit layer.

The JAX package compiles every ``DevicePrec`` solve and product
(``hifir_tpu/alg/prec.py:406-546``), HIFIR and each GMRES restart cycle
(``hifir_tpu/solvers/gmres.py:27-264``) with ``jax.jit``: one device program
a call, with static shapes.  In PyTorch such a program is a CUDA graph:
captured once, then replayed, every kernel of it launched by the device
without a trip through Python.

A :class:`GraphCache` belongs to one pack (a
:class:`~hifir_tpu_torch.alg.prec.DevicePrec`); its graphs share one memory
pool and are never replayed concurrently.  Its programs are keyed like a
jit cache: the callable (the adjoint solve is a callable of its own), the
identity of every operand (lists of levels, a tail, an operator), and the
shape, dtype and device of every tensor or the value of every static
argument (a rank ``r``, ``nirs``, a segment's steps).  Two kinds:

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
(and takes it back, since nothing ran), and each replay adds it.

Objects that cannot be captured carry a ``graph_refusal`` attribute that
says why (``DistPrec``, ``PartitionedHIF``, the sharded IR step); handed to
a cache they raise :class:`GraphRefused` with that reason.  On a device
without a capture backend (the CPU) :func:`cache_of` returns None and the
callers run their eager code.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import torch

__all__ = ["GraphCache", "GraphCaptureError", "GraphRefused", "CudaGraphs",
           "BACKENDS", "cache_of", "jit", "refuse", "read_counters"]


class GraphCaptureError(RuntimeError):
    """A program could not be captured as a CUDA graph."""


class GraphRefused(TypeError):
    """An object that cannot run inside a captured graph was handed to one."""


def _counters():
    from .ops import bsr_spmv, spmv, trsv

    return ((spmv.sell_spmv_cuda, "launches"),
            (spmv.sell_spmv_cuda, "plus_launches"),
            (trsv.trsv_apply_cuda, "launches"),
            (bsr_spmv.bsr_spmv_cuda, "launches"),
            (spmv.sliced_ell_sub_mrhs_plain, "calls"),
            (trsv.trsv_apply_plain, "calls"),
            (bsr_spmv.bsr_matvec_mrhs_plain, "calls"))


def read_counters() -> tuple:
    """The launch counters of K1 (and its sign=+1 launches), K2 and K7 and
    the call counters of their plain versions, in :func:`_counters` order."""
    return tuple(getattr(o, a) for o, a in _counters())


def _set_counters(values) -> None:
    for (o, a), v in zip(_counters(), values):
        setattr(o, a, v)


def refuse(*objs) -> None:
    """Raise :class:`GraphRefused` for the first object that carries a
    ``graph_refusal`` reason."""
    for o in objs:
        reason = getattr(o, "graph_refusal", None)
        if reason is not None:
            raise GraphRefused(f"{getattr(o, '__name__', type(o).__name__)} "
                               f"cannot be captured: {reason}")


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


# the capture backend of each device type; a type without one runs eagerly
BACKENDS = {"cuda": CudaGraphs}


@dataclasses.dataclass
class _Entry:
    graph: object
    out: object       # the static output (overwritten by every replay)
    args: tuple       # the static inputs and the operands, kept alive
    delta: tuple      # what one run adds to each counter
    seconds: float    # the capture's host seconds


def _spec(a, by_shape: bool):
    """A key item: tensors by shape, dtype and device (``by_shape``) or by
    identity, static values by value, any other object by identity."""
    if torch.is_tensor(a):
        return (("t", tuple(a.shape), a.dtype, a.device) if by_shape
                else ("o", id(a)))
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device)):
        return ("v", type(a), a)
    return ("o", id(a))


def _fresh(out):
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, tuple):
        return tuple(_fresh(o) for o in out)
    return out


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
        is a fresh tensor (or tuple of them)."""
        refuse(fn, *args)
        key = (fn,) + tuple(_spec(a, True) for a in args)
        ent = self.entries.get(key)
        if ent is None:
            static = tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args)
            return _fresh(self._first(key, fn, static))
        for s, a in zip(ent.args, args):
            if torch.is_tensor(a):
                s.copy_(a)
        return _fresh(self._replay(ent))

    def step(self, fn, *args) -> None:
        """``fn(*args)`` on persistent tensors, read and written in place
        (they must outlive the cache's use of them; see
        :meth:`workspace`)."""
        refuse(fn, *args)
        key = (fn,) + tuple(_spec(a, False) for a in args)
        ent = self.entries.get(key)
        if ent is None:
            self._first(key, fn, args)
        else:
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
        out = self.backend.warm(fn, args)
        before = read_counters()
        t0 = time.perf_counter()
        try:
            graph, static_out = self.backend.capture(fn, args)
        except Exception as e:
            raise GraphCaptureError(
                f"capture of {_name(fn)} failed: {type(e).__name__}: "
                f"{e}") from e
        finally:
            delta = tuple(a - b for a, b in zip(read_counters(), before))
            _set_counters(before)
        self.entries[key] = _Entry(graph, static_out, args, delta,
                                   time.perf_counter() - t0)
        return out

    def _replay(self, ent: _Entry):
        self.backend.replay(ent.graph)
        _set_counters(a + d for a, d in zip(read_counters(), ent.delta))
        return ent.out


def cache_of(prec) -> Optional[GraphCache]:
    """The graph cache of a pack (made at first use), or None when its
    programs run eagerly: ``prec.graphs`` is off, or its device has no
    capture backend.  Raises :class:`GraphRefused` for an object that
    cannot be captured."""
    refuse(prec)
    if not getattr(prec, "graphs", False):
        return None
    make = BACKENDS.get(prec.device.type)
    if make is None:
        return None
    if prec.graph_cache is None:
        prec.graph_cache = GraphCache(make(prec.device))
    return prec.graph_cache


def jit(prec, fn):
    """``fn`` compiled against ``prec``'s cache, as ``jax.jit(fn)`` is:
    ``jit(prec, fn)(*args)`` is :meth:`GraphCache.call`, or ``fn(*args)``
    where the pack runs eagerly."""
    @functools.wraps(fn)
    def compiled(*args):
        cache = cache_of(prec)
        return fn(*args) if cache is None else cache.call(fn, *args)

    return compiled
