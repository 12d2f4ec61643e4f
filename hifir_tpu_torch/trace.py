"""The program's spans and counters.

A span (:func:`span`) times a phase of the program on the host clock: every
span adds its seconds and one count to a per-name total, whether or not
anything is watching.  While a torch profiler records, a span also opens a
``torch.profiler.record_function`` range of the same name, so that the
phase appears among the trace's host events, on the clock of the device's
records: a profiler trace of the program then says what the host was doing
in each of the device's idle gaps.  With no profiler the range is never
opened (a bare range costs tens of microseconds); a span then costs two
clock reads, the profiler check and a dict update.

A counter (:func:`add`) counts work where it happens (host reads, Arnoldi
steps, bytes copied).  The kernels' launch counters stay where they are,
attributes of their wrappers (:func:`launch_counters`);
:func:`snapshot` reads them with the named counters, so that one call
reads everything.

Spans are never opened inside a program that :mod:`.graphs` captures: its
Python runs only at capture, and a replay would read nothing.  Names begin
with ``hifir.``; the spans and counters, and what reads each, are listed in
PERF.md §3.
"""

from __future__ import annotations

import time

import torch

__all__ = ["span", "add", "snapshot", "launch_counters"]

_profiling = torch._C._autograd._profiler_enabled

# per-name totals: span name -> [nanoseconds, count]; counter name -> n
_SPANS: dict = {}
_COUNTS: dict = {}
# the kernels' launch counters, (wrapper, attribute, name), resolved once
_LAUNCHES: list = []


class span:
    """``with span(name) as s:`` adds the block's host seconds and a count to
    ``name``'s total, and leaves the block's seconds in ``s.seconds``; a
    ``record_function`` range of the same name is opened only while a torch
    profiler records."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self._t0
        tot = _SPANS.get(self.name)
        if tot is None:
            _SPANS[self.name] = [dt, 1]
        else:
            tot[0] += dt
            tot[1] += 1
        self.seconds = dt / 1e9
        if self._range is not None:
            self._range.__exit__(*exc)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def launch_counters() -> list:
    """The kernels' launch counters, ``(wrapper, attribute, name)``: K1 (and
    its sign=+1 launches), K2 and K7 and the call counters of their plain
    versions, then those of the distribution's kernels (K10a a chunk, the
    sweep, the peer sweep, K10b) and of their plain versions, and last K2's
    launches in the tile form.  ``name`` is ``<wrapper>.<attribute>``."""
    if not _LAUNCHES:
        from .ops import bsr_spmv, chunk, spmv, trsv
        from .parallel import schur

        _LAUNCHES.extend(
            (o, a, f"{o.__name__}.{a}") for o, a in (
                (spmv.sell_spmv_cuda, "launches"),
                (spmv.sell_spmv_cuda, "plus_launches"),
                (trsv.trsv_apply_cuda, "launches"),
                (bsr_spmv.bsr_spmv_cuda, "launches"),
                (spmv.sliced_ell_sub_mrhs_plain, "calls"),
                (trsv.trsv_apply_plain, "calls"),
                (bsr_spmv.bsr_matvec_mrhs_plain, "calls"),
                (chunk.ChunkSweep, "launches"),
                (chunk.ChunkSweepKernel, "launches"),
                (chunk.PeerSweepKernel, "launches"),
                (schur.schur_partial_cuda, "launches"),
                (chunk.chunk_fma_plain, "calls"),
                (chunk.chunk_sweep_plain, "calls"),
                (chunk.chunk_sweep_peer_plain, "calls"),
                (schur.schur_partial_plain, "calls"),
                (trsv.trsv_apply_cuda, "tile_launches")))
    return _LAUNCHES


def snapshot() -> dict:
    """``{"spans": {name: (seconds, count)}, "counters": {name: n}}``: the
    totals since the process started; the counters include the launch
    counters under their ``<wrapper>.<attribute>`` names."""
    counters = dict(_COUNTS)
    counters.update((name, getattr(o, a)) for o, a, name in launch_counters())
    return {"spans": {k: (ns / 1e9, n) for k, (ns, n) in _SPANS.items()},
            "counters": counters}
