"""Spans, the profiler's window and the reduction of its trace.

Spans are the benchmark's own (``torch.profiler.record_function`` ranges
named ``hifbench.*`` around the calls into the program), taken only in a
``--trace 1`` run.  The reduction reads plain records ``(name, on_device,
start_ns, end_ns)``, so that the tests can feed it fake ones."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
import warnings
from typing import Dict, List, Tuple

__all__ = ["Spans", "DeviceTrace", "profiled", "reduce_trace", "complete",
           "counters", "take_pad", "host_syncs", "kernel_name", "WINDOW_SPAN",
           "TAKES"]

# the span around the measured window; the trace's window is its extent
WINDOW_SPAN = "hifbench.window"
# seconds of idle host after the profiler opens and before it closes, at
# the first take: the tracer drops device records whose converted start
# falls outside its window, and in some windows it puts the device
# timeline milliseconds early against the launches.  A window whose trace
# lost records (:func:`complete`) is taken again with twice the pads, up
# to TAKES takes in all (frozen copies of ``chip_smoke.py``'s
# ``PROFILE_PAD_S``, ``PROFILE_TAKES`` and ``take_pads``)
PAD_S = 0.1
TAKES = 5


def take_pad(take: int) -> float:
    """The pad at each end of the ``take``-th take (from 1)."""
    return PAD_S * 2 ** (take - 1)


def kernel_name(name: str) -> str:
    """A device record's name without its return type, anonymous
    namespaces, template arguments and parameter list (``void
    (anonymous namespace)::k<float, 4>(...)`` is ``k``), cut to 70
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for sep in "<(":
        if sep in name[1:]:
            name = name[:name.index(sep, 1)]
    name = name.strip()
    return name if len(name) <= 70 else name[:67] + "..."


def counters(modules) -> dict:
    """The program's launch counters that ``modules`` (a cell's metric and
    driver modules) read through their optional ``counters()`` hook: {the
    kernel's trace name: launches so far}."""
    out = {}
    for mod in modules:
        hook = getattr(mod, "counters", None)
        if hook is not None:
            out.update(hook())
    return out


def complete(trace, counted: dict) -> bool:
    """Whether the trace holds a device record for every launch the
    program counted over the window (``counted``: {kernel name: launches});
    a trace that lost records feeds no device metric."""
    return all(trace.count_of(k) == n for k, n in counted.items())


class Spans:
    """``span(name)`` is a ``record_function`` range when tracing, else
    nothing."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


@dataclasses.dataclass
class DeviceTrace:
    """The traced window: its length and the device's busy seconds in it
    (the union of the device's kernel, copy and set intervals), device
    seconds and records by name, and the idle seconds by what the host was
    doing in the middle of each gap (``<benchmark span>/<innermost host
    op>``)."""

    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[float, int]]
    idle_by_host: Dict[str, float]

    def seconds_of(self, name: str) -> float:
        return self.by_name.get(name, (0.0, 0))[0]

    def count_of(self, name: str) -> int:
        return self.by_name.get(name, (0.0, 0))[1]


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _host_at(t: int, spans, ops) -> str:
    """The innermost benchmark span and the innermost host op open at
    ``t`` (each list sorted by start: (start, end, name)); the
    lookup goes back 64 starts."""
    def inner(lst, starts):
        i = bisect.bisect_right(starts, t)
        best = None
        for s, e, name in reversed(lst[max(0, i - 64):i]):
            if e > t and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else "none"

    return f"{inner(spans[0], spans[1])}/{inner(ops[0], ops[1])}"


def reduce_trace(records) -> DeviceTrace:
    """The traced window from records ``(name, on_device, start_ns,
    end_ns)``: the window is the ``WINDOW_SPAN`` host range; device records
    count where they overlap it."""
    win = next((s, e) for n, d, s, e in records
               if not d and n == WINDOW_SPAN)
    w0, w1 = win
    dev, by = [], {}
    spans, ops = [], []
    for name, on_dev, s, e in records:
        if on_dev:
            if name.startswith(("hifbench.", "ProfilerStep")):
                continue
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            dev.append((s, e))
            k = kernel_name(name)
            sec, cnt = by.get(k, (0.0, 0))
            by[k] = (sec + (e - s) / 1e9, cnt + 1)
        elif name.startswith("hifbench.") and name != WINDOW_SPAN:
            spans.append((s, e, name))
        elif not name.startswith(("hifbench.", "ProfilerStep")):
            ops.append((s, e, name))
    busy = _union(dev)
    spans.sort()
    ops.sort()
    sp = (spans, [s for s, _, _ in spans])
    op = (ops, [s for s, _, _ in ops])
    idle, t = {}, w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            k = _host_at((t + s) // 2, sp, op)
            idle[k] = idle.get(k, 0.0) + (s - t) / 1e9
        t = max(t, e)
    return DeviceTrace((w1 - w0) / 1e9,
                       sum(e - s for s, e in busy) / 1e9, by, idle)


def profiled(body, pad: float = PAD_S):
    """``body()`` under torch.profiler (host and device), between ``pad``
    seconds of idle host at each end; returns ``(body's result,
    records)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        time.sleep(pad)
        out = body()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(pad)
    recs = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == DeviceType.CUDA
        if on_dev and e.is_user_annotation():
            continue
        recs.append((e.name(), on_dev, e.start_ns(), e.end_ns()))
    return out, recs


def host_syncs(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result
    and the number of synchronising calls it made (a frozen copy of
    ``chip_smoke.py:host_syncs``)."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)
