"""The program's own spans and counters (``hifir_tpu_torch.trace``), as the
per-layer metrics of ``metrics/`` read them.

A span total (``pack_s``, ``capture_s``) is read whole when ``read`` runs:
every pack and capture of a cell happens in its set-up.  A counter metric
needs the counter's gain over the measured window.  The harness calls each
metric file's ``counters()`` hook right before and right after each traced
take, but loads the file afresh for ``read``, so a metric file keeps
nothing from its hook to its ``read``.  This module, imported by package
name, is the one copy both share: the hook calls :func:`mark` and returns
``{}`` (so the trace's completeness stays held to the kernels' launch
counters alone), and ``read`` calls :func:`window`, the gains between the
last two marks of its key, which are the last take's.

A program without ``hifir_tpu_torch.trace`` (a tree from before it) has no
snapshot: every reading here is None, and the metrics read nothing."""

from __future__ import annotations

from typing import Optional

__all__ = ["snapshot", "mark", "window", "span_seconds"]

# key -> (the mark before the last, the last mark)
_MARKS: dict = {}


def snapshot() -> Optional[dict]:
    """``hifir_tpu_torch.trace.snapshot()``, or None where the program has
    no such module."""
    try:
        from hifir_tpu_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


def mark(key: str) -> dict:
    """Keep the program's snapshot as ``key``'s last mark; returns ``{}``,
    what a metric's ``counters()`` hook hands the harness."""
    snap = snapshot()
    if snap is not None:
        _MARKS[key] = (_MARKS.get(key, (None, None))[1], snap)
    return {}


def window(key: str) -> Optional[dict]:
    """{counter: gain} between ``key``'s last two marks, or None."""
    before, after = _MARKS.get(key, (None, None))
    if before is None:
        return None
    was = before["counters"]
    return {k: n - was.get(k, 0) for k, n in after["counters"].items()}


def span_seconds(name: str) -> Optional[float]:
    """The host seconds of every ``name`` span of the run so far, or None
    where the program has opened none."""
    snap = snapshot()
    seconds, count = (None, 0) if snap is None else \
        snap["spans"].get(name, (0.0, 0))
    return seconds if count else None
