"""Compiled layer: megabytes (1e6 B) a call that ``GraphCache.call`` copies
into a program's static inputs and out into a fresh result (the program's
``graph.copy_bytes`` counter over the traced window, over the window's
calls)."""

from hifbench.program_trace import mark, window

KEY = "graph_copy_mb"


def counters():
    """Marks the program's counters before and after each take (see
    :mod:`hifbench.program_trace`); holds the trace to nothing."""
    return mark(KEY)


def read(ctx):
    got = window(KEY)
    if not got or "graph.copy_bytes" not in got or not ctx.get("solves"):
        return None
    return got["graph.copy_bytes"] / ctx["solves"] / 1e6
