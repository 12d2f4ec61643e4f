"""Krylov driver: the host's reads of the device a system, as the driver
counts them (the program's ``gmres.reads`` counter over the traced window,
over the window's systems): ``||b||`` and one a segment of 5 steps."""

from hifbench.program_trace import mark, window

KEY = "program_reads_per_system"


def counters():
    """Marks the program's counters before and after each take (see
    :mod:`hifbench.program_trace`); holds the trace to nothing."""
    return mark(KEY)


def read(ctx):
    got = window(KEY)
    if not got or "gmres.reads" not in got or not ctx.get("solves"):
        return None
    return got["gmres.reads"] / ctx["solves"]
