"""Solve drivers: M-solves a HIFIR call, as the program counts them (its
``ir.msolves`` over its ``ir.calls`` in the traced window).  A program
without these counters reads nothing."""

from hifbench.program_trace import mark, window

KEY = "ir_msolves_per_call"


def counters():
    """Marks the program's counters before and after each take (see
    :mod:`hifbench.program_trace`); holds the trace to nothing."""
    return mark(KEY)


def read(ctx):
    got = window(KEY)
    if not got or not got.get("ir.calls"):
        return None
    return got.get("ir.msolves", 0) / got["ir.calls"]
