"""Krylov driver: 100 x the Arnoldi steps the cycles use over the steps
their segments run (a segment of 5 steps runs whole, masked after
convergence): the program's ``gmres.steps_used`` over ``gmres.steps_run``
in the traced window."""

from hifbench.program_trace import mark, window

KEY = "arnoldi_use_pct"


def counters():
    """Marks the program's counters before and after each take (see
    :mod:`hifbench.program_trace`); holds the trace to nothing."""
    return mark(KEY)


def read(ctx):
    got = window(KEY)
    if not got or not got.get("gmres.steps_run"):
        return None
    return 100.0 * got.get("gmres.steps_used", 0) / got["gmres.steps_run"]
