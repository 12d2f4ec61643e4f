"""Kernels: 100 x K2's launches of one column on a cluster (the split: the
cluster's CTAs share each level's slots) over all its launches in the
traced window: the program's ``trsv_apply_cuda.split_launches`` over its
``trsv_apply_cuda.launches``.  A program without the split counter reads
nothing."""

from hifbench.program_trace import mark, window

KEY = "k2_split_pct"
SPLIT = "trsv_apply_cuda.split_launches"
ALL = "trsv_apply_cuda.launches"


def counters():
    """Marks the program's counters before and after each take (see
    :mod:`hifbench.program_trace`); holds the trace to nothing."""
    return mark(KEY)


def read(ctx):
    got = window(KEY)
    if not got or SPLIT not in got or not got.get(ALL):
        return None
    return 100.0 * got[SPLIT] / got[ALL]
