"""Kernels: 100 x K2's launches in the tile form (a block owns a tile of
columns, one 32-byte sector of x a slot) over all its launches in the
traced window: the program's ``trsv_apply_cuda.tile_launches`` over its
``trsv_apply_cuda.launches``.  A program without the tile counter reads
nothing."""

from hifbench.program_trace import mark, window

KEY = "k2_tile_pct"
TILE = "trsv_apply_cuda.tile_launches"
ALL = "trsv_apply_cuda.launches"


def counters():
    """Marks the program's counters before and after each take (see
    :mod:`hifbench.program_trace`); holds the trace to nothing."""
    return mark(KEY)


def read(ctx):
    got = window(KEY)
    if not got or TILE not in got or not got.get(ALL):
        return None
    return 100.0 * got[TILE] / got[ALL]
