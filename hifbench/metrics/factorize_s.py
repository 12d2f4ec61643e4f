"""Host factorize: the host seconds of ``HIF.factorize`` on the cell's
matrix, read in set-up (the native library loaded first).  A per-layer
number: the host's speed moves it by 8-14% from run to run (PERF.md), more
than an end-to-end bound may hold; ``setup_s`` carries it end to end."""


def read(ctx):
    return ctx.get("factorize_s")
