"""Solve drivers: the least time of the window's HIFIR calls
(:mod:`hifbench.work.ir`: their M-solves and residuals) over the device's
busy time in the window."""

from hifbench.peaks import least_seconds
from hifbench.work.ir import ir_work


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0 or "nirs" not in ctx:
        return None
    nb, fl = ir_work(ctx["levels"], ctx["tail_n"], ctx["n"], ctx["nnz_a"],
                     ctx["nrhs"], ctx["nirs"], ctx["es"])
    return 100.0 * ctx["solves"] * least_seconds(nb, fl, ctx["dtype"]) \
        / tr.busy_s
