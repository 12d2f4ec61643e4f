"""Solve drivers: the least time of the window's work over the device's
busy time in the window.  An apply cell's work is its M-solves
(:mod:`hifbench.work.msolve`); a gmres cell's its systems, each counted by
its own steps (:mod:`hifbench.work.gmres`)."""

from hifbench.peaks import least_seconds
from hifbench.work.gmres import gmres_work
from hifbench.work.msolve import msolve_work


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    lv, tn, n, es = ctx["levels"], ctx["tail_n"], ctx["n"], ctx["es"]
    if ctx["kind"] == "apply":
        nb, fl = msolve_work(lv, tn, n, ctx["nrhs"], es)
        least = ctx["solves"] * least_seconds(nb, fl, ctx["dtype"])
    else:
        least = sum(least_seconds(*gmres_work(lv, tn, ctx["nnz_a"], n, it,
                                              ctx["restart"], es),
                                  ctx["dtype"]) for it in ctx["iters"])
    return 100.0 * least / tr.busy_s
