"""Kernels: K2's least time (:mod:`hifbench.work.k2`) over the profiler's
time of ``trsv_solve_kernel`` in the traced window.  The work counts the
M-solves the cell needs (an apply cell's calls, a gmres cell's Arnoldi
steps); K2's time also holds the launches the program spends beyond them
(a GMRES segment's masked steps after convergence).  ``counters`` gives
the program's K2 launch counter, which the harness holds the trace to;
nothing is read where the counter over the window is no whole multiple
of the launches a solve needs by the host levels' sizes."""

from hifbench.peaks import least_seconds
from hifbench.work.k2 import k2_launches, k2_work

KERNEL = "trsv_solve_kernel"


def counters():
    """K2 launches the program has counted (replays included)."""
    from hifir_tpu_torch.ops import trsv

    return {KERNEL: int(trsv.trsv_apply_cuda.launches)}


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    per = k2_launches(ctx["levels"])
    counted = ctx["counted"].get(KERNEL, 0)
    secs = tr.seconds_of(KERNEL)
    if not per or counted % per or secs <= 0:
        return None
    solves = ctx["solves"] if ctx["kind"] == "apply" else sum(ctx["iters"])
    nb, fl = k2_work(ctx["levels"], ctx["nrhs"], ctx["es"])
    return 100.0 * solves * least_seconds(nb, fl, ctx["dtype"]) / secs
