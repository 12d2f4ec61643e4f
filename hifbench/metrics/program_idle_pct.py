"""The device's idle time that the host spent inside the program's own
spans (``hifir.*``: the solve, the graph call and its key, input copy,
replay and output clone, the GMRES driver and its reads), as 100 x a share
of the traced window: the idle gaps whose innermost open host range
(:func:`hifbench.trace.reduce_trace`'s ``idle_by_host``, keyed
``<benchmark span>/<host range>``) is one of them."""

from hifbench.program_trace import snapshot


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or snapshot() is None:
        return None
    idle = sum(s for k, s in tr.idle_by_host.items()
               if k.split("/", 1)[-1].startswith("hifir."))
    return 100.0 * idle / tr.window_s
