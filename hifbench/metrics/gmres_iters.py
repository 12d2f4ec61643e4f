"""Krylov driver: Arnoldi steps a system, as ``gmres_hif`` returns them,
averaged over the traced window's systems."""


def read(ctx):
    its = ctx.get("iters")
    return sum(its) / len(its) if its else None
