"""Krylov driver (and the compiled layer under it): synchronising calls a
system inside ``gmres_hif``, counted by torch.cuda's sync-debug mode
(:func:`hifbench.trace.host_syncs`) over the traced window's systems."""


def read(ctx):
    reads = [r for r in ctx.get("reads") or () if r is not None]
    return sum(reads) / len(reads) if reads else None
