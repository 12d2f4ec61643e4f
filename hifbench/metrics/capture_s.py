"""Compiled layer: the host seconds of the run's first calls of each
captured program (the program's ``hifir.graph.first`` span: the eager
warm-up on the side stream, then the capture).  All in set-up;
``setup_s`` carries it end to end."""

from hifbench.program_trace import span_seconds


def read(ctx):
    return span_seconds("hifir.graph.first")
