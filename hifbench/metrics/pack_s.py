"""Pack: the host seconds of the run's packs, ``DevicePrec.from_host``
(the program's ``hifir.pack`` span: the triangular forms, the sliced ELL
of E and F, the dense tail and the index vectors, each copied to the
card).  All in set-up; ``setup_s`` carries it end to end."""

from hifbench.program_trace import span_seconds


def read(ctx):
    return span_seconds("hifir.pack")
