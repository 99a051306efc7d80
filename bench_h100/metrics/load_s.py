"""Seconds of loading the program's libraries: its ``load.kernels`` (CUDA kernels) and ``load.hostops`` spans."""
from ..program_trace import span_seconds

UNIT, LAYER, SOURCE, MOVES = "s", "Launch path (host)", "program_span", "setup_s"


def read(r):
    return span_seconds(r, "load.kernels", "load.hostops")
