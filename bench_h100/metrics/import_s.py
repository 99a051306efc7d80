"""Seconds of the program's own import, its ``import`` span (torch is loaded before it)."""
from ..program_trace import span_seconds

UNIT, LAYER, SOURCE, MOVES = "s", "package import", "program_span", "setup_s"


def read(r):
    return span_seconds(r, "import")
