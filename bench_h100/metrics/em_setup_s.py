"""Seconds of the EM loop's set-up, ``_EMRun.__init__``: the program's ``em.setup`` span."""
from ..program_trace import span_seconds

UNIT, LAYER, SOURCE, MOVES = "s", "EM set-up", "program_span", "setup_s"


def read(r):
    return span_seconds(r, "em.setup")
