"""Host µs a call of the EM kernel ops, entry to return: the program's ``.host_ns`` over ``.host_calls``."""
from ..program_trace import launch_host_us

UNIT, LAYER, SOURCE, MOVES = "us", "Launch path (host)", "program_counter", "em_iter_ms"


def read(r):
    return launch_host_us(r)
