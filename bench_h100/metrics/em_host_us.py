"""Host µs to issue one EM iteration: the host clock over windows of 100 iterations with no synchronise, the median."""
from statistics import median

UNIT, LAYER, SOURCE, MOVES = "us", "EM loop", "host_clock", "em_iter_ms"


def read(r):
    return median(r.host_us) if r.host_us else None
