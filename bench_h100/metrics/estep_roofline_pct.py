"""The per-call E-step kernel's share of its bound (``bounds.Roofline`` with the softmax), per launch."""
from statistics import mean

from ..bounds import Roofline

UNIT, LAYER, SOURCE, MOVES = "%", "E-step kernel", "device_trace", "em_iter_ms"
KERNEL = "estep_kernel"


def read(r):
    times = r.window.kernels(KERNEL) if r.window else []
    if not times:
        return None
    s = r.shapes
    bound = Roofline(s.n_calls, s.n_donors, s.n_columns, s.n_barcodes, s.n_variants, softmax=True)
    return 100 * bound.speed_of_light_s() / mean(times)
