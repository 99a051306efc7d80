"""The M-step kernel's share of its bound (``bounds.MStepRoofline`` with the SNP runs), per launch."""
from statistics import mean

from ..bounds import MStepRoofline

UNIT, LAYER, SOURCE, MOVES = "%", "M-step kernel", "device_trace", "em_iter_ms"
KERNEL = "mstep_kernel"


def read(r):
    times = r.window.kernels(KERNEL) if r.window else []
    if not times:
        return None
    s = r.shapes
    bound = MStepRoofline(s.n_calls, s.n_donors, s.n_barcodes, s.n_variants, n_runs=s.n_runs,
                          neighbour_adds=s.neighbour_adds)
    return 100 * bound.speed_of_light_s() / mean(times)
