"""The aggregate-on-SNPs E-step kernel's share of ``bounds.AggregateBound`` (bytes at HBM peak, operations at FP32 peak)."""
from statistics import mean

from ..bounds import AggregateBound

UNIT, LAYER, SOURCE, MOVES = "%", "aggregate E-step kernel", "device_trace", "em_iter_ms"
KERNEL = "aggregate_kernel"


def read(r):
    times = r.window.kernels(KERNEL) if r.window else []
    if not times or not r.shapes.n_groups:
        return None
    s = r.shapes
    bound = AggregateBound(s.n_molecules, s.n_groups, s.n_barcodes, s.n_variants, s.n_donors, s.n_columns)
    return 100 * bound.speed_of_light_s() / mean(times)
