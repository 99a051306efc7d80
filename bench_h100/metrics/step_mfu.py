"""The EM iteration's share of the FP32 peak: the operations its E-step and M-step need, over its traced time."""
from ..bounds import H100_FP32_FLOPS_PER_S, AggregateBound, MStepRoofline, Roofline

UNIT, LAYER, SOURCE, MOVES = "%", "EM loop", "device_trace", "em_iter_ms"


def read(r):
    w = r.window
    if not w or w.window_s <= 0 or not w.iterations:
        return None
    s = r.shapes
    if s.n_groups:
        estep = AggregateBound(s.n_molecules, s.n_groups, s.n_barcodes, s.n_variants, s.n_donors, s.n_columns)
    else:
        estep = Roofline(s.n_calls, s.n_donors, s.n_columns, s.n_barcodes, s.n_variants, softmax=True)
    mstep = MStepRoofline(s.n_calls, s.n_donors, s.n_barcodes, s.n_variants, n_runs=s.n_runs,
                          neighbour_adds=s.neighbour_adds)
    operations = estep.operations() + mstep.operations()
    return 100 * operations / (w.window_s / w.iterations) / H100_FP32_FLOPS_PER_S
