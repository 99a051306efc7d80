"""The aggregate-on-SNPs E-step kernel's mean time a launch (``csrc/aggregate.cu``), from the device trace."""
from statistics import mean

UNIT, LAYER, SOURCE, MOVES = "ms", "aggregate E-step kernel", "device_trace", "em_iter_ms"
KERNEL = "aggregate_kernel"


def read(r):
    times = r.window.kernels(KERNEL) if r.window else []
    return mean(times) * 1e3 if times else None
