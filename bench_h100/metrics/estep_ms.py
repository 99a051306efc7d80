"""The per-call E-step kernel's mean time a launch (``csrc/likelihood.cu``), from the device trace."""
from statistics import mean

UNIT, LAYER, SOURCE, MOVES = "ms", "E-step kernel", "device_trace", "em_iter_ms"
KERNEL = "estep_kernel"


def read(r):
    times = r.window.kernels(KERNEL) if r.window else []
    return mean(times) * 1e3 if times else None
