"""The M-step kernel's mean time a launch (``csrc/mstep.cu``: ``mstep_update``, the next normalisation fused)."""
from statistics import mean

UNIT, LAYER, SOURCE, MOVES = "ms", "M-step kernel", "device_trace", "em_iter_ms"
KERNEL = "mstep_kernel"


def read(r):
    times = r.window.kernels(KERNEL) if r.window else []
    return mean(times) * 1e3 if times else None
