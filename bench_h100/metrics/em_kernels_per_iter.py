"""Device kernels per EM iteration in the traced window."""
UNIT, LAYER, SOURCE, MOVES = "kernels", "EM loop", "device_trace", "em_iter_ms"


def read(r):
    w = r.window
    return w.n_kernels / w.iterations if w and w.n_kernels and w.iterations else None
