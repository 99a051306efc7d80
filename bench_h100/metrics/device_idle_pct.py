"""Share of the traced window in which no kernel, copy or set ran on the device."""
UNIT, LAYER, SOURCE, MOVES = "%", "device", "device_trace", "em_iter_ms"


def read(r):
    w = r.window
    return 100 * (1 - w.busy_s / w.window_s) if w and w.window_s > 0 else None
