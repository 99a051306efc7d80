"""The program's own spans and counters, read from its recorder in this process.

The program under test keeps one recorder, ``demuxalot_tpu_torch.utils.tracing``,
whose ``snapshot()`` gives the seconds and count of each span name and its
counters as plain numbers. The readers take it from the module the run has
already loaded, by its name in ``sys.modules``: nothing here imports the
program, and a program without the recorder reads as None. They read it
beside the device trace it explains, so a run whose trace holds no device
event (the CPU rehearsal) reads none of it.
"""
import sys

RECORDER = "demuxalot_tpu_torch.utils.tracing"
EM_OPS = ("estep_logits", "aggregated_logits", "mstep_update", "mstep_addition")


def snapshot(r):
    """The recorder's snapshot where the run ``r`` traced the device and loaded a recorder, else None."""
    take = getattr(sys.modules.get(RECORDER), "snapshot", None)
    if take is None or r.window is None or not r.window.events:
        return None
    return take()


def span_seconds(r, *names):
    """The seconds of the spans ``names`` added up, or None where none of them was recorded."""
    spans = (snapshot(r) or {}).get("spans", {})
    found = [spans[name]["seconds"] for name in names if name in spans]
    return sum(found) if found else None


def launch_host_us(r):
    """Host µs a call of the EM ops, over the calls their ``.host_ns`` counts, or None where none was counted."""
    counters = (snapshot(r) or {}).get("counters", {})
    calls = sum(counters.get(f"{op}.host_calls", 0) for op in EM_OPS)
    if not calls:
        return None
    return sum(counters.get(f"{op}.host_ns", 0) for op in EM_OPS) / calls * 1e-3
