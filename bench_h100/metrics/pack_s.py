"""Host seconds of ``Demultiplexer.pack_dataset`` in set-up: the join, the collapse and the layouts."""
UNIT, LAYER, SOURCE, MOVES = "s", "host packing", "host_clock", "setup_s"


def read(r):
    return r.spans.get("setup.pack")
