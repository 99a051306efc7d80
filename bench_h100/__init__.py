"""The H100 benchmark of ``demuxalot_tpu_torch``: run one cell with ``python3 bench_h100/run.py``."""
