"""PyTorch + CUDA port of demuxalot_tpu: single-cell demultiplexing on an NVIDIA GPU.

Doublet-aware posterior inference and EM refinement of probabilistic
genotype betas, with the E-step and M-step as hand-written CUDA kernels for
Hopper (``csrc/``) beside plain PyTorch versions. The JAX package
``demuxalot_tpu`` is the reference this package is checked against; this
package imports neither it nor jax.

The device is explicit: ``Demultiplexer.device`` defaults to ``"cuda"`` and
raises where there is no card; set it to ``"cpu"`` to run the plain path.
Importing the package is the ``import`` span of ``utils.tracing``, from the
first statement below to the last.
"""

import time as _time

_IMPORT_STARTED_NS = _time.perf_counter_ns()

__version__ = "0.1.0"

from .frontend.snp_counter import count_snps
from .models.demux import CompactPosteriors, Demultiplexer, PackedCalls
from .models.genotypes import ProbabilisticGenotypes
from .models.snp_detection import detect_snps_positions
from .utils.barcodes import BarcodeHandler
from .utils.tracing import record as _record

__all__ = [
    "BarcodeHandler",
    "CompactPosteriors",
    "Demultiplexer",
    "PackedCalls",
    "ProbabilisticGenotypes",
    "__version__",
    "count_snps",
    "detect_snps_positions",
]

_record("import", _IMPORT_STARTED_NS)
