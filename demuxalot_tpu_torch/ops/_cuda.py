"""On-demand build of the CUDA kernels: ``csrc/*.cu`` → one shared library.

The counterpart of ``demuxalot_tpu.native``'s on-demand g++ build. At first
use one ``nvcc`` per source under ``demuxalot_tpu_torch/csrc``, all started
together, compiles it for Hopper (``sm_90a``); one more links the objects
into ``demuxalot_tpu_torch/_build/``, under a file name keyed by a hash of
the sources, their shared headers (``csrc/*.cuh``) and the flags. The
library has a plain C interface and is loaded with ``ctypes``. Every
launch goes through :class:`Entry`, which passes the device index and the
stream's raw handle after the kernel's arguments; the two queries
(``demux_card_limits``, ``demux_cluster_gather_plan``) take a device index
and go through :func:`library`. A missing ``nvcc`` or a failed build
raises: there is no fallback. :func:`library` is the
``load.kernels`` span of ``utils.tracing`` (the sources' hash, any build,
the load), and a build adds one to its ``builds`` counter.

Nothing here runs at import time, so the package loads where there is no
CUDA toolchain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from ..utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
FALLBACK_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
_f32 = ctypes.c_float
# C signatures of csrc/*.cu's entry points; every one returns a cudaError_t. A launch entry's last two arguments
# are the device index and the stream (Entry passes them), a query's last is the device index
_SIGNATURES = {
    "demux_estep_check": (
        _vp, _i64, _i64, _vp, _i64,  # row_ptr, n_barcodes, n_calls, vid, n_variants
        _vp, _i32, _i32, _i32, _i32,  # schedule, n_passes, entry, n_donors, n_pg
        _i32, _vp,  # device, stream
    ),
    "demux_estep_logits": (
        _vp, _i32, _vp, _vp, _vp, _i64,  # genotype_prob, n_donors, row_ptr, vid, q, n_barcodes
        _vp, _vp, _i32, _i32,  # penalties, schedule, n_passes, n_pg
        _vp, _vp, _vp,  # prior_logits (or null), logits, probs (or null)
        _i32, _vp,  # device, stream
    ),
    "demux_mstep_check": (
        _vp, _i64, _i64, _vp, _i64,  # var_ptr, n_variants, n_calls, cb, n_barcodes
        _i32, _vp,  # device, stream
    ),
    "demux_mstep_addition": (
        _vp, _i32, _i32,  # posterior, n_pg, n_donors
        _vp, _vp, _vp, _vp,  # var_ptr, cb, q, snp_ptr (or null)
        _vp, _i64, _vp, _vp, _vp, _vp,  # the plan: units, n_units, chunks, split, tickets, partials
        _f32, _vp, _i32, _vp,  # power, addition, device, stream
    ),
    "demux_mstep_update": (
        _vp, _i32, _i32,  # posterior, n_pg, n_donors
        _vp, _vp, _vp, _vp,  # var_ptr, cb, q, snp_ptr
        _vp, _i64, _vp, _vp, _vp, _vp,  # the plan: units, n_units, chunks, split, tickets, partials
        _f32, _vp, _vp,  # power, prior, mask (or null)
        _f32, _f32, _f32,  # floor, lo, hi
        _vp, _vp, _i32, _vp,  # addition, genotype_prob, device, stream
    ),
    "demux_estep_logits_banded": (
        _vp, _i64, _i32,  # genotype_prob, n_variants, n_donors
        _vp, _i32, _vp,  # band_edges, n_bands, band_ptr
        _vp, _vp, _i64,  # vid (band-local), q, n_barcodes
        _vp, _vp, _i32, _i32,  # penalties, schedule, n_passes, n_pg
        _vp, _i32, _vp,  # logits, device, stream
    ),
    "demux_mstep_addition_banded": (
        _vp, _i32, _i32,  # posterior, n_pg, n_donors
        _vp, _i32, _vp,  # band_edges, n_bands, band_ptr
        _vp, _vp, _i64,  # cb (band-local), q, n_variants
        _f32, _vp, _i32, _vp,  # power, addition, device, stream
    ),
    "demux_banded_check": (
        _vp, _i32, _i64,  # band_edges, n_bands, n_rows
        _vp, _i64, _i64, _vp,  # band_ptr, n_groups, n_calls, idx (band-local)
        _vp, _i32, _i32, _i32, _i32,  # schedule (or null), n_passes, entry, n_donors, n_pg
        _i32, _vp,  # device, stream
    ),
    "demux_gather_rows": (
        _vp, _i64, _i32, _vp, _i64,  # table, n_rows, width, idx, n
        _vp, _i32, _vp,  # out, device, stream
    ),
    "demux_gather_sum": (
        _vp, _i64, _i32, _vp, _i64, _i64,  # table, n_rows, width, idx, n, step
        _i32, _i32, _i32,  # rows_per_slice (0: through L2), n_slices, replicas
        _vp, _vp, _i32, _vp,  # partial, total, device, stream
    ),
    "demux_card_limits": (_vp, _i32),  # out (int32 [2]: shared memory a block may opt in to, SMs), device
    "demux_folded_logits": (
        _vp, _i64, _i32, _vp, _i64,  # u, n_calls, n_donors, row_ptr, n_barcodes
        _vp, _i32, _vp, _i32, _vp,  # schedule, n_passes, penalties, n_pg, logits
        _i32, _i32, _vp,  # use_log, device, stream
    ),
    "demux_split_logits": (
        _vp, _i64, _i32, _vp, _i64,  # u, n_calls, n_donors, row_ptr, n_barcodes
        _vp, _vp, _i32, _vp,  # pairs, penalties, n_pg, logits
        _i32, _i32, _i32, _vp,  # exp_words, sc_words, device, stream
    ),
    "demux_group_logits": (
        _vp, _i64, _i32, _vp, _i64, _i32,  # u, n_calls, n_donors, row_ptr, n_barcodes, group
        _vp, _i32, _vp, _i32, _vp,  # schedule, n_passes, penalties, n_pg, logits
        _i32, _i32, _i32, _vp,  # n_words, use_log, device, stream
    ),
    "demux_variant_check": (
        _vp, _i64, _i64, _vp,  # row_ptr, n_barcodes, n_calls, pairs
        _i32, _i32, _vp, _i32, _i32,  # n_pg, n_donors, schedule (or null), n_passes, entry
        _i32, _vp,  # device, stream
    ),
    "demux_stream_sum": (
        _vp, _i64, _i64, _i32, _i64, _i32,  # x, n_rows, n_cols, cols, step, corner
        _i32, _i32, _i32,  # route (0 cp.async, 1 TMA boxes, 2 TMA bulk runs), box, stages
        _vp, _i64, _vp, _i32, _vp,  # partial, n_partial, total, device, stream
    ),
    "demux_take_along_axis": (
        _vp, _i64, _i64, _vp, _i64, _i64, _i32,  # table, n_rows, n_cols, idx, rows_out, cols_out, axis
        _vp, _i32, _vp,  # out, device, stream
    ),
    "demux_cluster_gather_sum": (
        _vp, _i64, _i32, _vp, _i64, _i64,  # table, n_rows, width, idx, n, step
        _i32, _i32, _vp, _vp, _i32, _vp,  # stages, clusters, partial (and the warps' sums), total, device, stream
    ),
    # out (int32 [4]: ring stages, shared memory per CTA, clusters the card places, CTAs per SM), device
    "demux_cluster_gather_plan": (_i64, _i32, _vp, _i32),  # n_rows, width, out, device
    "demux_tiny": (_vp, _i64, _vp, _i32, _vp),  # x, n, out, device, stream
    "demux_aggregated_logits": (
        _vp, _i32, _vp, _vp,  # genotype_prob, n_donors, vid, q
        _vp, _vp, _i64,  # group_ptr, barcode_ptr, n_barcodes
        _vp, _i32, _i32, _i32,  # pairs, n_pg, team, cols (aggregate_kernel.aggregate_plan)
        _f32, _f32, _f32,  # compensation, escape, log_norm
        _vp, _vp, _vp, _i32, _vp,  # prior_logits (or null), logits, probs (or null), device, stream
    ),
    "demux_aggregate_check": (
        _vp, _i64, _i64, _vp, _i64,  # group_ptr, n_groups, n_calls, vid, n_variants
        _vp, _i64, _vp, _i32, _i32,  # barcode_ptr, n_barcodes, pairs, n_pg, n_donors
        _i32, _vp,  # device, stream
    ),
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    log: str  # nvcc's output (ptxas resource usage), empty when cached


_library: Optional[ctypes.CDLL] = None
_build: Optional[BuildResult] = None


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, $CUDA_PATH/bin, PATH, then FALLBACK_NVCC."""
    candidates = [
        Path(os.environ[var]) / "bin" / "nvcc"
        for var in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(var)
    ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(FALLBACK_NVCC)
    for candidate in candidates:
        if candidate.is_file():
            return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def sources() -> list:
    found = sorted(CSRC_DIR.glob("*.cu"))
    if not found:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in [*sources(), *sorted(CSRC_DIR.glob("*.cuh"))]:  # the shared headers key the build too
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return BUILD_DIR / f"libdemux_kernels_{digest.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile the kernels if this source set has no library yet."""
    global _build
    if _build is not None:
        return _build
    target = library_path()
    if target.exists():
        _build = BuildResult(target, "")
        return _build
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tracing.count("builds")
    # objects and the library are built in a scratch directory beside the
    # target and renamed: concurrent builds never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as scratch:
        commands = [[nvcc, *NVCC_FLAGS, "-c", str(source), "-o", str(Path(scratch) / f"{source.stem}.o")]
                    for source in sources()]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in commands]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
                  for cmd, proc, log in zip(commands, procs, logs) if proc.returncode != 0]
        if failed:  # every source's errors, not only the first's
            raise RuntimeError("\n".join(failed))
        partial = Path(scratch) / target.name
        link = [nvcc, "-shared", "-o", str(partial), *(cmd[-1] for cmd in commands)]
        linked = subprocess.run(link, capture_output=True, text=True)
        if linked.returncode != 0:
            raise RuntimeError(f"nvcc failed ({linked.returncode}):\n{' '.join(link)}\n{linked.stdout}{linked.stderr}")
        os.replace(partial, target)
    _build = BuildResult(target, "".join(logs) + linked.stdout + linked.stderr)
    return _build


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _library
    if _library is None:
        with tracing.span("load.kernels"):
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        _library = lib
    return _library


def checked(base: type) -> type:
    """``Checked<base>``, the one mark of operands that their builder checked: a subclass of the NamedTuple
    ``base`` whose ``_replace`` returns an unchecked ``base``, which the wrappers refuse to launch on."""
    replace = lambda self, **fields: base(*self)._replace(**fields)  # noqa: E731
    return type(f"Checked{base.__name__}", (base,), {"__slots__": (), "__module__": base.__module__,
                                                     "_replace": replace})


class Entry:
    """One launch entry point of the library, launched on a tensor's card and that card's current stream.

    The one launch path: the entry's ctypes function is resolved at the
    first launch and kept (no ``library()`` call and no attribute lookup per
    launch), and the C entry takes the device index and the current stream's
    raw handle as its last two arguments. C makes the device current only
    where it is not (``csrc/common.cuh``'s ``DeviceGuard``), so a launch
    builds no ``torch.cuda.device`` guard and no ``torch.cuda.Stream``.
    Nothing touches CUDA before the first launch.
    """

    __slots__ = ("name", "_fn", "_stream")

    def __init__(self, name: str):
        if name not in _SIGNATURES:
            raise KeyError(f"{name} is not an entry point of csrc/*.cu")
        self.name = name
        self._fn = None
        self._stream = None

    def __call__(self, on, *args) -> None:
        """Launch with ``args`` (the C arguments before the device) on ``on``'s card; raises for a CPU tensor."""
        index = on.get_device()
        if index < 0:
            raise ValueError(f"{self.name} launches on CUDA tensors, not on {on.device}")
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.name)
            # the raw handle of the current stream, as Triton's launcher reads it
            self._stream = torch._C._cuda_getCurrentRawStream
        check_launch(self.name, fn(*args, index, self._stream(index)))


def check_launch(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
