"""On-demand build of the CUDA kernels: ``csrc/*.cu`` → one shared library.

The counterpart of ``demuxalot_tpu.native``'s on-demand g++ build. At first
use ``nvcc`` compiles every source under ``demuxalot_tpu_torch/csrc`` for
Hopper (``sm_90a``) into ``demuxalot_tpu_torch/_build/``, under a file name
keyed by a hash of the sources and flags; the library has a plain C
interface and is loaded with ``ctypes``. A missing ``nvcc`` or a failed
build raises: there is no fallback.

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
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
FALLBACK_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
# C signatures of csrc/*.cu's entry points; every one returns a cudaError_t
_SIGNATURES = {
    "demux_estep_logits": (
        _vp, _i64, _i32,  # genotype_prob, n_variants, n_donors
        _vp, _i64, _vp, _vp, _i64,  # row_ptr, n_calls, vid, q, n_barcodes
        _vp, _vp, _i32, _i32,  # penalties, schedule, n_passes, n_pg
        _vp, _vp, _vp,  # prior_logits (or null), logits, probs (or null)
        _i32, _vp,  # fast_log, stream
    ),
    "demux_mstep_addition": (
        _vp, _i64, _i32, _i32,  # posterior, n_barcodes, n_pg, n_donors
        _vp, _i64, _vp, _vp, _i64,  # var_ptr, n_calls, cb, q, n_variants
        ctypes.c_float, _vp, _vp,  # power, addition, stream
    ),
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
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
    for source in sources():
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
        _build = BuildResult(target, 0.0, "")
        return _build
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: concurrent builders never load a
    # half-written library
    fd, partial = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", partial, *map(str, sources())]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    _build = BuildResult(target, time.perf_counter() - start, proc.stdout + proc.stderr)
    return _build


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check_launch(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
