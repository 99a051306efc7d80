"""Native (C++) host components: on-demand g++ builds, loaded with ctypes.

Two libraries, compiled from this package's own C++ sources
(``demuxalot_tpu_torch/native/scanner.cpp`` and ``hostops.cpp``, copies of
the JAX package's ``demuxalot_tpu/native/*.cpp``: the port builds without
that package). Each library is built at first use into
``demuxalot_tpu_torch/_build/`` under a file name keyed by a hash of its
source, flags and machine architecture, exactly as ``ops._cuda`` builds the
CUDA kernels.

* the scanner (``-lz``): BGZF decompression, record decoding, read
  filtering, molecule grouping and consensus calls in one pass, and the
  A/C/G/T pileup of SNP discovery (:mod:`.scanner`);
* the host ops (``-pthread``): radix argsort, hash joins and the fused
  collapse/sort passes of the packing layer (:mod:`.hostops`).

:func:`load_host_library` is the ``load.hostops`` span of
``utils.tracing``, and each build adds one to its ``builds`` counter.

A failed build raises; the callers decide whether that is fatal (the
``native=True`` and ``chip_smoke.py`` paths) or means the numpy/Python path
(``native=None``, the host ops), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

from ..utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
# portable code (no -march=native): a built library may be copied between
# hosts of one architecture, which the file name keys on
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_cp = ctypes.c_char_p

# ctypes signatures of the two sources' C entry points:
# name -> (restype, argtypes)
HOST_SIGNATURES = {
    "demux_radix_argsort_i64": (None, (_i64p, _i64, _i64p)),
    "demux_hash_match_i64": (None, (_i64p, _i64p, _i64, _i64p, _i64, _i64p)),
    "demux_match_compact_strided": (_i64, (
        _i64p, _i64p, _i64,
        _cp, _i64,
        _i64, _i64, _i64, _i64,
        _cp, _i64, _i64, _i64,
        _i64, _i64,
        _i32p, _i32p, _i32p, _f32p, _f32p,
    )),
    "demux_collapse_calls_keyed": (_i64, (
        _i32p, _i32p, _f32p, _i64, _i32p, _i32,
        _i32p, _i32p, _f32p, _i64p,
    )),
    "demux_sort_calls_by_cb": (None, (_i32p, _i32p, _f32p, _i64, _i32p, _i32p, _f32p)),
    "demux_group_sum_broadcast": (None, (_i64p, _f64p, _i64, _f64p)),
}
SCANNER_SIGNATURES = {
    "scan_region": (ctypes.c_void_p, (
        _cp,
        _u64p, _u64p, ctypes.c_int,
        _i32, _i32, _i32,
        _i32p, ctypes.c_int,
        ctypes.POINTER(_cp), ctypes.c_int,
        _cp, _cp, _cp, _cp,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
    )),
    "scan_n_molecules": (_i64, (ctypes.c_void_p,)),
    "scan_n_calls": (_i64, (ctypes.c_void_p,)),
    "scan_fill": (None, (
        ctypes.c_void_p,
        _i32p, _i32p, _f32p,
        _i32p, _i32p, ctypes.POINTER(ctypes.c_uint8), _f32p,
    )),
    "scan_free": (None, (ctypes.c_void_p,)),
    "count_coverage": (ctypes.c_int, (
        _cp,
        _u64p, _u64p, ctypes.c_int,
        _i32, _i32, _i32,
        _cp, _cp, _cp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i64p,
    )),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(source: Path, extra: tuple) -> Path:
    """Where the library of ``source`` built with ``extra`` flags lives."""
    digest = hashlib.sha256(" ".join((*GXX_FLAGS, *extra, platform.machine())).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, extra: tuple) -> Path:
    """Compile ``source`` with g++ unless this source and flag set is built."""
    target = library_path(source, extra)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tracing.count("builds")
    # build beside the target and rename: concurrent builders never load a
    # half-written library
    fd, partial = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(source), *extra, "-o", partial]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    return target


def _load(name: str, extra: tuple, signatures: dict) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(SOURCE_DIR / f"{name}.cpp", extra)))
        for fn_name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _loaded[name] = lib
    return lib


def load_host_library() -> ctypes.CDLL:
    """Build (if needed) and load the host-ops library (sort/join)."""
    with tracing.span("load.hostops"):
        return _load("hostops", ("-pthread",), HOST_SIGNATURES)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the BAM scanner library."""
    return _load("scanner", ("-lz",), SCANNER_SIGNATURES)
