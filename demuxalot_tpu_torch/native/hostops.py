"""Host-side sort/join primitives for the packing layer: numpy and C++.

Each op has a numpy path, which is the semantic definition (the numpy
paths of ``demuxalot_tpu.native.hostops``), and a native path through the
C++ host library (``demuxalot_tpu_torch/native/hostops.cpp``, built by
:func:`demuxalot_tpu_torch.native.load_host_library`) whose output is
bit-identical. As in the JAX package, the native path runs for inputs of
at least 65,536 rows when the library builds and loads; small inputs, or
a missing library, take the numpy path. :func:`numpy_paths` forces the
numpy paths for a comparison run.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np

# numpy wins below ~64k rows (native call setup + copies)
NATIVE_MIN_ROWS = 65_536

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)

_lib = None
_lib_failed = False
_forced_numpy = False


def native_library():
    """The loaded host-ops library, or None where it cannot be built."""
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        try:
            from . import load_host_library

            _lib = load_host_library()
        except (OSError, RuntimeError):  # no g++, a failed build or load
            _lib_failed = True
    return _lib


def _host_lib(n: int):
    """The library when the native path applies to ``n`` rows, else None."""
    if _forced_numpy or n < NATIVE_MIN_ROWS:
        return None
    return native_library()


@contextlib.contextmanager
def numpy_paths():
    """Run every op on its numpy path inside the block."""
    global _forced_numpy
    saved = _forced_numpy
    _forced_numpy = True
    try:
        yield
    finally:
        _forced_numpy = saved


def _sliced(g: int, n: int, *arrays):
    """First-g-rows views of over-allocated outputs (copies when most rows dropped)."""
    if g < n * 3 // 4:
        return tuple(a[:g].copy() for a in arrays)
    return tuple(a[:g] for a in arrays)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable ascending argsort for integer keys; returns int64 order.

    Exactly ``np.argsort(keys, kind="stable")``; the native radix path
    needs non-negative integer keys.
    """
    keys = np.ascontiguousarray(keys)
    n = len(keys)
    lib = _host_lib(n)
    if lib is None or not np.issubdtype(keys.dtype, np.integer) or int(keys.min()) < 0:
        return np.argsort(keys, kind="stable")
    keys64 = np.ascontiguousarray(keys, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.demux_radix_argsort_i64(keys64.ctypes.data_as(_i64p), n, order.ctypes.data_as(_i64p))
    return order


def match_keys(table_keys: np.ndarray, table_vals: np.ndarray,
               queries: np.ndarray) -> np.ndarray:
    """For each query key: the matching table value, or -1 when absent.

    Table keys are unique and non-negative. The numpy path is a sorted join
    by searchsorted; the native path a hash join.
    """
    table_keys = np.ascontiguousarray(table_keys, dtype=np.int64)
    table_vals = np.ascontiguousarray(table_vals, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.int64)
    m, n = len(table_keys), len(queries)
    if m == 0:
        return np.full(n, -1, dtype=np.int64)
    lib = _host_lib(n)
    if lib is None or int(table_keys.min()) < 0:
        order = np.argsort(table_keys, kind="stable")
        sorted_keys = table_keys[order]
        idx = np.searchsorted(sorted_keys, queries).clip(0, m - 1)
        return np.where(
            sorted_keys[idx] == queries, table_vals[order][idx], -1
        ).astype(np.int64)
    out = np.empty(n, dtype=np.int64)
    lib.demux_hash_match_i64(
        table_keys.ctypes.data_as(_i64p), table_vals.ctypes.data_as(_i64p), m,
        queries.ctypes.data_as(_i64p), n, out.ctypes.data_as(_i64p),
    )
    return out


def match_compact(table_keys, table_vids, calls_rec, molecules_rec):
    """Fused join of calls against a chromosome's variant registry, or None.

    Reads the call/molecule fields straight out of the structured record
    buffers and returns ``(vid, cb, mol_index, p_wrong, p_mol)`` for the
    matched calls in call order: what :func:`match_keys` plus the field
    gathers of ``ops.packing.match_calls_to_variants`` give. None asks the
    caller for that numpy path (small inputs, no library, or record dtypes
    the C++ does not read). Table keys are the unique non-negative
    ``pos*6 + base_code`` registry keys.
    """
    n = len(calls_rec)
    m = len(table_keys)
    lib = _host_lib(n)
    if (
        lib is None or m == 0
        or not calls_rec.flags.c_contiguous
        or not molecules_rec.flags.c_contiguous
    ):
        return None
    table_keys = np.ascontiguousarray(table_keys, dtype=np.int64)
    if int(table_keys.min()) < 0:
        return None
    table_vids = np.ascontiguousarray(table_vids, dtype=np.int64)
    cf = calls_rec.dtype.fields
    mf = molecules_rec.dtype.fields
    # the C++ reads 4-byte i32/f32 and 1-byte u8 fields at these offsets; a
    # drifted field dtype takes the numpy path instead of misreading memory
    expected = (
        (cf, "snp_position", np.int32), (cf, "base_index", np.uint8),
        (cf, "p_base_wrong", np.float32), (cf, "molecule_index", np.int32),
        (mf, "compressed_cb", np.int32), (mf, "p_group_misaligned", np.float32),
    )
    if any(fields[name][0] != np.dtype(dt) for fields, name, dt in expected):
        return None
    out_vid = np.empty(n, np.int32)
    out_cb = np.empty(n, np.int32)
    out_mol = np.empty(n, np.int32)
    out_p = np.empty(n, np.float32)
    out_pmol = np.empty(n, np.float32)
    cp = ctypes.c_char_p
    k = lib.demux_match_compact_strided(
        table_keys.ctypes.data_as(_i64p), table_vids.ctypes.data_as(_i64p), m,
        ctypes.cast(calls_rec.ctypes.data, cp), calls_rec.dtype.itemsize,
        cf["snp_position"][1], cf["base_index"][1],
        cf["p_base_wrong"][1], cf["molecule_index"][1],
        ctypes.cast(molecules_rec.ctypes.data, cp), molecules_rec.dtype.itemsize,
        mf["compressed_cb"][1], mf["p_group_misaligned"][1],
        len(molecules_rec), n,
        out_vid.ctypes.data_as(_i32p), out_cb.ctypes.data_as(_i32p),
        out_mol.ctypes.data_as(_i32p), out_p.ctypes.data_as(_f32p),
        out_pmol.ctypes.data_as(_f32p),
    )
    if k < 0:
        # a molecule_index outside the molecules table: the same caller bug
        # the numpy path surfaces as an IndexError
        raise IndexError(
            f"molecule_index out of range for the molecules table (n_molecules={len(molecules_rec)})"
        )
    return _sliced(k, n, out_vid, out_cb, out_mol, out_p, out_pmol)


def collapse_calls_keyed(vid: np.ndarray, cb: np.ndarray, p: np.ndarray,
                         lut: np.ndarray, cb_bits: int):
    """Device-order collapse: group calls by (lut[vid], cb).

    Returns ``(device_vid, cb, p_product, count)`` with rows sorted by
    (device_vid, cb); ``p_product`` is the float32 product over each
    group's members in stable input order. ``lut`` is the variant
    renumbering (``VariantReindex.inverse``); ``cb`` must fit in
    ``cb_bits`` bits.
    """
    vid = np.ascontiguousarray(vid, dtype=np.int32)
    cb = np.ascontiguousarray(cb, dtype=np.int32)
    p = np.ascontiguousarray(p, dtype=np.float32)
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    n = len(vid)
    if n == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.float32), np.empty(0, np.int64))
    lib = _host_lib(n)
    native_ok = (
        lib is not None
        and int(vid.min()) >= 0 and int(cb.min()) >= 0
        and (len(lut) == 0 or int(lut.min()) >= 0)
        # the C++ reads lut[vid] unchecked: a sizing bug must hit the numpy
        # path's IndexError, not corrupt memory
        and int(vid.max()) < len(lut)
    )
    if native_ok:
        out_vid = np.empty(n, np.int32)
        out_cb = np.empty(n, np.int32)
        out_p = np.empty(n, np.float32)
        out_count = np.empty(n, np.int64)
        g = lib.demux_collapse_calls_keyed(
            vid.ctypes.data_as(_i32p), cb.ctypes.data_as(_i32p), p.ctypes.data_as(_f32p), n,
            lut.ctypes.data_as(_i32p), int(cb_bits),
            out_vid.ctypes.data_as(_i32p), out_cb.ctypes.data_as(_i32p),
            out_p.ctypes.data_as(_f32p), out_count.ctypes.data_as(_i64p),
        )
        return _sliced(g, n, out_vid, out_cb, out_p, out_count)
    dev_vid = lut[vid].astype(np.int64)
    key = (dev_vid << int(cb_bits)) | cb.astype(np.int64)
    order = np.argsort(key, kind="stable")
    sorted_keys = key[order]
    starts = np.flatnonzero(
        np.concatenate(([True], sorted_keys[1:] != sorted_keys[:-1]))
    )
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    products = np.multiply.reduceat(p[order], starts).astype(np.float32)
    unique_keys = sorted_keys[starts]
    out_vid = (unique_keys >> int(cb_bits)).astype(np.int32)
    out_cb = (unique_keys & ((1 << int(cb_bits)) - 1)).astype(np.int32)
    return out_vid, out_cb, products, counts


def sort_calls_by_cb(cb: np.ndarray, vid: np.ndarray, q: np.ndarray):
    """Stable sort of the (cb, vid, q) call columns by cb.

    Returns new contiguous ``(cb_sorted, vid_sorted, q_sorted)`` arrays.
    """
    cb = np.ascontiguousarray(cb, dtype=np.int32)
    vid = np.ascontiguousarray(vid, dtype=np.int32)
    q = np.ascontiguousarray(q, dtype=np.float32)
    n = len(cb)
    lib = _host_lib(n)
    if lib is not None and int(cb.min()) >= 0:
        out_cb = np.empty(n, np.int32)
        out_vid = np.empty(n, np.int32)
        out_q = np.empty(n, np.float32)
        lib.demux_sort_calls_by_cb(
            cb.ctypes.data_as(_i32p), vid.ctypes.data_as(_i32p), q.ctypes.data_as(_f32p), n,
            out_cb.ctypes.data_as(_i32p), out_vid.ctypes.data_as(_i32p), out_q.ctypes.data_as(_f32p),
        )
        return out_cb, out_vid, out_q
    order = np.argsort(cb, kind="stable")
    return cb[order], vid[order], q[order]


def group_sum_broadcast(keys: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """out[i] = sum of weights over rows sharing keys[i].

    f64 accumulation in stable sorted-member order; the native path needs
    non-negative keys.
    """
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    lib = _host_lib(n)
    if lib is not None and int(keys.min()) >= 0:
        out = np.empty(n, np.float64)
        lib.demux_group_sum_broadcast(
            keys.ctypes.data_as(_i64p), weights.ctypes.data_as(_f64p), n, out.ctypes.data_as(_f64p),
        )
        return out
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    starts = np.flatnonzero(
        np.concatenate(([True], sorted_keys[1:] != sorted_keys[:-1]))
    )
    sums = np.add.reduceat(weights[order], starts)
    group_of_sorted = np.zeros(n, dtype=np.int64)
    group_of_sorted[starts] = 1
    group_of_sorted = np.cumsum(group_of_sorted) - 1
    out = np.empty(n, dtype=np.float64)
    out[order] = sums[group_of_sorted]
    return out
