"""The port's native host ops against their numpy paths, bit for bit.

The C++ library is built from ``demuxalot_tpu_torch/native/hostops.cpp`` by g++
into ``demuxalot_tpu_torch/_build/``. Every op runs natively from 65,536
rows, so the inputs here have 200,000 rows; ``hostops.numpy_paths()``
gives the numpy path (the definition) on the same inputs. Packing is then
checked whole: with and without the library, and against the JAX package.
"""
from pathlib import Path

import numpy as np
import pytest

from demuxalot_tpu.models.demux import PackedCalls as JaxPackedCalls
from demuxalot_tpu_torch import PackedCalls, convert, native, sim
from demuxalot_tpu_torch.frontend.snp_counter import MOLECULE_DTYPE, SNP_CALL_DTYPE
from demuxalot_tpu_torch.native import hostops

N = 200_000


def _both_paths(op, *args):
    """(native result, numpy result) of ``op`` on the same inputs."""
    assert hostops.native_library() is not None
    native_result = op(*args)
    with hostops.numpy_paths():
        numpy_result = op(*args)
    return native_result, numpy_result


def _assert_identical(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.ascontiguousarray(x).tobytes() == np.ascontiguousarray(y).tobytes()


def test_host_library_builds_into_the_port(tmp_path):
    lib = native.load_host_library()
    assert hostops.native_library() is lib
    path = native.library_path(native.SOURCE_DIR / "hostops.cpp", ("-pthread",))
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE_DIR == Path(native.__file__).resolve().parent  # the port's own copy
    assert native.SOURCE_DIR.parent.name == "demuxalot_tpu_torch"
    assert native.load_library() is native.load_library()


@pytest.mark.parametrize("dtype,high", [(np.int64, 1 << 40), (np.int32, 1 << 30), (np.int64, 7)])
def test_stable_argsort(dtype, high):
    keys = np.random.RandomState(high % 11).randint(0, high, N).astype(dtype)
    _assert_identical(*_both_paths(hostops.stable_argsort, keys))
    np.testing.assert_array_equal(hostops.stable_argsort(keys), np.argsort(keys, kind="stable"))


def test_match_keys():
    rng = np.random.RandomState(3)
    table_keys = rng.choice(10 * N, 5000, replace=False).astype(np.int64)
    table_vals = rng.randint(0, 1 << 20, 5000).astype(np.int64)
    queries = np.concatenate([rng.choice(table_keys, N // 2), rng.randint(0, 10 * N, N // 2)])
    _assert_identical(*_both_paths(hostops.match_keys, table_keys, table_vals, queries))


def _records(rng, n_calls, n_molecules):
    calls = np.empty(n_calls, SNP_CALL_DTYPE)
    calls["molecule_index"] = rng.randint(0, n_molecules, n_calls)
    calls["snp_position"] = rng.randint(0, 3000, n_calls)
    calls["base_index"] = rng.randint(0, 5, n_calls)
    calls["p_base_wrong"] = rng.rand(n_calls).astype(np.float32)
    molecules = np.empty(n_molecules, MOLECULE_DTYPE)
    molecules["compressed_cb"] = rng.randint(0, 900, n_molecules)
    molecules["compressed_ub"] = rng.randint(0, 1 << 30, n_molecules)
    molecules["p_group_misaligned"] = rng.rand(n_molecules).astype(np.float32)
    return calls, molecules


def test_match_compact_equals_the_numpy_join():
    rng = np.random.RandomState(5)
    calls, molecules = _records(rng, N, 40_000)
    table_keys = rng.choice(3000 * 6, 4000, replace=False).astype(np.int64)
    table_vids = rng.permutation(4000).astype(np.int64)
    fused = hostops.match_compact(table_keys, table_vids, calls, molecules)
    with hostops.numpy_paths():
        assert hostops.match_compact(table_keys, table_vids, calls, molecules) is None
        joined = hostops.match_keys(
            table_keys, table_vids,
            calls["snp_position"].astype(np.int64) * 6 + calls["base_index"].astype(np.int64),
        )
    matched = joined >= 0
    mol = calls["molecule_index"][matched]
    _assert_identical(fused, (
        joined[matched].astype(np.int32), molecules["compressed_cb"][mol], mol,
        calls["p_base_wrong"][matched], molecules["p_group_misaligned"][mol],
    ))


def test_collapse_calls_keyed():
    rng = np.random.RandomState(7)
    n_variants = 3000
    vid = rng.randint(0, n_variants, N).astype(np.int32)
    cb = rng.randint(0, 700, N).astype(np.int32)
    p = rng.rand(N).astype(np.float32)
    lut = rng.permutation(n_variants).astype(np.int32)
    _assert_identical(*_both_paths(hostops.collapse_calls_keyed, vid, cb, p, lut, 10))


def test_sort_calls_by_cb():
    rng = np.random.RandomState(9)
    args = (rng.randint(0, 5000, N).astype(np.int32), rng.randint(0, 1 << 20, N).astype(np.int32),
            rng.rand(N).astype(np.float32))
    _assert_identical(*_both_paths(hostops.sort_calls_by_cb, *args))


def test_group_sum_broadcast():
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 20_000, N).astype(np.int64)
    weights = rng.randint(1, 9, N).astype(np.float64)
    _assert_identical(*_both_paths(hostops.group_sum_broadcast, keys, weights))


def test_small_inputs_take_the_numpy_path():
    rng = np.random.RandomState(13)
    keys = rng.randint(0, 100, 1000)
    np.testing.assert_array_equal(hostops.stable_argsort(keys), np.argsort(keys, kind="stable"))
    calls, molecules = _records(rng, 1000, 100)
    assert hostops.match_compact(np.arange(10), np.arange(10), calls, molecules) is None


@pytest.fixture(scope="module")
def large_dataset():
    """Synthetic calls past the native threshold: 2,000 barcodes x 40 calls."""
    genotypes, calls, _truth, _names = sim.synthesize_compressed_calls(2000, 6, 500, 40, seed=4)
    return genotypes, calls


def _packed_arrays(packed):
    arrays = [packed.variant2snp, packed.reindex.order, packed.reindex.inverse, packed.reindex.variant2snp]
    arrays += [getattr(packed.molecule_calls, field) for field in (
        "variant_id", "snp_id", "compressed_cb", "molecule_id", "p_base_wrong", "p_molecule_aligned_wrong")]
    arrays += [getattr(packed.calls_v, field) for field in ("vid", "cb", "q", "count")]
    arrays += list(packed.calls_by_barcode())
    return arrays


def test_packed_calls_identical_with_and_without_the_library(large_dataset):
    genotypes, calls = large_dataset
    assert len(calls["chr1"].snp_calls) >= hostops.NATIVE_MIN_ROWS
    with_library = _packed_arrays(PackedCalls(calls, genotypes))
    with hostops.numpy_paths():
        without = _packed_arrays(PackedCalls(calls, genotypes))
    theirs = _packed_arrays(JaxPackedCalls(_jax_calls(calls), _jax_genotypes(genotypes)))
    for ours, numpy_only, jax_packed in zip(with_library, without, theirs):
        _assert_identical(ours, numpy_only)
        _assert_identical(np.asarray(ours), np.asarray(jax_packed))


def _jax_calls(calls):
    from demuxalot_tpu.frontend.snp_counter import CompressedSNPCalls as JaxCalls

    result = {}
    for chromosome, (molecules, snp_calls) in convert.calls_to_arrays(calls).items():
        result[chromosome] = JaxCalls()
        result[chromosome].molecules = molecules
        result[chromosome].snp_calls = snp_calls
        result[chromosome]._finalized = True
    return result


def _jax_genotypes(genotypes):
    from demuxalot_tpu.models.genotypes import ProbabilisticGenotypes as JaxGenotypes

    arrays = convert.genotypes_to_arrays(genotypes)
    result = JaxGenotypes(arrays["genotype_names"], default_prior=arrays["default_prior"])
    for c, p, b in zip(arrays["chrom"], arrays["pos"], arrays["base"]):
        result.get_variant_id(c, int(p), b)
    return result._with_betas(arrays["betas"])
