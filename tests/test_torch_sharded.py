"""The port's sharded engine against the JAX sharded engine and the port's own single-device engine.

Data: the small BAM problem of tests/test_sharding.py (6 donors, 200
barcodes x 40 reads), counted by the JAX package and handed to the port
through ``convert``. The port shards over 4 CPU shards; the JAX engine
runs on the suite's 8-device virtual mesh (tests/conftest.py).

Against JAX, the tolerances of tests/test_sharding.py: logits rtol 1e-4,
atol 5e-3; posteriors 1e-5 for predict and 1e-4 for EM; betas rtol 1e-4,
atol 1e-2; identical argmax. Against the port's single-device engine,
predict logits and the first E-step are bit-equal: each barcode's calls
are summed in the same order, and the CPU's doublet matmul adds at most
two nonzero terms (½·p_i and ½·p_j, both exact), so no blocking of the
matmul can change a bit. EM posteriors are within 3e-5 (the M-step's
partial sums differ in association only).
"""
import numpy as np
import pytest
import torch

from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu.frontend.snp_counter import count_snps
from demuxalot_tpu.parallel import ColumnDataset as JaxColumnDataset
from demuxalot_tpu.parallel import ShardedDemultiplexer as JaxShardedDemultiplexer
from demuxalot_tpu.parallel import make_mesh as jax_make_mesh
from demuxalot_tpu.sim import generate_bam_file
from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, convert
from demuxalot_tpu_torch.models import demux
from demuxalot_tpu_torch.ops import likelihood as L
from demuxalot_tpu_torch.parallel import ColumnDataset, ShardedDemultiplexer, make_mesh
from demuxalot_tpu_torch.parallel.mesh import allreduce_max_dims, local_shard_ids, to_host

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
BETAS_TOL = dict(rtol=1e-4, atol=1e-2)
EM_SINGLE_ATOL = 3e-5


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")


def engine(n_shards: int = 4) -> ShardedDemultiplexer:
    return ShardedDemultiplexer(make_mesh([CPU] * n_shards))


@pytest.fixture(scope="module")
def small_problem(tmp_path_factory):
    """tests/test_sharding.py's problem: (JAX genotypes, JAX calls, barcode names)."""
    np.random.seed(7)
    filename = str(tmp_path_factory.mktemp("bam") / "t.bam")
    filename, genotypes, _ids, barcode2donor_names = generate_bam_file(
        filename, n_genotypes=6, n_barcodes=200, n_reads_per_barcode=40,
        chromosome2length={"chr1": 800, "chr2": 800},
    )
    names = list(barcode2donor_names)
    calls = count_snps(filename, chromosome2positions=genotypes.get_chromosome2positions(),
                       barcode_handler=JaxBarcodeHandler(names), joblib_n_jobs=None, joblib_verbosity=0)
    return genotypes, calls, names


def _sides(genotypes, calls, names):
    return {
        "jax": (calls, genotypes, JaxBarcodeHandler(names)),
        "port": (convert.calls_from(calls), convert.genotypes_from(genotypes), BarcodeHandler(names)),
    }


@pytest.fixture(scope="module")
def data(small_problem):
    return _sides(*small_problem)


@pytest.fixture(scope="module")
def erased(small_problem):
    """As ``data``, with 90% of the SNPs' betas zeroed (tests/test_sharding.py's anchor case)."""
    genotypes, calls, names = small_problem
    ng = genotypes.clone()
    snp_ids = ng.get_snp_ids_for_variants()
    rng = np.random.RandomState(9)
    erased_rows = np.nonzero((rng.rand(snp_ids.max() + 1) < 0.9)[snp_ids])[0]
    ng.variant_betas[erased_rows, :] = 0
    return _sides(ng, calls, names), erased_rows


@pytest.fixture(scope="module")
def jax_engine():
    return JaxShardedDemultiplexer(jax_make_mesh())


def _prior_logits(handler, n_options):
    rng = np.random.RandomState(0)
    prior = np.zeros((handler.n_barcodes, n_options), dtype=np.float32)
    labeled = rng.rand(handler.n_barcodes) < 0.5
    prior[labeled, rng.randint(0, n_options, labeled.sum())] = 100.0
    return prior


# -- predict ---------------------------------------------------------------

@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_predict_matches_jax_sharded(data, jax_engine, doublet_prior):
    logits, probs = engine().predict_posteriors(*data["port"], doublet_prior=doublet_prior)
    jax_logits, jax_probs = jax_engine.predict_posteriors(*data["jax"], doublet_prior=doublet_prior)
    assert list(logits.columns) == list(jax_logits.columns) and list(logits.index) == list(jax_logits.index)
    assert logits.index.name == probs.index.name == "BARCODE"
    np.testing.assert_allclose(logits.values, jax_logits.values, **LOGITS_TOL)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-5)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_predict_is_bit_equal_to_single_device(data, doublet_prior, n_shards):
    logits, probs = engine(n_shards).predict_posteriors(*data["port"], doublet_prior=doublet_prior)
    single_logits, single_probs = Demultiplexer.predict_posteriors(*data["port"], doublet_prior=doublet_prior)
    np.testing.assert_array_equal(logits.values, single_logits.values)
    np.testing.assert_array_equal(probs.values, single_probs.values)
    assert list(logits.index) == list(single_logits.index)


# -- learn -----------------------------------------------------------------

LEARN_CASES = {
    "plain": dict(),
    "plain-doublets": dict(doublet_prior=0.25),
    "anchor": dict(damping="anchor"),
    "prior-logits": dict(barcode_prior_logits=True),
}


def _learn_inputs(case, data, erased):
    kwargs = dict(LEARN_CASES[case])
    sides = erased[0] if case in ("anchor", "prior-logits") else data
    if case == "prior-logits":
        handler = sides["port"][2]
        kwargs["barcode_prior_logits"] = _prior_logits(handler, len(sides["port"][1].genotype_names))
    return sides, kwargs


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_learn_matches_jax_sharded_and_single_device(data, erased, jax_engine, case):
    sides, kwargs = _learn_inputs(case, data, erased)
    learnt, probs = engine().learn_genotypes(*sides["port"], n_iterations=3, **kwargs)
    jax_learnt, jax_probs = jax_engine.learn_genotypes(*sides["jax"], n_iterations=3, **kwargs)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-4)
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), **BETAS_TOL)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))
    single_learnt, single_probs = Demultiplexer.learn_genotypes(*sides["port"], n_iterations=3, **kwargs)
    assert list(probs.columns) == list(single_probs.columns) and list(probs.index) == list(single_probs.index)
    np.testing.assert_allclose(probs.values, single_probs.values, atol=EM_SINGLE_ATOL)
    np.testing.assert_allclose(learnt.get_betas(), single_learnt.get_betas(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(probs.values.argmax(1), single_probs.values.argmax(1))
    if case == "anchor":
        rows = erased[1]
        original = sides["port"][1].get_betas()
        # erased variants received no addition on either engine
        assert np.all(learnt.get_betas()[rows] == original[rows])
        assert np.all(jax_learnt.get_betas()[rows] == original[rows])


def test_unknown_damping_raises(data):
    sharded = engine()
    with pytest.raises(ValueError, match="damping must be"):
        sharded.learn_genotypes(*data["port"], damping="bogus")
    with pytest.raises(ValueError, match="learn_genotypes"):
        next(sharded.staged_genotype_learning(*data["port"], damping="auto"))


def test_staged_learning_per_iteration(data):
    """Iteration 0's logits are the single-device engine's bits; later ones within the bars."""
    ours = list(engine().staged_genotype_learning(*data["port"], n_iterations=3, doublet_prior=0.35))
    theirs = list(Demultiplexer.staged_genotype_learning(*data["port"], n_iterations=3, doublet_prior=0.35))
    assert len(ours) == len(theirs) == 3
    np.testing.assert_array_equal(ours[0][1]["barcode_logits"], theirs[0][1]["barcode_logits"])
    np.testing.assert_array_equal(ours[0][0].values, theirs[0][0].values)
    for (probs, debug), (single_probs, single_debug) in zip(ours, theirs):
        np.testing.assert_allclose(probs.values, single_probs.values, atol=EM_SINGLE_ATOL)
        np.testing.assert_allclose(debug["barcode_logits"], single_debug["barcode_logits"], **LOGITS_TOL)
        np.testing.assert_allclose(debug["genotype_addition"], single_debug["genotype_addition"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(debug["genotype_prior"], single_debug["genotype_prior"])
    np.testing.assert_array_equal(ours[0][1]["genotype_addition"], 0.0)


def test_auto_damping_packs_once(erased, jax_engine):
    sides = erased[0]
    sharded = engine()
    learnt, probs = sharded.learn_genotypes(*sides["port"], n_iterations=2, damping="auto")
    jax_learnt, jax_probs = jax_engine.learn_genotypes(*sides["jax"], n_iterations=2, damping="auto")
    assert probs.attrs["damping_selected"] == jax_probs.attrs["damping_selected"]
    assert abs(probs.attrs["anchored_disagreement"] - jax_probs.attrs["anchored_disagreement"]) <= 1e-6
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-4)
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), **BETAS_TOL)
    # two EM runs, the second on the first's layouts: one E-step and one M-step build
    assert sharded.layout_cache_misses == 2, (sharded.layout_cache_misses, sharded.layout_cache_hits)
    assert sharded.layout_cache_hits >= 2
    single = Demultiplexer.learn_genotypes(*sides["port"], n_iterations=2, damping="auto")[1]
    assert single.attrs["damping_selected"] == probs.attrs["damping_selected"]
    np.testing.assert_allclose(probs.values, single.values, atol=EM_SINGLE_ATOL)


# -- compact, caches, timings ----------------------------------------------

def test_compact_matches_full_frame(data):
    calls, genotypes, handler = data["port"]
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    sharded = engine()
    logits_df, probs_df = sharded.predict_posteriors(packed, genotypes, handler, doublet_prior=0.35)
    compact = sharded.predict_posteriors_compact(packed, genotypes, handler, doublet_prior=0.35, k=3,
                                                 include_logits=True)
    full = logits_df.values
    rows = np.arange(full.shape[0])[:, None]
    np.testing.assert_array_equal(compact.assignment, full.argmax(axis=1))
    np.testing.assert_array_equal(compact.top_logits, full[rows, compact.top_index])
    np.testing.assert_allclose(compact.top_probs[:, 0], probs_df.values[rows[:, 0], compact.assignment], atol=1e-5)
    assert compact.bytes_moved < full.nbytes + full.nbytes // 2
    assert list(compact.to_dataframe().index) == list(logits_df.index)
    assert compact.logits_bf16.dtype == torch.bfloat16
    assert torch.equal(compact.logits_bf16, torch.tensor(full).to(torch.bfloat16))
    # the single-device engine's compact result, bit for bit
    single = Demultiplexer.predict_posteriors_compact(packed, genotypes, handler, doublet_prior=0.35, k=3)
    for field in ("top_index", "top_logits", "logsumexp"):
        np.testing.assert_array_equal(getattr(compact, field), getattr(single, field))


def test_layout_cache_predict_after_learn_lays_out_nothing(data):
    calls, genotypes, handler = data["port"]
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    sharded = engine()
    sharded.learn_genotypes(packed, genotypes, handler, n_iterations=2)
    assert (sharded.layout_cache_misses, sharded.layout_cache_hits) == (2, 0)
    logits, _ = sharded.predict_posteriors(packed, genotypes, handler, doublet_prior=0.35)
    assert (sharded.layout_cache_misses, sharded.layout_cache_hits) == (2, 1)
    sharded.learn_genotypes(packed, genotypes, handler, n_iterations=2)
    assert (sharded.layout_cache_misses, sharded.layout_cache_hits) == (2, 3)
    # another mesh lays out its own shards
    other = engine(3)
    other.predict_posteriors(packed, genotypes, handler, doublet_prior=0.35)
    assert other.layout_cache_misses == 1
    # the same frame as a fresh engine on the unpacked calls
    fresh_logits, _ = engine().predict_posteriors(calls, genotypes, handler, doublet_prior=0.35)
    np.testing.assert_array_equal(logits.values, fresh_logits.values)


def test_stage_timings_keys(data, monkeypatch):
    sharded = engine()
    monkeypatch.setattr(demux, "STAGE_TIMINGS", {})
    _, probs_timed = sharded.predict_posteriors(*data["port"], doublet_prior=0.35)
    predict_detail = demux.STAGE_TIMINGS
    monkeypatch.setattr(demux, "STAGE_TIMINGS", {})
    sharded.learn_genotypes(*data["port"], n_iterations=2)
    learn_detail = demux.STAGE_TIMINGS
    monkeypatch.setattr(demux, "STAGE_TIMINGS", {})
    sharded.predict_posteriors_compact(*data["port"])
    compact_detail = demux.STAGE_TIMINGS
    monkeypatch.setattr(demux, "STAGE_TIMINGS", None)
    for key in ("pack_s", "layout_s", "upload_flush_s", "forward_s", "materialize_s", "h2d_bytes",
                "d2h_logits_bytes"):
        assert key in predict_detail, (key, predict_detail)
    for key in ("pack_s", "layout_s", "upload_flush_s", "device_loop_s", "materialize_s", "h2d_bytes",
                "d2h_addition_bytes"):
        assert key in learn_detail, (key, learn_detail)
    assert {"forward_s", "materialize_s", "d2h_compact_bytes"} <= set(compact_detail)
    assert predict_detail["h2d_bytes"] > 0
    # instrumentation changes no result
    np.testing.assert_array_equal(sharded.predict_posteriors(*data["port"], doublet_prior=0.35)[1].values,
                                  probs_timed.values)


# -- datasets and meshes ---------------------------------------------------

def test_column_dataset_lays_out_as_packed_calls(data):
    calls, genotypes, handler = data["port"]
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    # raw columns in (vid, cb) order: the dataset sorts them by barcode itself
    raw = (packed.calls_v.cb, packed.calls_v.vid, packed.calls_v.q)
    columns = ColumnDataset(*raw)
    for ours, theirs, packed_column in zip(columns.calls_by_barcode(), JaxColumnDataset(*raw).calls_by_barcode(),
                                           packed.calls_by_barcode()):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ours, packed_column)
    sharded = engine()
    dims = (handler.n_barcodes, genotypes.n_genotypes, packed.n_variants)
    from_packed = sharded._shard_layouts(packed, *dims, build_mstep=True)
    from_columns = sharded._shard_layouts(columns, *dims, build_mstep=True)
    assert sharded.layout_cache_misses == 4  # each dataset keeps its own layouts
    for ours, theirs in zip(from_columns[0], from_packed[0]):
        assert all(torch.equal(a, b) for a, b in zip(ours[1:], theirs[1:]))
    for ours, theirs in zip(from_columns[1], from_packed[1]):
        assert ours.n_barcodes == theirs.n_barcodes
        assert all(torch.equal(a, b) for a, b in zip(ours.tensors(), theirs.tensors()))
    assert sum(int(o.vid.shape[0]) for o in from_columns[1]) == len(packed.calls_v)


def test_more_shards_than_barcodes_and_shards_without_calls(data):
    """Shards past the last barcode, and a whole shard of barcodes without reads, give the penalties."""
    calls, genotypes, handler = data["port"]
    # 100 whitelisted barcodes with no reads sort after the real ones: with
    # 4 shards of 75, shard 3 holds only barcodes without calls
    padded_handler = BarcodeHandler(list(handler.ordered_barcodes) + [f"ZZZ{i:03d}" for i in range(100)])
    assert list(padded_handler.ordered_barcodes[:200]) == list(handler.ordered_barcodes)
    penalties = L.doublet_penalties(genotypes.n_genotypes, 0.35)
    for sharded, which in ((engine(4), padded_handler), (engine(301), padded_handler), (engine(203), handler)):
        logits, probs = sharded.predict_posteriors(calls, genotypes, which, doublet_prior=0.35)
        single_logits, single_probs = Demultiplexer.predict_posteriors(calls, genotypes, which, doublet_prior=0.35)
        np.testing.assert_array_equal(logits.values, single_logits.values)
        np.testing.assert_array_equal(logits.values[200:], np.broadcast_to(penalties, (which.n_barcodes - 200,
                                                                                       len(penalties))))
        learnt, em_probs = sharded.learn_genotypes(calls, genotypes, which, n_iterations=2)
        single_learnt, single_em = Demultiplexer.learn_genotypes(calls, genotypes, which, n_iterations=2)
        np.testing.assert_allclose(em_probs.values, single_em.values, atol=EM_SINGLE_ATOL)
        np.testing.assert_allclose(learnt.get_betas(), single_learnt.get_betas(), rtol=1e-5, atol=1e-5)
        compact = sharded.predict_posteriors_compact(calls, genotypes, which, doublet_prior=0.35)
        np.testing.assert_array_equal(compact.assignment, single_logits.values.argmax(1))


@pytest.mark.parametrize("entry", ["predict", "compact", "learn", "staged", "auto"])
def test_aggregate_on_snps_raises(data, monkeypatch, entry):
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    sharded = engine()
    run = {
        "predict": lambda: sharded.predict_posteriors(*data["port"]),
        "compact": lambda: sharded.predict_posteriors_compact(*data["port"]),
        "learn": lambda: sharded.learn_genotypes(*data["port"]),
        "staged": lambda: next(sharded.staged_genotype_learning(*data["port"])),
        "auto": lambda: sharded.learn_genotypes(*data["port"], damping="auto"),
    }[entry]
    with pytest.raises(ValueError, match="aggregate-on-SNPs"):
        run()


def test_mesh_helpers_on_one_process():
    mesh = make_mesh([CPU, CPU, "cpu"])
    assert mesh.n_shards == 3 and mesh.group is None and local_shard_ids(mesh) == [0, 1, 2]
    assert allreduce_max_dims([3, -1, 7], mesh) == [3, -1, 7]
    blocks = [torch.full((2, 3), float(k)) for k in range(3)]
    np.testing.assert_array_equal(to_host(blocks, mesh).numpy(), np.repeat(np.arange(3.0), 2)[:, None] * np.ones(3))
    with pytest.raises(ValueError):
        make_mesh([])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh exists")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedDemultiplexer()
