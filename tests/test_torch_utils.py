"""The port's utils, the Demultiplexer's helper statics and STAGE_TIMINGS against the JAX package.

Utils (``FeatureLookup``, ``Timer``, ``summarize_counted_SNPs``,
``compute_qualities``) must give the JAX functions' results exactly. The
helper statics are held to tests/test_likelihood_ops.py's cases: genotype
probabilities rtol=1e-5, atol=1e-7 against the oracle; logits rtol=1e-4,
atol=5e-3. ``STAGE_TIMINGS`` is off by default, records the keys the JAX
suite pins (tests/test_synthetic.py:336-341) and changes no bit.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from demuxalot_tpu import Demultiplexer as JaxDemultiplexer
from demuxalot_tpu.frontend.snp_counter import count_snps as jax_count_snps
from demuxalot_tpu.ops import packing as JP
from demuxalot_tpu.sim import generate_bam_file as jax_generate_bam_file
from demuxalot_tpu.utils import compute_qualities as jax_compute_qualities
from demuxalot_tpu.utils import summarize_counted_SNPs as jax_summarize_counted_SNPs
from demuxalot_tpu.utils.lookup import FeatureLookup as JaxFeatureLookup
from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, convert
from demuxalot_tpu_torch.models import demux as demux_mod
from demuxalot_tpu_torch.ops import packing as P
from demuxalot_tpu_torch.utils import (
    FeatureLookup, GatherRoofline, MStepRoofline, Roofline, Timer, compute_qualities, device_trace,
    summarize_counted_SNPs,
)
from oracle import iterate_pseudogenotypes, oracle_barcode_logits, oracle_probs_from_betas

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")


def test_feature_lookup_matches_jax():
    rng = np.random.RandomState(0)
    a, b, c = rng.randint(0, 50, 2000), rng.randint(0, 7, 2000), rng.randint(0, 300, 2000)
    ours, theirs = FeatureLookup(a, b, c), JaxFeatureLookup(a, b, c)
    assert ours.nvalues == theirs.nvalues
    for x, y in zip(ours.compress(a, b, c), theirs.compress(a, b, c)):
        np.testing.assert_array_equal(x, y)
    dense, _counts = ours.compress(a, b, c)
    for x, y, z in zip(ours.uncompress(dense), theirs.uncompress(dense), (a, b, c)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    for x, y in zip(ours.lookup_for_individual_features(), theirs.lookup_for_individual_features()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(KeyError):  # (1, 0) was not seen at construction
        FeatureLookup(np.array([0, 1]), np.array([0, 1])).compress(np.array([1]), np.array([0]))
    with pytest.raises(ValueError):
        FeatureLookup()


def test_timer(capsys):
    with Timer("counting") as timer:
        sum(range(1000))
    assert timer.time_taken >= 0
    assert capsys.readouterr().out.startswith("counting: ")
    with Timer("quiet", quiet=True) as quiet:
        pass
    assert capsys.readouterr().out == "" and quiet.time_taken >= 0


@pytest.fixture(scope="module")
def bam_data(tmp_path_factory):
    np.random.seed(7)
    filename = str(tmp_path_factory.mktemp("bam") / "u.bam")
    filename, genotypes, _ids, names = jax_generate_bam_file(
        filename, n_genotypes=3, n_barcodes=40, n_reads_per_barcode=30, chromosome2length={"chr1": 500, "chr2": 400},
    )
    from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler

    calls = jax_count_snps(filename, genotypes.get_chromosome2positions(), JaxBarcodeHandler(list(names)),
                           joblib_n_jobs=None, joblib_verbosity=0)
    return genotypes, calls, list(names)


def test_summarize_counted_snps_matches_jax(bam_data):
    _genotypes, calls, _names = bam_data
    ours = summarize_counted_SNPs(convert.calls_from(calls), show_plot=False)
    theirs = jax_summarize_counted_SNPs(calls, show_plot=False)
    pd.testing.assert_frame_equal(ours, theirs)
    assert (ours["n_molecules"] > 0).all()


def test_compute_qualities_matches_jax():
    rng = np.random.RandomState(2)
    names = ["D1", "D2", "D3", "D1+D2"]
    values = rng.rand(30, 4)
    probs = pd.DataFrame(values / values.sum(axis=1, keepdims=True), index=[f"b{i}" for i in range(30)],
                         columns=names)
    truth = {f"b{i}": [names[i % 4]] if i % 5 else ["D1", "D1+D2"] for i in range(30)}
    assert compute_qualities(probs, truth) == jax_compute_qualities(probs, truth)
    fixed = pd.DataFrame([[0.9, 0.1], [0.2, 0.8], [0.5, 0.5]], index=["b1", "b2", "b3"], columns=["D1", "D2"])
    metrics = compute_qualities(fixed, {"b1": ["D1"], "b2": ["D2"], "b3": ["D1", "D2"]})
    assert metrics["accuracy"] == 1.0 and metrics["logloss"] > 0


def _random_problem(seed=0, n_snps=200, n_donors=6, n_barcodes=300, n_calls=8000):
    """tests/test_likelihood_ops.py's problem."""
    rng = np.random.RandomState(seed)
    n_variants = n_snps * 2
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), 2)
    betas = (rng.rand(n_variants, n_donors) * 50).astype(np.float32)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    cb = np.sort(rng.randint(0, n_barcodes, n_calls)).astype(np.int32)
    q = (rng.rand(n_calls) * 0.5).astype(np.float32)
    names = [f"Donor{i:02}" for i in range(n_donors)]
    return names, variant2snp, betas, vid, cb, q, n_barcodes, n_snps


def test_demultiplexer_parity_helpers():
    """tests/test_likelihood_ops.py:246-274 on the port's statics."""
    names, variant2snp, betas, vid, cb, q, n_barcodes, _ = _random_problem()
    gprob = Demultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01)
    np.testing.assert_allclose(gprob, oracle_probs_from_betas(variant2snp, betas, 0.01), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gprob, JaxDemultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01),
                               rtol=1e-5, atol=1e-7)

    got = list(Demultiplexer._iterate_genotypes_options(names, gprob, 0.35))
    ref = list(iterate_pseudogenotypes(names, gprob, 0.35))
    assert [(i, n) for i, n, _ in got] == [(i, n) for i, n, _ in ref]
    for (_, _, a), (_, _, b) in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6)

    rec = np.recarray(len(vid), dtype=P.BARCODE_CALLS_DTYPE)
    rec["variant_id"], rec["compressed_cb"], rec["p_base_wrong"] = vid, cb, q
    rec["snp_id"] = variant2snp[vid]
    rec["barcode_variant_count"] = 1
    rec["barcode_snp_count"] = 1
    # shuffled rows: the static sorts by barcode itself
    shuffled = rec[np.random.RandomState(1).permutation(len(rec))]
    logits, cols = Demultiplexer.compute_barcode_logits_using_barcode_calls(
        names, shuffled, 0.35, gprob, n_barcodes, len(names))
    ref_logits, ref_cols = oracle_barcode_logits(names, gprob, vid, cb, q, n_barcodes, 0.35)
    assert cols == ref_cols
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=5e-3)
    dispatched, _ = Demultiplexer.compute_barcode_logits(names, shuffled, None, 0.35, gprob, n_barcodes, len(names))
    np.testing.assert_array_equal(dispatched, logits)
    np.testing.assert_array_equal(Demultiplexer._doublet_penalties(6, 0.35),
                                  JaxDemultiplexer._doublet_penalties(6, 0.35))


def test_compute_probs_from_betas_on_shuffled_snps():
    """A shuffled, non-contiguous variant2snp (SNPs of 1 to 5 variants, some SNP ids unused) takes the
    fixed-order segment sum: within 1e-6 of the JAX package's helper and of the oracle."""
    rng = np.random.RandomState(4)
    variant2snp = np.repeat(np.arange(0, 600, 3), rng.randint(1, 6, 200)).astype(np.int32)
    variant2snp = variant2snp[rng.permutation(len(variant2snp))]
    betas = (rng.rand(len(variant2snp), 7) * 50).astype(np.float32)
    gprob = Demultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01)
    np.testing.assert_allclose(gprob, JaxDemultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(gprob, oracle_probs_from_betas(variant2snp, betas, 0.01), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gprob, Demultiplexer._compute_probs_from_betas(variant2snp, betas, 0.01))


def test_compute_barcode_logits_aggregating_matches_jax(monkeypatch):
    names, variant2snp, betas, vid, _cb, q, n_barcodes, _ = _random_problem(n_calls=3000)
    cb = np.random.RandomState(4).randint(0, 40, len(vid)).astype(np.int32)  # unsorted, dense groups
    mc = dict(variant_id=vid, snp_id=variant2snp[vid], compressed_cb=cb, molecule_id=np.arange(len(vid), dtype=np.int32),
              p_base_wrong=q, p_molecule_aligned_wrong=np.full(len(vid), 0.01, np.float32))
    gprob = oracle_probs_from_betas(variant2snp, betas, 0.01)
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    monkeypatch.setattr(JaxDemultiplexer, "aggregate_on_snps", True)
    ours, cols = Demultiplexer.compute_barcode_logits(names, None, P.MoleculeCalls(**mc), 0.35, gprob, 40, len(names))
    theirs, jax_cols = JaxDemultiplexer.compute_barcode_logits(names, None, JP.MoleculeCalls(**mc), 0.35, gprob, 40,
                                                               len(names))
    assert cols == jax_cols
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=5e-3)


def test_pack_calls_matches_jax(bam_data):
    genotypes, calls, _names = bam_data
    port_calls, port_genotypes = convert.calls_from(calls), convert.genotypes_from(genotypes)
    theirs = JaxDemultiplexer.pack_calls(calls, genotypes, add_data_prior=True)
    packed = Demultiplexer.pack_dataset(port_calls, port_genotypes)
    for ours in (Demultiplexer.pack_calls(port_calls, port_genotypes, add_data_prior=True),
                 Demultiplexer.pack_calls(packed, port_genotypes, add_data_prior=True)):
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
        for field in ("variant_id", "snp_id", "compressed_cb", "molecule_id", "p_base_wrong"):
            np.testing.assert_array_equal(ours[2][field], theirs[2][field])
        assert ours[3].dtype == theirs[3].dtype
        np.testing.assert_array_equal(np.asarray(ours[3]), np.asarray(theirs[3]))
    np.testing.assert_array_equal(np.asarray(Demultiplexer.molecule_calls2barcode_calls(packed.molecule_calls)),
                                  np.asarray(theirs[3]))


@pytest.fixture
def port_dataset(bam_data):
    genotypes, calls, names = bam_data
    return convert.calls_from(calls), convert.genotypes_from(genotypes), BarcodeHandler(names)


@pytest.fixture
def timings(monkeypatch):
    """STAGE_TIMINGS as a dict for one test; None again afterwards."""
    assert demux_mod.STAGE_TIMINGS is None
    monkeypatch.setattr(demux_mod, "STAGE_TIMINGS", {})
    return lambda: demux_mod.STAGE_TIMINGS


def test_stage_timings_predict(port_dataset, timings):
    demux_mod.STAGE_TIMINGS = None
    _logits, probs_plain = Demultiplexer.predict_posteriors(*port_dataset, doublet_prior=0.35)
    demux_mod.STAGE_TIMINGS = {}
    _logits, probs_timed = Demultiplexer.predict_posteriors(*port_dataset, doublet_prior=0.35)
    detail = timings()
    np.testing.assert_array_equal(probs_plain.values, probs_timed.values)
    for key in ("pack_s", "layout_s", "upload_flush_s", "h2d_bytes", "forward_s", "materialize_s",
                "d2h_logits_s", "d2h_logits_bytes"):
        assert key in detail, (key, detail)
    assert detail["d2h_logits_bytes"] == probs_timed.values.nbytes
    assert detail["h2d_bytes"] > 0
    assert all(0 <= value < 600 for key, value in detail.items() if key.endswith("_s"))


def test_stage_timings_learn(port_dataset, timings):
    demux_mod.STAGE_TIMINGS = None
    learnt_plain, probs_plain = Demultiplexer.learn_genotypes(*port_dataset, n_iterations=2)
    demux_mod.STAGE_TIMINGS = {}
    learnt_timed, probs_timed = Demultiplexer.learn_genotypes(*port_dataset, n_iterations=2)
    detail = timings()
    np.testing.assert_array_equal(probs_plain.values, probs_timed.values)
    np.testing.assert_array_equal(learnt_plain.get_betas(), learnt_timed.get_betas())
    for key in ("pack_s", "layout_s", "upload_flush_s", "h2d_bytes", "device_loop_s", "materialize_s",
                "d2h_addition_s", "d2h_addition_bytes"):
        assert key in detail, (key, detail)
    assert detail["d2h_addition_bytes"] == learnt_timed.get_betas().nbytes
    assert all(0 <= value < 600 for key, value in detail.items() if key.endswith("_s"))


def test_stage_timings_compact_and_off_by_default(port_dataset, timings):
    compact_timed = Demultiplexer.predict_posteriors_compact(*port_dataset, k=2)
    detail = timings()
    assert detail["d2h_compact_bytes"] == compact_timed.bytes_moved
    assert {"pack_s", "forward_s", "materialize_s"} <= set(detail)
    demux_mod.STAGE_TIMINGS = None
    compact = Demultiplexer.predict_posteriors_compact(*port_dataset, k=2)
    np.testing.assert_array_equal(compact.top_logits, compact_timed.top_logits)
    assert demux_mod.STAGE_TIMINGS is None


def test_roofline_counts():
    """Bytes and operations at a small shape, and which bound wins."""
    estep = Roofline(n_calls=1000, n_donors=4, n_pseudogenotypes=10, n_barcodes=50, n_variants=200)
    assert estep.bytes_moved() == 8 * 1000 + 8 * 51 + 4 * 200 * 4 + 12 * 10 + 4 * 50 * 10
    assert estep.operations() == 1000 * (4 * 10 + 3 * 4)
    bounds = estep.estimate_seconds()
    assert bounds["hbm_bound_s"] == estep.bytes_moved() / 3.35e12
    assert bounds["fp32_bound_s"] == estep.operations() / 67e12
    assert estep.speed_of_light_s() == max(bounds.values())
    assert estep.bound_by() == "bytes"
    wide = Roofline(n_calls=4_192_362, n_donors=32, n_pseudogenotypes=528, n_barcodes=65_536, n_variants=131_072)
    assert wide.bound_by() == "operations"
    mstep = MStepRoofline(n_calls=1000, n_donors=4, n_barcodes=50, n_variants=200)
    assert mstep.bytes_moved() == 8 * 1000 + 8 * 201 + 4 * 50 * 4 + 4 * 200 * 4
    assert mstep.operations() == 3 * 1000 * 4 and mstep.bound_by() == "bytes"


def test_estep_roofline_counts_the_fused_softmax():
    """Bench shape (32 donors, 528 columns, 65,536 barcodes, 4,192,362 calls): the fused softmax adds the
    probs written and 5 operations per (barcode, column); a prior adds its read and an add."""
    shape = dict(n_calls=4_192_362, n_donors=32, n_pseudogenotypes=528, n_barcodes=65_536, n_variants=131_072)
    logits = Roofline(**shape)
    assert logits.operations() == 9_256_735_296 and logits.bytes_moved() == 189_258_776
    cells = 65_536 * 528
    fused = Roofline(**shape, softmax=True)
    assert fused.operations() == logits.operations() + 5 * cells == 9_429_750_336
    assert fused.bytes_moved() == logits.bytes_moved() + 4 * cells == 327_670_808
    with_prior = Roofline(**shape, softmax=True, prior=True)
    assert with_prior.operations() == fused.operations() + cells
    assert with_prior.bytes_moved() == fused.bytes_moved() + 4 * cells
    assert fused.bound_by() == "operations"
    assert fused.speed_of_light_s() == fused.operations() / 67e12


def test_banded_and_gather_roofline_counts():
    """The banded kernels are held to the function's own work, the unbanded bounds (a band layout is the
    kernel's choice, not work the function must do); a gather counts each touched row once."""
    for bound in (Roofline, MStepRoofline):
        assert "n_bands" not in bound.__dataclass_fields__
    mstep = MStepRoofline(n_calls=1000, n_donors=4, n_barcodes=50, n_variants=200)
    assert mstep.bytes_moved() == 8 * 1000 + 8 * 201 + 4 * 50 * 4 + 4 * 200 * 4
    rows = GatherRoofline(n_idx=1 << 20, n_rows_touched=8192, width=64, rows_out=True)
    assert rows.bytes_moved() == 4 * (1 << 20) + 4 * 8192 * 64 + 4 * (1 << 20) * 64
    assert rows.operations() == 0 and rows.bound_by() == "bytes"
    total = GatherRoofline(n_idx=1 << 20, n_rows_touched=8192, width=64, rows_out=False)
    assert total.bytes_moved() == 4 * (1 << 20) + 4 * 8192 * 64 + 4
    assert total.operations() == (1 << 20) * 64


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
