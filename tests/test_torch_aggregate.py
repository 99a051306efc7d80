"""The aggregate-on-SNPs path of the port against the JAX package.

``snp_aggregated_logits`` runs on both packages' ops at D in {1, 4} and
doublet prior in {0, 0.35}, on molecule calls where several molecules share
a (barcode, SNP) group, and against the float64 numpy oracle. The engine
(predict, compact, learn with damping None, "anchor" and "auto") runs on
the JAX package's synthetic BAM with ``aggregate_on_snps = True`` on both
sides. Tolerances: logits rtol=1e-4, atol=5e-3; posteriors atol=3e-5;
identical argmax; learnt betas rtol=1e-4, atol=1e-2 (additions to 4
decimals). The JAX suite's two gates (tests/test_synthetic.py:252-285) run
on the port's own BAM and counter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu import Demultiplexer as JaxDemultiplexer
from demuxalot_tpu.frontend.snp_counter import count_snps as jax_count_snps
from demuxalot_tpu.models.demux import PackedCalls as JaxPackedCalls
from demuxalot_tpu.models.demux import _SnpAggregationLayout as JaxLayout
from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu.sim import generate_bam_file as jax_generate_bam_file
from demuxalot_tpu.utils.lookup import FeatureLookup as JaxFeatureLookup
from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, convert, count_snps, sim
from demuxalot_tpu_torch.ops import likelihood as L
from demuxalot_tpu_torch.utils.lookup import FeatureLookup
from oracle import oracle_snp_aggregated_logits

torch.set_num_threads(1)

LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)
POSTERIOR_ATOL = 3e-5


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")


@pytest.fixture
def aggregate_on(monkeypatch):
    """aggregate_on_snps = True on both packages for one test."""
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    monkeypatch.setattr(JaxDemultiplexer, "aggregate_on_snps", True)
    monkeypatch.setattr(JaxDemultiplexer, "use_pallas", False)


def _grouped_calls(seed, n_variants=60, n_barcodes=17, n_calls=900):
    """Molecule calls over few barcodes and SNPs, so groups hold several molecules."""
    rng = np.random.RandomState(seed)
    vid = rng.randint(0, n_variants, n_calls).astype(np.int32)
    snp_id = (vid // 2).astype(np.int32)
    cb = rng.randint(0, n_barcodes, n_calls).astype(np.int32)
    q = rng.uniform(1e-5, 0.3, n_calls).astype(np.float32)
    return vid, snp_id, cb, q


@pytest.mark.parametrize("n_donors", [1, 4])
@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_snp_aggregated_logits_matches_jax(n_donors, doublet_prior):
    n_variants, n_barcodes = 60, 20  # calls reach barcodes 0..16 only
    vid, snp_id, cb, q = _grouped_calls(n_donors + int(doublet_prior * 100))
    gp = np.random.RandomState(3).uniform(0.01, 0.99, (n_variants, n_donors)).astype(np.float32)
    mixing, _ = L.pseudogenotype_mixing([f"D{i}" for i in range(n_donors)], doublet_prior)

    groups = FeatureLookup(cb, snp_id)
    gid, counts = groups.compress(cb, snp_id)
    barcode_of_group, _ = groups.lookup_for_individual_features()
    assert counts.max() > 1, "several molecules must share a (barcode, snp) group"
    jax_groups = JaxFeatureLookup(cb, snp_id)
    jax_gid, jax_counts = jax_groups.compress(cb, snp_id)
    np.testing.assert_array_equal(gid, jax_gid)
    np.testing.assert_array_equal(counts, jax_counts)
    order = np.argsort(gid, kind="stable")
    jax_operands = (vid[order], q[order], gid[order].astype(np.int32), barcode_of_group.astype(np.int32),
                    counts.astype(np.float32))
    want = np.asarray(JL.snp_aggregated_logits(
        jnp.asarray(gp), jnp.asarray(mixing), *(jnp.asarray(a) for a in jax_operands),
        n_groups=groups.nvalues, n_barcodes=n_barcodes, compensation=0.5, call_chunk=128,
    ))
    # the port's CSR form of the same groups; chunks of 7 calls split no group
    group_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    for call_chunk in (7, 128, L.DEFAULT_CALL_CHUNK):
        got = L.snp_aggregated_logits(
            torch.from_numpy(gp), torch.from_numpy(mixing), torch.from_numpy(vid[order]), torch.from_numpy(q[order]),
            group_ptr, torch.from_numpy(counts.astype(np.int64)),
            torch.from_numpy(np.bincount(barcode_of_group, minlength=n_barcodes).astype(np.int64)),
            compensation=0.5, call_chunk=call_chunk,
        ).numpy()
        np.testing.assert_allclose(got, want, **LOGITS_TOL)
    oracle = oracle_snp_aggregated_logits(gp, mixing, vid, q, cb, snp_id, n_barcodes)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    # barcodes with no call keep zero logits; no doublet penalty is added
    empty = np.setdiff1d(np.arange(n_barcodes), cb)
    assert len(empty) > 0
    np.testing.assert_array_equal(got[empty], 0.0)


def test_group_chunks_split_between_groups():
    group_ptr = np.array([0, 3, 4, 12, 13, 14, 20], dtype=np.int64)
    chunks = list(L.group_chunks(group_ptr, 5))
    assert chunks == [(0, 2), (2, 3), (3, 5), (5, 6)]
    # every group in exactly one chunk, each chunk within 5 calls unless it is one larger group
    assert [g for g0, g1 in chunks for g in range(g0, g1)] == list(range(6))
    assert all(group_ptr[g1] - group_ptr[g0] <= 5 or g1 == g0 + 1 for g0, g1 in chunks)
    assert list(L.group_chunks(np.zeros(1, np.int64), 5)) == []


@pytest.fixture(scope="module")
def bam_data(tmp_path_factory):
    """The JAX package's synthetic BAM, counted: (genotypes, calls, barcode names)."""
    np.random.seed(3)
    filename = str(tmp_path_factory.mktemp("bam") / "t.bam")
    filename, genotypes, _ids, names = jax_generate_bam_file(
        filename, n_genotypes=4, n_barcodes=80, n_reads_per_barcode=30, chromosome2length={"chr1": 600},
    )
    calls = jax_count_snps(filename, genotypes.get_chromosome2positions(), JaxBarcodeHandler(list(names)),
                           joblib_n_jobs=None, joblib_verbosity=0)
    return genotypes, calls, list(names)


@pytest.fixture(scope="module")
def dataset(bam_data):
    """Both packages' inputs, the variant registry in shuffled order.

    Shuffled, a SNP's variants are not adjacent in the registry, so the
    device (SNP-sorted) variant order differs from it and a layout that
    skipped the remap would read the wrong genotype rows.
    """
    from demuxalot_tpu.models.genotypes import ProbabilisticGenotypes as JaxGenotypes

    genotypes, calls, names = bam_data
    arrays = convert.genotypes_to_arrays(genotypes)
    order = np.random.RandomState(0).permutation(len(arrays["pos"]))
    rows = {key: arrays[key][order] for key in ("chrom", "pos", "base", "betas")}
    jax_genotypes = JaxGenotypes(arrays["genotype_names"], default_prior=arrays["default_prior"])
    for c, p, b in zip(rows["chrom"], rows["pos"], rows["base"]):
        jax_genotypes.get_variant_id(c, int(p), b)
    jax_genotypes = jax_genotypes._with_betas(rows["betas"])
    port_genotypes = convert.genotypes_from_arrays(arrays["genotype_names"], **rows,
                                                   default_prior=arrays["default_prior"])
    return {
        "jax": (calls, jax_genotypes, JaxBarcodeHandler(names)),
        "port": (convert.calls_from(calls), port_genotypes, BarcodeHandler(names)),
    }


def test_layout_groups_equal_jax(dataset):
    """The cached layout: JAX's groups, on molecule calls remapped to device order."""
    calls, genotypes, _ = dataset["port"]
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    layout = packed.snp_aggregation_layout(torch.device("cpu"))
    assert packed.snp_aggregation_layout(torch.device("cpu")) is layout  # built once per device
    jax_packed = JaxPackedCalls(*dataset["jax"][:2])
    molecule_calls = jax_packed.molecule_calls
    remapped = type(molecule_calls)(**{**vars(molecule_calls), "variant_id": jax_packed.reindex.remap_variant_ids(
        molecule_calls.variant_id)})
    theirs = JaxLayout.build(remapped)
    # the CSR run lengths expand to JAX's group of every call and barcode of every group
    calls_per_group, groups_per_barcode = np.diff(layout.group_ptr.numpy()), np.diff(layout.barcode_ptr.numpy())
    np.testing.assert_array_equal(layout.group_ptr[[0, -1]], [0, len(layout.vid)])  # every call in one group
    for ours, name in ((layout.vid.numpy(), "vid_by_group"), (layout.q.numpy(), "q_by_group"),
                       (np.repeat(np.arange(len(calls_per_group)), calls_per_group), "group_of_call"),
                       (np.repeat(np.arange(len(groups_per_barcode)), groups_per_barcode), "barcode_of_group"),
                       (calls_per_group.astype(np.float32), "calls_per_group")):
        np.testing.assert_array_equal(ours, np.asarray(getattr(theirs, name)))
    assert layout.n_groups == theirs.n_groups
    assert calls_per_group.max() > 1, "several molecules share a (barcode, snp) group"
    # the remap is real: registry and device variant orders differ on this data
    assert not np.array_equal(packed.reindex.order, np.arange(packed.n_variants))


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_predict_posteriors_matches_jax(dataset, aggregate_on, doublet_prior):
    logits, probs = Demultiplexer.predict_posteriors(*dataset["port"], doublet_prior=doublet_prior)
    jax_logits, jax_probs = JaxDemultiplexer.predict_posteriors(*dataset["jax"], doublet_prior=doublet_prior)
    assert list(logits.index) == list(jax_logits.index) and list(logits.columns) == list(jax_logits.columns)
    np.testing.assert_allclose(logits.values, jax_logits.values, **LOGITS_TOL)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=POSTERIOR_ATOL)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))


@pytest.mark.parametrize("k", [1, 4])
def test_predict_posteriors_compact_matches_jax(dataset, aggregate_on, k):
    ours = Demultiplexer.predict_posteriors_compact(*dataset["port"], doublet_prior=0.35, k=k)
    theirs = JaxDemultiplexer.predict_posteriors_compact(*dataset["jax"], doublet_prior=0.35, k=k)
    np.testing.assert_array_equal(ours.assignment, theirs.assignment)
    np.testing.assert_allclose(ours.top_logits, theirs.top_logits, **LOGITS_TOL)
    np.testing.assert_allclose(ours.logsumexp, theirs.logsumexp, **LOGITS_TOL)
    np.testing.assert_allclose(ours.top_probs, theirs.top_probs, atol=POSTERIOR_ATOL)
    # compact keeps its tie rule over the aggregated frame
    logits, _probs, _ = Demultiplexer.predict_posteriors_core(*dataset["port"], doublet_prior=0.35)
    np.testing.assert_array_equal(ours.assignment, logits.numpy().argmax(axis=1))


@pytest.mark.parametrize("damping", [None, "anchor", "auto"])
def test_learn_genotypes_matches_jax(dataset, aggregate_on, damping):
    learnt, probs = Demultiplexer.learn_genotypes(*dataset["port"], n_iterations=3, damping=damping)
    jax_learnt, jax_probs = JaxDemultiplexer.learn_genotypes(*dataset["jax"], n_iterations=3, damping=damping)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=POSTERIOR_ATOL)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), rtol=1e-4, atol=1e-2)
    additions = learnt.get_betas() - dataset["port"][1].get_betas()
    jax_additions = jax_learnt.get_betas() - dataset["jax"][1].get_betas()
    np.testing.assert_allclose(additions, jax_additions, atol=1e-4)
    assert probs.attrs == jax_probs.attrs


def test_staged_learning_matches_jax(dataset, aggregate_on):
    ours = list(Demultiplexer.staged_genotype_learning(*dataset["port"], n_iterations=2, doublet_prior=0.25))
    theirs = list(JaxDemultiplexer.staged_genotype_learning(*dataset["jax"], n_iterations=2, doublet_prior=0.25))
    for (probs, debug), (jax_probs, jax_debug) in zip(ours, theirs):
        np.testing.assert_allclose(probs.values, jax_probs.values, atol=POSTERIOR_ATOL)
        np.testing.assert_allclose(debug["barcode_logits"], jax_debug["barcode_logits"], **LOGITS_TOL)
        np.testing.assert_allclose(debug["genotype_addition"], jax_debug["genotype_addition"], atol=1e-4)


def compute_loss(barcode2donor_names, barcode2probs):
    """Mean -log P(true donors), clipped (tests/test_synthetic.py)."""
    probs = barcode2probs * 0
    for barcode, correct_donors in barcode2donor_names.items():
        for donor in correct_donors:
            probs.loc[barcode, donor] = barcode2probs.loc[barcode, donor]
    p = probs.sum(axis=1)
    return -np.log(p.clip(1e-4)).mean()


@pytest.fixture(scope="module")
def synthetic_data(tmp_path_factory):
    """The JAX suite's synthetic shape on the port's own BAM writer and counter."""
    filename = str(tmp_path_factory.mktemp("bam") / "test.bam")
    filename, genotypes, _ids, barcode2donor_names = sim.generate_bam_file(
        filename, n_genotypes=12, doublets_fraction=0.2, mutation_prob=0.01, n_barcodes=600,
        n_reads_per_barcode=80, rng=42,
    )
    handler = BarcodeHandler(list(barcode2donor_names))
    calls = count_snps(filename, genotypes.get_chromosome2positions(), handler, joblib_n_jobs=1,
                       joblib_verbosity=0)
    return genotypes, barcode2donor_names, handler, calls


def test_aggregate_on_snps_path(synthetic_data, monkeypatch):
    """The per-SNP aggregation path also demultiplexes well."""
    genotypes, barcode2correct_donor, handler, calls = synthetic_data
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    _logits, probs = Demultiplexer.predict_posteriors(calls, genotypes, handler, doublet_prior=0.0)
    assert compute_loss(barcode2correct_donor, probs) < 1.0
    assert np.allclose(probs.sum(axis=1), 1, atol=1e-3)


def test_aggregate_on_snps_em_loop(synthetic_data, monkeypatch):
    """EM learning also runs through the per-SNP aggregation branch."""
    genotypes, barcode2correct_donor, handler, calls = synthetic_data
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    learnt, probs = Demultiplexer.learn_genotypes(calls, genotypes, handler, n_iterations=2)
    assert np.allclose(probs.sum(axis=1).values, 1, atol=1e-3)
    assert compute_loss(barcode2correct_donor, probs) < 1.0
    # learning only ever adds information on top of the frozen prior
    assert np.all(learnt.get_betas() >= genotypes.get_betas() - 1e-6)
