"""The port's whole slice against the JAX engine on the same inputs.

Data: the JAX package's own synthetic BAM (``generate_bam_file``) counted by
its ``count_snps``, as in tests/test_pallas_kernel.py, handed to the port
through ``demuxalot_tpu_torch.convert`` as numpy arrays. The JAX engine runs
both its XLA path and its Pallas kernels (interpret mode). Tolerances are
those the JAX tests hold its Pallas path to: logits rtol=1e-4, atol=5e-3;
posteriors atol=1e-5; learnt betas rtol=1e-4, atol=1e-2; identical argmax.
"""
import numpy as np
import pytest
import torch

from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu import Demultiplexer as JaxDemultiplexer
from demuxalot_tpu.frontend.snp_counter import count_snps
from demuxalot_tpu.models.demux import PackedCalls as JaxPackedCalls
from demuxalot_tpu.sim import generate_bam_file
from demuxalot_tpu_torch import BarcodeHandler, Demultiplexer, PackedCalls, convert
from demuxalot_tpu_torch.ops.packing import csr_row_pointers
from demuxalot_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

LEARN_CASES = {
    "plain": dict(damping=None, doublet_prior=0.0),
    "plain-doublets": dict(damping=None, doublet_prior=0.25),
    "anchor": dict(damping="anchor", doublet_prior=0.0),
    "anchor-doublets": dict(damping="anchor", doublet_prior=0.25),
    "prior-logits": dict(damping=None, doublet_prior=0.25, barcode_prior_logits=True),
}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")


@pytest.fixture(scope="module")
def bam_data(tmp_path_factory):
    """The JAX package's synthetic BAM, counted: (genotypes, calls, barcode names)."""
    np.random.seed(3)
    filename = str(tmp_path_factory.mktemp("bam") / "t.bam")
    filename, genotypes, _ids, names = generate_bam_file(
        filename, n_genotypes=4, n_barcodes=80, n_reads_per_barcode=30,
        chromosome2length={"chr1": 600},
    )
    calls = count_snps(
        filename, genotypes.get_chromosome2positions(), JaxBarcodeHandler(list(names)),
        joblib_n_jobs=None, joblib_verbosity=0,
    )
    return genotypes, calls, list(names)


def _both_sides(genotypes, calls, names):
    return {
        "jax": (calls, genotypes, JaxBarcodeHandler(names)),
        "port": (convert.calls_from(calls), convert.genotypes_from(genotypes), BarcodeHandler(names)),
    }


@pytest.fixture(scope="module")
def dataset(bam_data):
    """JAX-side calls, genotypes and handler, and the port's copies."""
    return _both_sides(*bam_data)


@pytest.fixture(scope="module")
def priorless_dataset(bam_data):
    """As :func:`dataset`, with every third variant's betas zeroed.

    Prior-less variants make damping="anchor" differ from plain EM.
    """
    genotypes, calls, names = bam_data
    betas = np.array(genotypes.get_betas())
    betas[::3] = 0.0
    return _both_sides(genotypes._with_betas(betas), calls, names)


def _jax_run(use_pallas: bool, fn):
    saved = JaxDemultiplexer.use_pallas
    JaxDemultiplexer.use_pallas = use_pallas
    try:
        return fn()
    finally:
        JaxDemultiplexer.use_pallas = saved


def _prior_logits(handler, n_options):
    return np.random.RandomState(11).randn(handler.n_barcodes, n_options).astype(np.float32) * 2


def _learn_kwargs(case, handler, n_donors):
    kwargs = dict(LEARN_CASES[case])
    if kwargs.pop("barcode_prior_logits", False):
        n_options = n_donors * (n_donors + 1) // 2 if kwargs["doublet_prior"] else n_donors
        kwargs["barcode_prior_logits"] = _prior_logits(handler, n_options)
    return kwargs


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(LEARN_CASES))
@pytest.mark.parametrize("priors", ["generated", "priorless"])
def test_learn_genotypes_matches_jax(dataset, priorless_dataset, priors, jax_path, case):
    data = dataset if priors == "generated" else priorless_dataset
    calls, genotypes, handler = data["port"]
    kwargs = _learn_kwargs(case, handler, len(genotypes.genotype_names))
    learnt, probs = Demultiplexer.learn_genotypes(calls, genotypes, handler, n_iterations=2, **kwargs)
    jax_calls, jax_genotypes, jax_handler = data["jax"]
    jax_learnt, jax_probs = _jax_run(jax_path == "pallas", lambda: JaxDemultiplexer.learn_genotypes(
        jax_calls, jax_genotypes, jax_handler, n_iterations=2, **kwargs,
    ))
    # the port computes in full f32 and meets the XLA path to ~3e-7. The
    # Pallas path's split-word (2 x bf16) matmuls sit up to 1.3e-5 from
    # full f32 on the prior-less data, within the 3e-5 bar that TPU kernel
    # met against full f32; on the generated data both paths are within 1e-5
    posterior_atol = 3e-5 if (priors, jax_path) == ("priorless", "pallas") else 1e-5
    assert list(probs.index) == list(jax_probs.index)
    assert list(probs.columns) == list(jax_probs.columns)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=posterior_atol)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), rtol=1e-4, atol=1e-2)
    if kwargs["damping"] == "anchor" and priors == "priorless":
        # prior-less variants learn nothing under the anchor mask
        zero_rows = np.asarray(genotypes.get_betas()).sum(axis=1) == 0
        assert zero_rows.any()
        np.testing.assert_array_equal(learnt.get_betas()[zero_rows], 0.0)


def test_learn_with_prior_logits_runs_the_fused_estep(dataset, monkeypatch):
    """Each EM iteration is one fused E-step call (logits, posteriors); iteration 0 passes the prior logits
    into it. The result meets the JAX engine at the learn test's bars."""
    from demuxalot_tpu_torch.models import demux

    calls, genotypes, handler = dataset["port"]
    kwargs = _learn_kwargs("prior-logits", handler, len(genotypes.genotype_names))
    seen = []
    fused = demux._Likelihood.posteriors

    def recording(self, genotype_prob, prior_logits=None):
        seen.append(prior_logits)
        return fused(self, genotype_prob, prior_logits)

    monkeypatch.setattr(demux._Likelihood, "posteriors", recording)
    learnt, probs = Demultiplexer.learn_genotypes(calls, genotypes, handler, n_iterations=3, **kwargs)
    assert len(seen) == 3 and seen[1] is None and seen[2] is None
    np.testing.assert_array_equal(seen[0].numpy(), kwargs["barcode_prior_logits"])
    jax_calls, jax_genotypes, jax_handler = dataset["jax"]
    jax_learnt, jax_probs = _jax_run(False, lambda: JaxDemultiplexer.learn_genotypes(
        jax_calls, jax_genotypes, jax_handler, n_iterations=3, **kwargs,
    ))
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-5)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
@pytest.mark.parametrize("doublet_prior", [0.25, 0.35])
def test_predict_posteriors_matches_jax(dataset, jax_path, doublet_prior):
    calls, genotypes, handler = dataset["port"]
    logits, probs = Demultiplexer.predict_posteriors(calls, genotypes, handler, doublet_prior=doublet_prior)
    jax_calls, jax_genotypes, jax_handler = dataset["jax"]
    jax_logits, jax_probs = _jax_run(jax_path == "pallas", lambda: JaxDemultiplexer.predict_posteriors(
        jax_calls, jax_genotypes, jax_handler, doublet_prior=doublet_prior,
    ))
    assert logits.index.name == probs.index.name == "BARCODE"
    assert list(logits.index) == list(jax_logits.index)
    assert list(logits.columns) == list(jax_logits.columns)
    np.testing.assert_allclose(logits.values, jax_logits.values, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-5)
    np.testing.assert_array_equal(probs.values.argmax(1), jax_probs.values.argmax(1))


def test_predict_posteriors_without_doublets_matches_xla(dataset):
    calls, genotypes, handler = dataset["port"]
    logits, probs = Demultiplexer.predict_posteriors(calls, genotypes, handler, doublet_prior=0.0)
    jax_logits, jax_probs = _jax_run(False, lambda: JaxDemultiplexer.predict_posteriors(
        *dataset["jax"], doublet_prior=0.0,
    ))
    assert list(logits.columns) == list(jax_logits.columns) == genotypes.genotype_names
    np.testing.assert_allclose(logits.values, jax_logits.values, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-5)


def test_staged_learning_last_yield_equals_learn_genotypes(priorless_dataset):
    calls, genotypes, handler = priorless_dataset["port"]
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    staged = list(Demultiplexer.staged_genotype_learning(
        packed, genotypes, handler, n_iterations=3, doublet_prior=0.25, damping="anchor",
    ))
    assert len(staged) == 3
    learnt, probs = Demultiplexer.learn_genotypes(
        packed, genotypes, handler, n_iterations=3, doublet_prior=0.25, damping="anchor",
    )
    last_probs, debug = staged[-1]
    np.testing.assert_array_equal(last_probs.values, probs.values)
    np.testing.assert_array_equal(genotypes.get_betas() + debug["genotype_addition"], learnt.get_betas())
    assert debug["barcode_logits"].shape == probs.shape
    # the first iteration enters with no addition
    np.testing.assert_array_equal(staged[0][1]["genotype_addition"], 0.0)


def test_staged_learning_matches_jax_per_iteration(priorless_dataset):
    calls, genotypes, handler = priorless_dataset["port"]
    jax_calls, jax_genotypes, jax_handler = priorless_dataset["jax"]
    ours = list(Demultiplexer.staged_genotype_learning(calls, genotypes, handler, n_iterations=3))
    theirs = _jax_run(False, lambda: list(JaxDemultiplexer.staged_genotype_learning(
        jax_calls, jax_genotypes, jax_handler, n_iterations=3,
    )))
    for (probs, debug), (jax_probs, jax_debug) in zip(ours, theirs):
        np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-5)
        np.testing.assert_allclose(debug["barcode_logits"], jax_debug["barcode_logits"], rtol=1e-4, atol=5e-3)
        np.testing.assert_allclose(debug["genotype_addition"], jax_debug["genotype_addition"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(debug["genotype_prior"], jax_debug["genotype_prior"])


def test_packed_calls_match_jax(dataset):
    """Host packing is bit-identical to the JAX package's."""
    calls, genotypes, _ = dataset["port"]
    jax_calls, jax_genotypes, _ = dataset["jax"]
    ours = PackedCalls(calls, genotypes)
    theirs = JaxPackedCalls(jax_calls, jax_genotypes)
    np.testing.assert_array_equal(ours.variant2snp, theirs.variant2snp)
    for field in ("order", "inverse", "variant2snp"):
        np.testing.assert_array_equal(getattr(ours.reindex, field), getattr(theirs.reindex, field))
    assert ours.reindex.max_per_snp == theirs.reindex.max_per_snp
    for field in ("variant_id", "snp_id", "compressed_cb", "molecule_id", "p_base_wrong",
                  "p_molecule_aligned_wrong"):
        np.testing.assert_array_equal(getattr(ours.molecule_calls, field), getattr(theirs.molecule_calls, field))
    for field in ("vid", "cb", "q", "count"):
        np.testing.assert_array_equal(getattr(ours.calls_v, field), getattr(theirs.calls_v, field))
    for a, b in zip(ours.calls_by_barcode(), theirs.calls_by_barcode()):
        np.testing.assert_array_equal(a, b)
    for add_data_prior in (False, True):
        np.testing.assert_array_equal(ours.betas_for(genotypes, add_data_prior),
                                      theirs.betas_for(jax_genotypes, add_data_prior))


def test_device_calls_are_csr_of_both_orders(dataset):
    calls, genotypes, handler = dataset["port"]
    packed = PackedCalls(calls, genotypes)
    device_calls = packed.device_calls(handler.n_barcodes, torch.device("cpu"))
    assert packed.device_calls(handler.n_barcodes, torch.device("cpu")) is device_calls  # cached
    cb_b, vid_b, q_b = packed.calls_by_barcode()
    row_ptr = device_calls.row_ptr.numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == len(cb_b)
    np.testing.assert_array_equal(np.diff(row_ptr), np.bincount(cb_b, minlength=handler.n_barcodes))
    var_ptr = device_calls.var_ptr.numpy()
    np.testing.assert_array_equal(np.diff(var_ptr), np.bincount(packed.calls_v.vid, minlength=packed.n_variants))
    np.testing.assert_array_equal(device_calls.cb_b.numpy(), cb_b)
    np.testing.assert_array_equal(device_calls.vid_b.numpy(), vid_b)
    np.testing.assert_array_equal(device_calls.q_b.numpy(), q_b)
    np.testing.assert_array_equal(device_calls.vid_v.numpy(), packed.calls_v.vid)
    np.testing.assert_array_equal(device_calls.cb_v.numpy(), packed.calls_v.cb)
    np.testing.assert_array_equal(device_calls.q_v.numpy(), packed.calls_v.q)
    packed.verify_registry(genotypes)
    other = convert.genotypes_from(genotypes)
    other.get_variant_id("chr9", 5, "A")
    with pytest.raises(ValueError, match="different variant registry"):
        packed.betas_for(other, add_data_prior=False)


def test_csr_row_pointers():
    rows = np.array([0, 0, 2, 2, 2, 5], np.int32)
    np.testing.assert_array_equal(csr_row_pointers(rows, 7), [0, 2, 2, 5, 5, 5, 6, 6])
    np.testing.assert_array_equal(csr_row_pointers(np.empty(0, np.int32), 2), [0, 0, 0])
    with pytest.raises(ValueError):
        csr_row_pointers(rows, 5)


def test_sim_workloads_are_bit_identical_to_jax():
    from benchmarks.synth_calls import synthesize_compressed_calls as jax_compressed_calls
    from demuxalot_tpu.sim import synthesize_device_workload as jax_device_workload
    from demuxalot_tpu_torch import sim

    for seed in (0, 5):
        for ours, theirs in zip(sim.synthesize_device_workload(50, 4, 70, 9, seed=seed),
                                jax_device_workload(50, 4, 70, 9, seed=seed)):
            np.testing.assert_array_equal(ours, theirs)
        genotypes, calls, truth, names = sim.synthesize_compressed_calls(40, 5, 60, 7, seed=seed)
        jax_genotypes, jax_calls, jax_truth, jax_names = jax_compressed_calls(40, 5, 60, 7, seed=seed)
        assert truth == jax_truth and names == jax_names
        ours_g, theirs_g = convert.genotypes_to_arrays(genotypes), convert.genotypes_to_arrays(jax_genotypes)
        for key in ours_g:
            np.testing.assert_array_equal(ours_g[key], theirs_g[key])
        np.testing.assert_array_equal(calls["chr1"].molecules, jax_calls["chr1"].molecules)
        np.testing.assert_array_equal(calls["chr1"].snp_calls, jax_calls["chr1"].snp_calls)


def test_sim_engine_matches_jax():
    """Synthetic calls with doublets: the port's posteriors and EM equal JAX's."""
    from demuxalot_tpu_torch import sim

    genotypes, calls, truth, _ = sim.synthesize_compressed_calls(200, 6, 300, 24, seed=2)
    barcodes = [f"BC{b:04d}" for b in range(200)]
    handler = BarcodeHandler(barcodes)
    jax_args = (_jax_calls(calls), _jax_genotypes(genotypes), JaxBarcodeHandler(barcodes))
    logits, probs = Demultiplexer.predict_posteriors(calls, genotypes, handler, doublet_prior=0.35)
    jax_logits, jax_probs = _jax_run(False, lambda: JaxDemultiplexer.predict_posteriors(
        *jax_args, doublet_prior=0.35))
    np.testing.assert_allclose(logits.values, jax_logits.values, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=1e-5)
    truth_columns = [list(probs.columns).index("+".join(t)) for t in truth]
    assert (probs.values.argmax(1) == truth_columns).mean() > 0.9
    learnt, em_probs = Demultiplexer.learn_genotypes(calls, genotypes, handler, n_iterations=3, doublet_prior=0.35)
    jax_learnt, jax_em_probs = _jax_run(False, lambda: JaxDemultiplexer.learn_genotypes(
        *jax_args, n_iterations=3, doublet_prior=0.35))
    np.testing.assert_allclose(em_probs.values, jax_em_probs.values, atol=1e-5)
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), rtol=1e-4, atol=1e-2)


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


def test_device_is_explicit():
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: asking for cuda succeeds")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_unported_damping_raises(dataset):
    """Unknown damping values raise; "auto" runs only where the whole EM is in view."""
    calls, genotypes, handler = dataset["port"]
    with pytest.raises(ValueError, match="damping must be"):
        Demultiplexer.learn_genotypes(calls, genotypes, handler, damping="bogus")
    with pytest.raises(ValueError, match="learn_genotypes"):
        next(Demultiplexer.staged_genotype_learning(calls, genotypes, handler, damping="auto"))


def test_aggregate_on_snps_is_refused_not_ignored(dataset, monkeypatch):
    """The switch exists with the JAX defaults, and every entry point reads it.

    Before the switch existed on the port, setting it made a class
    attribute nothing read, and the run quietly took the default path; it
    then raised until its path was ported. Now each core's result must
    change when it is on (tests/test_torch_aggregate.py holds those results
    to the JAX package's).
    """
    assert "aggregate_on_snps" in vars(Demultiplexer)
    assert Demultiplexer.aggregate_on_snps is JaxDemultiplexer.aggregate_on_snps is False
    assert (Demultiplexer.compensation_during_computing_barcode_logits
            == JaxDemultiplexer.compensation_during_computing_barcode_logits == 0.5)
    calls, genotypes, handler = dataset["port"]

    def run_all():
        return {
            "predict": Demultiplexer.predict_posteriors_core(calls, genotypes, handler)[0].numpy(),
            "compact": Demultiplexer.predict_posteriors_compact(calls, genotypes, handler).top_logits,
            "learn": Demultiplexer.learn_genotypes_core(calls, genotypes, handler, n_iterations=2).state.logits.numpy(),
            "auto": Demultiplexer.learn_genotypes_core(calls, genotypes, handler, n_iterations=2,
                                                       damping="auto").state.logits.numpy(),
        }

    default = run_all()
    monkeypatch.setattr(Demultiplexer, "aggregate_on_snps", True)
    aggregated = run_all()
    for name, logits in default.items():
        assert logits.shape == aggregated[name].shape
        assert np.abs(logits - aggregated[name]).max() > 1.0, name
    assert default["predict"].shape[0] == handler.n_barcodes


@pytest.fixture(scope="module")
def auto_data(tmp_path_factory):
    """A BAM where heavily degraded priors make plain EM diverge (8 donors, 50 barcodes)."""
    np.random.seed(3)
    filename = str(tmp_path_factory.mktemp("auto") / "a.bam")
    filename, genotypes, _ids, names = generate_bam_file(
        filename, n_genotypes=8, n_barcodes=50, n_reads_per_barcode=60,
        chromosome2length={"chr1": 2000, "chr2": 2000, "chr3": 2000},
    )
    calls = count_snps(filename, genotypes.get_chromosome2positions(), JaxBarcodeHandler(list(names)),
                       joblib_n_jobs=None, joblib_verbosity=0)
    return genotypes, calls, list(names)


# erased fraction of SNP priors -> the selection JAX makes on auto_data
AUTO_CASES = {"diverging": (0.98, "anchor"), "converging": (0.9, None), "full-prior": (0.0, None)}


@pytest.mark.parametrize("doublet_prior", [0.0, 0.25])
@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_auto_damping_matches_jax(auto_data, case, doublet_prior):
    """damping="auto": same selection and disagreement as JAX, same posteriors."""
    genotypes, calls, names = auto_data
    erased, expected = AUTO_CASES[case]
    degraded = genotypes.clone()
    snp_ids = degraded.get_snp_ids_for_variants()
    mask = np.random.RandomState(5).random_sample(snp_ids.max() + 1) < erased
    degraded.variant_betas[np.nonzero(mask[snp_ids])[0], :] = 0
    data = _both_sides(degraded, calls, names)
    learnt, probs = Demultiplexer.learn_genotypes(*data["port"], doublet_prior=doublet_prior, damping="auto")
    jax_learnt, jax_probs = _jax_run(False, lambda: JaxDemultiplexer.learn_genotypes(
        *data["jax"], doublet_prior=doublet_prior, damping="auto"))
    assert probs.attrs["damping_selected"] == jax_probs.attrs["damping_selected"] == expected
    assert abs(probs.attrs["anchored_disagreement"] - jax_probs.attrs["anchored_disagreement"]) <= 1e-6
    np.testing.assert_allclose(probs.values, jax_probs.values, atol=3e-5)
    np.testing.assert_allclose(learnt.get_betas(), jax_learnt.get_betas(), rtol=1e-4, atol=1e-2)
    # the core returns the selected run: the same tensors as running that damping alone
    calls_port, genotypes_port, handler = data["port"]
    packed = Demultiplexer.pack_dataset(calls_port, genotypes_port)
    core = Demultiplexer.learn_genotypes_core(packed, genotypes_port, handler, doublet_prior=doublet_prior,
                                              damping="auto")
    alone = Demultiplexer.learn_genotypes_core(packed, genotypes_port, handler, doublet_prior=doublet_prior,
                                               damping=expected)
    assert core.damping_selected == expected and alone.damping_selected is None
    assert core.anchored_disagreement == probs.attrs["anchored_disagreement"]
    assert torch.equal(core.state.probs, alone.state.probs)
    np.testing.assert_array_equal(core.genotypes.get_betas(), alone.genotypes.get_betas())
