"""The port's compact posteriors against the JAX package's on the same data.

Data: the JAX package's synthetic BAM (``generate_bam_file`` under
``np.random.seed``), counted by its ``count_snps``. The port runs on the
CPU; the JAX side on its XLA path. Exact: the assignment and
``top_index``, ties included (a twin donor with identical betas gives equal
columns, and the lowest index must win; lower ranks may swap only between
columns tied at the logits tolerance), the bf16 frame's bits, and
``bytes_moved``. Within the logits tolerance (rtol=1e-4, atol=5e-3):
``top_logits`` and ``logsumexp``.
"""
import numpy as np
import pytest
import torch

from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu import Demultiplexer as JaxDemultiplexer
from demuxalot_tpu.frontend.snp_counter import count_snps as jax_count_snps
from demuxalot_tpu.models.genotypes import ProbabilisticGenotypes as JaxGenotypes
from demuxalot_tpu.sim import generate_bam_file as jax_generate_bam_file
from demuxalot_tpu_torch import BarcodeHandler, CompactPosteriors, Demultiplexer, convert

LOGITS_TOL = dict(rtol=1e-4, atol=5e-3)


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")
    monkeypatch.setattr(JaxDemultiplexer, "use_pallas", False)


def _jax_genotypes(arrays):
    result = JaxGenotypes(arrays["genotype_names"], default_prior=arrays["default_prior"])
    for c, p, b in zip(arrays["chrom"], arrays["pos"], arrays["base"]):
        result.get_variant_id(c, int(p), b)
    return result._with_betas(arrays["betas"])


@pytest.fixture(scope="module")
def data():
    """{"plain"/"twin": (port args, JAX args)}; "twin" adds a copy of donor 2."""
    import tempfile

    np.random.seed(17)
    with tempfile.TemporaryDirectory() as tmp:
        filename, genotypes, _ids, names = jax_generate_bam_file(
            f"{tmp}/c.bam", n_genotypes=5, n_barcodes=50, n_reads_per_barcode=40,
            chromosome2length={"chr1": 1500, "chr2": 1500},
        )
        calls = jax_count_snps(filename, genotypes.get_chromosome2positions(), JaxBarcodeHandler(list(names)),
                               joblib_n_jobs=None, joblib_verbosity=0)
    names = list(names)
    arrays = convert.genotypes_to_arrays(genotypes)
    twin = dict(arrays, genotype_names=list(arrays["genotype_names"]) + ["Twin"],
                betas=np.concatenate([arrays["betas"], arrays["betas"][:, 2:3]], axis=1))
    result = {}
    for label, genotype_arrays in (("plain", arrays), ("twin", twin)):
        ours = (convert.calls_from(calls), convert.genotypes_from(_jax_genotypes(genotype_arrays)),
                BarcodeHandler(names))
        result[label] = (ours, (calls, _jax_genotypes(genotype_arrays), JaxBarcodeHandler(names)))
    return result


def _assert_same_ranking(ours, theirs, jax_logits):
    """Equal top-k indices, except between columns tied at the logits tolerance.

    Doublet columns can sit within an ulp of each other (or be rounded to
    one value by the JAX arithmetic); the port's own rounding may order
    such a pair the other way. Below rank 0, indices may swap only between
    columns whose JAX logits agree within the tolerance the two frames are
    held to. Forced ties (identical columns) are computed identically by
    both and stay exact.
    """
    rows, cols = np.nonzero(ours != theirs)
    for row, col in zip(rows, cols):
        assert col > 0
        np.testing.assert_allclose(jax_logits[row, ours[row, col]], jax_logits[row, theirs[row, col]],
                                   **LOGITS_TOL)


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
@pytest.mark.parametrize("label", ["plain", "twin"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_compact_matches_jax(data, label, doublet_prior, k):
    ours_args, jax_args = data[label]
    ours = Demultiplexer.predict_posteriors_compact(*ours_args, doublet_prior=doublet_prior, k=k,
                                                    include_logits=True)
    theirs = JaxDemultiplexer.predict_posteriors_compact(*jax_args, doublet_prior=doublet_prior, k=k,
                                                         include_logits=True)
    assert isinstance(ours, CompactPosteriors)
    assert ours.column_names == theirs.column_names and ours.barcodes == list(theirs.barcodes)
    assert ours.k == theirs.k == k
    assert ours.top_index.dtype == np.int32 and ours.top_logits.dtype == np.float32
    np.testing.assert_array_equal(ours.assignment, theirs.assignment)
    jax_logits, _ = JaxDemultiplexer.predict_posteriors(*jax_args, doublet_prior=doublet_prior)
    _assert_same_ranking(ours.top_index, theirs.top_index, jax_logits.values)
    np.testing.assert_allclose(ours.top_logits, theirs.top_logits, **LOGITS_TOL)
    np.testing.assert_allclose(ours.logsumexp, theirs.logsumexp, **LOGITS_TOL)
    assert ours.logits_bf16.dtype == torch.bfloat16 and ours.logits_bf16.device.type == "cpu"
    np.testing.assert_array_equal(ours.logits_bf16.view(torch.int16).numpy().view(np.uint16),
                                  theirs.logits_bf16.view(np.uint16))
    assert ours.bytes_moved == theirs.bytes_moved
    frame, jax_frame = ours.to_dataframe(), theirs.to_dataframe()
    assert list(frame.columns) == list(jax_frame.columns)
    assert (frame["assignment"] == jax_frame["assignment"]).all()
    np.testing.assert_allclose(frame["posterior"], jax_frame["posterior"], atol=1e-5)
    np.testing.assert_allclose(ours.logits_dataframe().values, theirs.logits_dataframe().values)


@pytest.mark.parametrize("doublet_prior", [0.0, 0.35])
def test_compact_equals_the_full_frame(data, doublet_prior):
    """Assignment = full-frame argmax (ties to the lowest index), top-k = frame entries."""
    ours_args, _ = data["twin"]
    logits, probs = Demultiplexer.predict_posteriors(*ours_args, doublet_prior=doublet_prior)
    compact = Demultiplexer.predict_posteriors_compact(*ours_args, doublet_prior=doublet_prior, k=4)
    full = logits.values
    twin = list(logits.columns).index("Twin")
    assert np.array_equal(full[:, 2], full[:, twin]), "the twin's column equals donor 2's"
    np.testing.assert_array_equal(compact.assignment, full.argmax(axis=1))
    assert (compact.assignment != twin).all()  # a tie never goes to the higher index
    rows = np.arange(len(full))[:, None]
    np.testing.assert_array_equal(compact.top_logits, full[rows, compact.top_index])
    assert (np.diff(compact.top_logits, axis=1) <= 0).all()
    np.testing.assert_allclose(compact.top_probs[:, 0], probs.values.max(axis=1), atol=1e-5)
    assert compact.logits_bf16 is None
    assert compact.bytes_moved == full.shape[0] * (8 * 4 + 4)  # top-4 values and indices, logsumexp
    with pytest.raises(ValueError, match="include_logits"):
        compact.logits_dataframe()


def test_compact_k1_and_bad_k(data):
    ours_args, _ = data["plain"]
    compact = Demultiplexer.predict_posteriors_compact(*ours_args, doublet_prior=0.0, k=1)
    assert list(compact.to_dataframe().columns) == ["assignment", "posterior"]
    with pytest.raises(ValueError, match="runner-up"):
        compact.runner_up
    with pytest.raises(ValueError, match="margin"):
        compact.margin
    for bad in (0, -1):
        with pytest.raises(ValueError, match="k must be >= 1"):
            Demultiplexer.predict_posteriors_compact(*ours_args, k=bad)
    # k past the column count clamps to it
    wide = Demultiplexer.predict_posteriors_compact(*ours_args, doublet_prior=0.0, k=50)
    assert wide.k == len(wide.column_names) == 5
