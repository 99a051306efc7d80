"""SNP discovery of the port against the JAX package, and on its own.

Both packages' ``detect_snps_positions`` run on one BAM (the JAX suite's
discovery fixture: 4 donors, 300 barcodes x 80 reads, two 800 bp
chromosomes, chr2's variants hidden) and must select the same (chrom, pos,
bases) rows with the same scores and write the same parquet. The
selection is exact host arithmetic on integer base counts once the same
barcodes pass the provisional 0.8 threshold, so the test first checks that
no provisional posterior lies within 1e-4 of it (the two packages'
posteriors differ by ~1e-6). The native pileup must equal the Python
pileup bit for bit.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu import ProbabilisticGenotypes as JaxGenotypes
from demuxalot_tpu import detect_snps_positions as jax_detect_snps_positions
from demuxalot_tpu.sim import generate_bam_file as jax_generate_bam_file
from demuxalot_tpu_torch import (
    BarcodeHandler, Demultiplexer, ProbabilisticGenotypes, convert, count_snps, detect_snps_positions, sim,
)
from demuxalot_tpu_torch.bamio import BamReader, write_sam
from demuxalot_tpu_torch.cli import main
from demuxalot_tpu_torch.frontend import cellranger
from demuxalot_tpu_torch.frontend.native_counter import try_count_coverage_native
from demuxalot_tpu_torch.frontend.snp_counter import CompressedSNPCalls
from demuxalot_tpu_torch.models.snp_detection import _donor_base_tables

torch.set_num_threads(1)

THRESHOLDS = dict(minimum_coverage=50, minimum_alternative_coverage=10, minimum_alternative_fraction=0.01)


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(Demultiplexer, "device", "cpu")


def _keep_chromosome(genotypes, empty, chromosome):
    """``empty`` filled with the variants of ``chromosome`` only (the JAX test's construction)."""
    for (chrom, pos, base), vid in genotypes.var2varid.items():
        if chrom == chromosome:
            row = empty.get_variant_id(chrom, pos, base)
            empty.variant_betas[row] = genotypes.variant_betas[vid]
    return empty


@pytest.fixture(scope="module")
def detection_problem(tmp_path_factory):
    np.random.seed(5)
    filename = str(tmp_path_factory.mktemp("bam") / "d.bam")
    filename, genotypes, _ids, names = jax_generate_bam_file(
        filename, n_genotypes=4, doublets_fraction=0.1, mutation_prob=0.03,
        n_barcodes=300, n_reads_per_barcode=80, chromosome2length={"chr1": 800, "chr2": 800},
    )
    known = _keep_chromosome(genotypes, JaxGenotypes(genotypes.genotype_names), "chr1")
    return filename, known, list(names)


def _rows(selected):
    return [(chrom, pos, list(bases), {b: int(n) for b, n in bases.items()}) for chrom, pos, _s, bases in selected]


def test_detect_snps_positions_matches_jax(detection_problem, tmp_path):
    filename, known, names = detection_problem
    port_known, handler = convert.genotypes_from(known), BarcodeHandler(names)
    # the selection is identical only if the same barcodes pass 0.8
    calls = count_snps(filename, port_known.get_chromosome2positions(), handler, joblib_n_jobs=1,
                       joblib_verbosity=0)
    _logits, posteriors, _ = Demultiplexer.predict_posteriors_core(calls, port_known, handler, doublet_prior=0.0)
    assert float((posteriors.max(dim=1).values - 0.8).abs().min()) > 1e-4

    ours = detect_snps_positions(filename, port_known, handler, joblib_n_jobs=2, joblib_verbosity=0,
                                 result_beta_prior_filename=str(tmp_path / "ours.parquet"), **THRESHOLDS)
    theirs = jax_detect_snps_positions(filename, known, JaxBarcodeHandler(names), joblib_n_jobs=2,
                                       joblib_verbosity=0, result_beta_prior_filename=str(tmp_path / "theirs.parquet"),
                                       **THRESHOLDS)
    assert len(ours) > 0
    assert _rows(ours) == _rows(theirs)
    for (_c, _p, score, _b), (_c2, _p2, jax_score, _b2) in zip(ours, theirs):
        np.testing.assert_array_equal(score, jax_score)
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "ours.parquet"),
                                  pd.read_parquet(tmp_path / "theirs.parquet"))


def test_detects_hidden_snps(tmp_path):
    """The JAX suite's discovery bars on the port's own BAM writer, counter and engine."""
    filename = str(tmp_path / "d.bam")
    filename, genotypes, _ids, names = sim.generate_bam_file(
        filename, n_genotypes=4, doublets_fraction=0.1, mutation_prob=0.03, n_barcodes=300,
        n_reads_per_barcode=80, chromosome2length={"chr1": 800, "chr2": 800}, rng=5,
    )
    known = _keep_chromosome(genotypes, ProbabilisticGenotypes(genotypes.genotype_names), "chr1")
    out_parquet = str(tmp_path / "discovered.parquet")
    selected = detect_snps_positions(filename, known, BarcodeHandler(list(names)), joblib_n_jobs=1,
                                     joblib_verbosity=0, result_beta_prior_filename=out_parquet, **THRESHOLDS)
    assert len(selected) > 0
    assert "chr2" in {chrom for chrom, *_ in selected}, "should discover positions on the unknown chromosome"
    known_positions = known.get_snp_positions_set()
    assert all((chrom, pos) not in known_positions for chrom, pos, *_ in selected)

    enriched = known.clone()
    enriched.add_prior_betas(out_parquet, prior_strength=10)
    assert enriched.n_variants > known.n_variants

    true_chr2 = {pos for (chrom, pos, _b) in genotypes.var2varid if chrom == "chr2"}
    discovered_chr2 = {pos for chrom, pos, *_ in selected if chrom == "chr2"}
    assert len(discovered_chr2 & true_chr2) / max(1, len(discovered_chr2)) > 0.5


def test_donor_base_tables_ignore_n_calls():
    """'N' calls (base code 4) must neither crash nor leak into the tables."""
    calls = CompressedSNPCalls()
    calls.add_calls_from_read_group(0, 11, 0.01, [(5, "A", 1e-4), (7, "N", 1e-4)])
    calls.add_calls_from_read_group(1, 12, 0.01, [(5, "C", 1e-4), (8, "N", 1e-4)])
    calls.minimize_memory_footprint()
    tables = _donor_base_tables(calls, BarcodeHandler(["BC0", "BC1"]), {"BC0": "D1", "BC1": "D2"},
                                {"D1": 0, "D2": 1})
    assert set(tables) == {5}, "N calls must not create or pollute positions"
    np.testing.assert_array_equal(tables[5], [[1, 0, 0, 0], [0, 1, 0, 0]])


@pytest.mark.parametrize("window", [(0, 800), (137, 611), (700, 900)])
def test_native_coverage_equals_python(detection_problem, window):
    filename = detection_problem[0]
    start, stop = window
    accepted = lambda read: cellranger.parse_read(read) is not None
    for chromosome in ("chr1", "chr2"):
        native = try_count_coverage_native(filename, chromosome, start, stop, cellranger.parse_read, required=True)
        with BamReader(filename) as reader:
            python = reader.count_coverage(chromosome, start, stop, read_callback=accepted)
        assert len(native) == len(python) == 4
        for ours, theirs in zip(native, python):
            assert ours.dtype == theirs.dtype == np.int64
            np.testing.assert_array_equal(ours, theirs)
        assert sum(int(row.sum()) for row in native) > 0


def test_native_coverage_declines_where_jax_does(detection_problem, tmp_path):
    """None (or, when required, an error) for a custom parse_read or a SAM input."""
    filename = detection_problem[0]
    custom = lambda read: cellranger.parse_read(read)
    assert try_count_coverage_native(filename, "chr1", 0, 100, custom) is None
    with pytest.raises(RuntimeError, match="parse_read"):
        try_count_coverage_native(filename, "chr1", 0, 100, custom, required=True)
    with BamReader(filename) as reader:
        sam = str(tmp_path / "d.sam")
        write_sam(sam, reader.header, list(reader.fetch("chr1", 0, 100)))
    assert try_count_coverage_native(sam, "chr1", 0, 100, cellranger.parse_read) is None
    with pytest.raises(RuntimeError, match="BAM input"):
        try_count_coverage_native(sam, "chr1", 0, 100, cellranger.parse_read, required=True)


def test_detect_snps_cli_matches_api(detection_problem, tmp_path):
    filename, known, names = detection_problem
    barcodes = tmp_path / "barcodes.csv"
    barcodes.write_text("\n".join(names) + "\n")
    betas = tmp_path / "known.parquet"
    known.save_betas(str(betas))
    out = tmp_path / "cli.parquet"
    assert main(["detect-snps", "--bam", filename, "--barcodes", str(barcodes), "--prior-betas", str(betas),
                 "--out", str(out), "--min-coverage", "50", "--min-alternative-coverage", "10",
                 "--jobs", "1", "--device", "cpu"]) == 0
    assert Demultiplexer.device == "cpu"
    api = tmp_path / "api.parquet"
    store = ProbabilisticGenotypes(known.genotype_names)
    store.add_prior_betas(str(betas), prior_strength=1.0)
    detect_snps_positions(filename, store, BarcodeHandler(names), joblib_n_jobs=1, joblib_verbosity=0,
                          result_beta_prior_filename=str(api), **THRESHOLDS)
    cli_rows = pd.read_parquet(out)
    assert len(cli_rows) > 0
    pd.testing.assert_frame_equal(cli_rows, pd.read_parquet(api))
