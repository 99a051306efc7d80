"""The port's ``count_snps`` against the JAX package's on the same BAMs.

Exact comparisons: identical molecule and call arrays (p-values bit-equal),
for the Python scanner and the native (C++) scanner, inline and on two
worker processes, the ``{RG: path}`` multi-BAM form, the cellranger and BD
Rhapsody plugins, and the saved ``.npz`` counts. BAMs come from the JAX
package's writers under ``np.random.seed`` (40 barcodes, at most 2,000 bp
per chromosome).
"""
import functools

import numpy as np
import pytest

from demuxalot_tpu import BarcodeHandler as JaxBarcodeHandler
from demuxalot_tpu.bamio import AlignedRead, BamWriter, index_bam, sort_bam
from demuxalot_tpu.frontend import bd_rhapsody as jax_bd, cellranger as jax_cellranger
from demuxalot_tpu.frontend.snp_counter import count_snps as jax_count_snps
from demuxalot_tpu.frontend.snp_counter import load_snp_counts as jax_load_snp_counts
from demuxalot_tpu.frontend.snp_counter import save_snp_counts as jax_save_snp_counts
from demuxalot_tpu.sim import generate_bam_file as jax_generate_bam_file
from demuxalot_tpu_torch import BarcodeHandler, count_snps
from demuxalot_tpu_torch.frontend import bd_rhapsody, cellranger, load_snp_counts, save_snp_counts


def assert_same_counts(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for chromosome in ours:
        a, b = ours[chromosome], theirs[chromosome]
        a.minimize_memory_footprint()
        b.minimize_memory_footprint()
        assert a.molecules.dtype == b.molecules.dtype and a.snp_calls.dtype == b.snp_calls.dtype
        np.testing.assert_array_equal(a.molecules, b.molecules)
        np.testing.assert_array_equal(a.snp_calls, b.snp_calls)
        assert a.molecules.tobytes() == b.molecules.tobytes()
        assert a.snp_calls.tobytes() == b.snp_calls.tobytes()


@pytest.fixture(scope="module")
def bam_data(tmp_path_factory):
    np.random.seed(7)
    filename = str(tmp_path_factory.mktemp("count") / "t.bam")
    _, genotypes, _ids, names = jax_generate_bam_file(
        filename, n_genotypes=4, n_barcodes=40, n_reads_per_barcode=30,
        chromosome2length={"chr1": 2000, "chr2": 1200, "chr3": 900},
    )
    return filename, genotypes.get_chromosome2positions(), list(names)


@pytest.fixture(scope="module")
def jax_counts(bam_data):
    filename, positions, names = bam_data
    return jax_count_snps(filename, positions, JaxBarcodeHandler(names),
                          joblib_n_jobs=None, joblib_verbosity=0, native=False)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("jobs", [None, 2])
def test_count_snps_matches_jax(bam_data, jax_counts, native, jobs):
    filename, positions, names = bam_data
    ours = count_snps(filename, positions, BarcodeHandler(names), joblib_n_jobs=jobs,
                      joblib_verbosity=0, native=native)
    assert sum(c.n_snp_calls for c in ours.values()) > 0
    assert_same_counts(ours, jax_counts)
    # the JAX native scanner agrees with its Python scanner, and so with ours
    assert_same_counts(ours, jax_count_snps(filename, positions, JaxBarcodeHandler(names),
                                            joblib_n_jobs=None, joblib_verbosity=0, native=True))


def test_counting_is_split_into_region_tasks(bam_data, jax_counts):
    """Several stripes per chromosome (molecules cut at stripe edges) still agree."""
    from demuxalot_tpu.frontend.snp_counter import prepare_counting_tasks as jax_tasks
    from demuxalot_tpu_torch.frontend import prepare_counting_tasks

    filename, positions, names = bam_data
    ours = prepare_counting_tasks(filename, positions, BarcodeHandler(names), n_reads_per_job=200,
                                  minimum_fragment_length_per_job=300)
    theirs = jax_tasks(filename, positions, JaxBarcodeHandler(names), n_reads_per_job=200,
                       minimum_fragment_length_per_job=300)
    assert len(ours) == len(theirs) > len(positions)
    for a, b in zip(ours, theirs):
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])


def test_native_true_refuses_custom_parse_read(bam_data):
    filename, positions, names = bam_data
    with pytest.raises(RuntimeError, match="parse_read"):
        count_snps(filename, positions, BarcodeHandler(names), joblib_n_jobs=None,
                   parse_read=lambda read: None, native=True)


def _read(start, seq, i, cb, umi_tag="UB", as_score=None):
    read = AlignedRead()
    read.query_name = f"r{i}"
    read.flag = 0
    read.reference_id = 0
    read.reference_start = start
    read.mapping_quality = 60
    read.query_sequence = seq
    read.cigar = ((0, len(seq)),)
    read.query_qualities = [20 + i % 21] * len(seq)
    read.tags = (("NH", 1), ("AS", len(seq) - 2 if as_score is None else as_score), ("CB", cb),
                 (umi_tag, f"UMI{i % 7:05}A43"))
    return read


def _write_bam(path, reads, length=600):
    with BamWriter(path, {"HD": {"VN": "1.0"}, "SQ": [dict(LN=length, SN="chr1")]}) as writer:
        for read in reads:
            writer.write(read)
    sort_bam(path, path)
    index_bam(path)
    return path


@pytest.mark.parametrize("native", [None, False])
def test_multi_bam_rg_form_matches_jax(tmp_path, native):
    bam_a = _write_bam(str(tmp_path / "a.bam"), [_read(i, "AC" * 25, i, "SHARED-1") for i in range(40)])
    bam_b = _write_bam(str(tmp_path / "b.bam"), [_read(i, "CA" * 25, i, "SHARED-1") for i in range(40)])
    bams = {"fileA": bam_a, "fileB": bam_b}
    positions = {"chr1": np.array([10, 20, 31])}
    rg = dict(RG_tags=["fileA", "fileB"])
    ours = count_snps(bams, positions, BarcodeHandler(["SHARED-1"] * 2, **rg), joblib_n_jobs=None,
                      joblib_verbosity=0, native=native)
    theirs = jax_count_snps(bams, positions, JaxBarcodeHandler(["SHARED-1"] * 2, **rg),
                            joblib_n_jobs=None, joblib_verbosity=0, native=native)
    assert_same_counts(ours, theirs)
    chr1 = ours["chr1"]
    assert set(chr1.molecules["compressed_cb"][chr1.snp_calls["molecule_index"]]) == {0, 1}


# (plugin name, the port's parse_read, the JAX package's, UMI tag)
PLUGINS = {
    "cellranger": (cellranger.parse_read, jax_cellranger.parse_read, "UB"),
    "cellranger-strict": (functools.partial(cellranger.parse_read, score_diff_max=5),
                          functools.partial(jax_cellranger.parse_read, score_diff_max=5), "UB"),
    "bd_rhapsody": (bd_rhapsody.parse_read, jax_bd.parse_read, "MA"),
}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("plugin", sorted(PLUGINS))
def test_parse_read_plugins_match_jax(tmp_path, plugin, native):
    ours_parse, jax_parse, umi_tag = PLUGINS[plugin]
    reads = [
        _read(i % 90, "ACGTTGCA" * 8, i, f"BC{i % 3}-1", umi_tag=umi_tag, as_score=62 - i % 6)
        for i in range(120)
    ]
    bam = _write_bam(str(tmp_path / "p.bam"), reads)
    positions = {"chr1": np.array([5, 17, 40, 66, 99, 120])}
    barcodes = [f"BC{i}-1" for i in range(3)]
    ours = count_snps(bam, positions, BarcodeHandler(barcodes), joblib_n_jobs=None,
                      joblib_verbosity=0, parse_read=ours_parse, native=native)
    theirs = jax_count_snps(bam, positions, JaxBarcodeHandler(barcodes), joblib_n_jobs=None,
                            joblib_verbosity=0, parse_read=jax_parse, native=native)
    assert sum(c.n_snp_calls for c in ours.values()) > 0
    assert_same_counts(ours, theirs)


def test_saved_counts_cross_load(bam_data, jax_counts, tmp_path):
    filename, positions, names = bam_data
    ours = count_snps(filename, positions, BarcodeHandler(names), joblib_n_jobs=None,
                      joblib_verbosity=0, native=True)
    save_snp_counts(ours, tmp_path / "ours")
    jax_save_snp_counts(jax_counts, tmp_path / "theirs")
    assert_same_counts(jax_load_snp_counts(tmp_path / "ours"), jax_counts)
    assert_same_counts(load_snp_counts(tmp_path / "theirs"), ours)
    assert_same_counts(load_snp_counts(tmp_path / "ours"), ours)


def test_port_fixture_counts_and_demultiplexes(tmp_path):
    """The port's bulk BAM writer makes data both counters read alike and the engine solves."""
    from demuxalot_tpu_torch import Demultiplexer, sim

    filename = str(tmp_path / "port.bam")
    _, genotypes, _ids, barcode2donors = sim.generate_bam_file(
        filename, n_genotypes=4, n_barcodes=50, n_reads_per_barcode=40, mutation_prob=0.02,
        doublets_fraction=0.0, chromosome2length={"chr1": 2000, "chr2": 1500}, rng=3,
    )
    names = list(barcode2donors)
    positions = genotypes.get_chromosome2positions()
    ours = count_snps(filename, positions, BarcodeHandler(names), joblib_n_jobs=None, native=True)
    assert_same_counts(ours, jax_count_snps(filename, positions, JaxBarcodeHandler(names),
                                            joblib_n_jobs=None, joblib_verbosity=0, native=False))
    handler = BarcodeHandler(names)
    saved = Demultiplexer.device
    Demultiplexer.device = "cpu"
    try:
        compact = Demultiplexer.predict_posteriors_compact(ours, genotypes, handler, doublet_prior=0.0, k=2)
    finally:
        Demultiplexer.device = saved
    truth = [barcode2donors[b][0] for b in compact.barcodes]
    assert np.mean(np.array(compact.assignment_names) == np.array(truth)) > 0.9
