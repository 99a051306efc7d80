"""The port's file formats against the JAX package's on the same files.

BAMs come from the JAX package's ``generate_bam_file`` under
``np.random.seed`` (tiny: 40 barcodes, 3 chromosomes of at most 2,000 bp).
Everything here is exact: records field by field, and file bytes.
"""
import shutil

import numpy as np
import pytest

from demuxalot_tpu import bamio as jax_bamio
from demuxalot_tpu.sim import generate_bam_file as jax_generate_bam_file
from demuxalot_tpu_torch import bamio, sim

CHROMOSOMES = {"chr1": 2000, "chr2": 1500, "chr3": 800}


@pytest.fixture(scope="module")
def bam_file(tmp_path_factory):
    np.random.seed(21)
    filename = str(tmp_path_factory.mktemp("bamio") / "t.bam")
    jax_generate_bam_file(filename, n_genotypes=4, n_barcodes=40, n_reads_per_barcode=20,
                          chromosome2length=CHROMOSOMES)
    return filename


def _fields(read):
    return (
        read.query_name, read.flag, read.reference_id, read.reference_start, read.mapping_quality,
        read.next_reference_id, read.next_reference_start, read.template_length,
        read.cigartuples, read.reference_end, read.query_sequence, read.query_qualities, read.tags,
    )


def test_bam_reader_matches_jax(bam_file):
    ours, theirs = bamio.BamReader(bam_file), jax_bamio.BamReader(bam_file)
    assert ours.header.text == theirs.header.text
    assert ours.references == theirs.references == list(CHROMOSOMES)
    assert [ours.get_reference_length(c) for c in CHROMOSOMES] == list(CHROMOSOMES.values())
    assert [_fields(r) for r in ours] == [_fields(r) for r in theirs]
    assert [(s.contig, s.mapped, s.unmapped) for s in ours.get_index_statistics()] == [
        (s.contig, s.mapped, s.unmapped) for s in theirs.get_index_statistics()
    ]
    for chromosome, start, stop in (("chr1", 0, 2000), ("chr2", 300, 900), ("chr3", 790, 800)):
        got = [_fields(r) for r in ours.fetch(chromosome, start, stop)]
        assert got == [_fields(r) for r in theirs.fetch(chromosome, start, stop)]
        assert got, "the window holds reads"


def test_bam_writer_reads_back_through_jax(bam_file, tmp_path):
    """The port's writer re-encodes every record to the JAX writer's bytes."""
    reader = bamio.BamReader(bam_file)
    ours, theirs = str(tmp_path / "ours.bam"), str(tmp_path / "theirs.bam")
    with bamio.BamWriter(ours, reader.header) as writer:
        for read in reader:
            writer.write(read)
    jax_reader = jax_bamio.BamReader(bam_file)
    with jax_bamio.BamWriter(theirs, jax_reader.header) as writer:
        for read in jax_reader:
            writer.write(read)
    assert open(ours, "rb").read() == open(theirs, "rb").read() == open(bam_file, "rb").read()
    assert [_fields(r) for r in jax_bamio.BamReader(ours)] == [_fields(r) for r in bamio.BamReader(bam_file)]


def test_sort_and_index_bytes_match_jax(bam_file, tmp_path):
    # an unsorted file: the records in reverse order
    reads = list(jax_bamio.BamReader(bam_file))[::-1]
    header = jax_bamio.BamReader(bam_file).header
    paths = {}
    for name, package in (("ours", bamio), ("theirs", jax_bamio)):
        path = str(tmp_path / f"{name}.bam")
        with jax_bamio.BamWriter(path, header) as writer:
            for read in reads:
                writer.write(read)
        package.sort_bam(path, path)
        package.index_bam(path)
        paths[name] = path
    assert open(paths["ours"], "rb").read() == open(paths["theirs"], "rb").read()
    assert open(paths["ours"] + ".bai", "rb").read() == open(paths["theirs"] + ".bai", "rb").read()
    # and both equal the original file's index, rebuilt by the port
    copy = str(tmp_path / "copy.bam")
    shutil.copy(bam_file, copy)
    bamio.index_bam(copy)
    assert open(copy + ".bai", "rb").read() == open(bam_file + ".bai", "rb").read()


@pytest.mark.parametrize("suffix", [".sam", ".sam.gz"])
def test_sam_round_trip(bam_file, tmp_path, suffix):
    sam_path = tmp_path / ("converted" + suffix)
    with bamio.BamReader(bam_file) as reader:
        bamio.write_sam(sam_path, reader.header, iter(reader))
    assert bamio.sniff_format(sam_path) == jax_bamio.sniff_format(sam_path)
    ours, theirs = bamio.open_alignment(sam_path), jax_bamio.open_alignment(sam_path)
    assert isinstance(ours, bamio.SamReader)
    assert [_fields(r) for r in ours] == [_fields(r) for r in theirs]

    def alignment(read):  # what SAM text carries of the BAM records
        return read.query_name, read.reference_id, read.reference_start, read.cigartuples, \
            read.query_sequence, read.query_qualities, read.tags

    assert [alignment(r) for r in ours] == [alignment(r) for r in bamio.BamReader(bam_file)]
    assert [alignment(r) for r in ours.fetch("chr2", 100, 700)] == [
        alignment(r) for r in bamio.BamReader(bam_file).fetch("chr2", 100, 700)
    ]


def test_cram_is_refused(tmp_path):
    cram = tmp_path / "sample.cram"
    cram.write_bytes(b"CRAM\x03\x00" + b"\x00" * 64)
    with pytest.raises(ValueError, match="samtools view -b"):
        bamio.open_alignment(cram)


@pytest.mark.parametrize("size", [0, 1000, 65280, 65280 * 3 + 17])
def test_bulk_bgzf_writer_matches_stream_writer(tmp_path, size):
    payload = np.random.RandomState(size % 97).randint(0, 4, size).astype(np.uint8).tobytes()
    bulk, stream = tmp_path / "bulk.gz", tmp_path / "stream.gz"
    sim._write_bgzf(str(bulk), payload)
    with jax_bamio.BgzfWriter(str(stream)) as writer:
        writer.write(payload)
    assert bulk.read_bytes() == stream.read_bytes()
    assert bamio.BgzfReader(str(bulk)).read_all() == payload


def test_generated_bam_is_what_the_record_writer_writes(tmp_path, monkeypatch):
    """The bulk fixture writer: sorted records, BamWriter's bytes, index_bam's index."""
    monkeypatch.setattr(sim, "_CHUNK_READS", 97)  # several chunks of records
    filename = str(tmp_path / "bulk.bam")
    _, genotypes, ids, names = sim.generate_bam_file(
        filename, n_genotypes=5, n_barcodes=50, n_reads_per_barcode=12,
        chromosome2length={"chr1": 1500, "chr2": 700}, rng=4,
    )
    reads = list(jax_bamio.BamReader(filename))
    assert len(reads) == 50 * 12
    keys = [(r.reference_id, r.reference_start) for r in reads]
    assert keys == sorted(keys)
    rewritten = str(tmp_path / "rewritten.bam")
    with jax_bamio.BamWriter(rewritten, jax_bamio.BamReader(filename).header) as writer:
        for read in reads:
            writer.write(read)
    assert open(rewritten, "rb").read() == open(filename, "rb").read()
    jax_bamio.index_bam(rewritten)
    assert open(rewritten + ".bai", "rb").read() == open(filename + ".bai", "rb").read()
    # every read is a slice of one of its barcode's donor genomes: its
    # bases at registered variants belong to those donors' alleles
    registry = genotypes.var2varid
    betas = genotypes.get_betas()
    for read in reads[:200]:
        donors = ids[read.get_tag("CB")]
        chromosome = ("chr1", "chr2")[read.reference_id]
        for offset, base in enumerate(read.query_sequence):
            row = registry.get((chromosome, read.reference_start + offset, base))
            if row is not None:
                assert betas[row, donors].max() == 100.0
    assert set(names) == set(ids) and len(names) == 50
    assert {tuple(read.tags)[:4] for read in reads} == {(("NM", 1), ("RG", "L1"), ("NH", 1), ("AS", 98))}
