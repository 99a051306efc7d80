"""Synthetic data made from a seed: device workloads, call tables and BAM files.

``synthesize_device_workload`` and ``synthesize_compressed_calls`` port
``demuxalot_tpu.sim.synthesize_device_workload`` and
``benchmarks/synth_calls.synthesize_compressed_calls``; both draw from a
numpy ``RandomState`` in exactly the JAX package's order, so one seed gives
bit-identical arrays in both packages.

``generate_bam_file`` makes the same kind of fixture as
``demuxalot_tpu.sim.generate_bam_file`` (random reference, mutated donor
genomes, cellranger-style tagged reads in a coordinate-sorted, indexed
BAM, plus the ground truth) from an explicit ``np.random.Generator``. It
builds every record at once in numpy, already in coordinate order, and
compresses the BGZF blocks on a thread pool instead of writing one read at
a time; its random stream is its own.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from .bamio.bam import AlignedRead, BamHeader, _SEQ_TRANS, encode_record, header_bytes, index_bam
from .bamio.bgzf import BGZF_EOF, MAX_BLOCK_PAYLOAD, compress_block
from .frontend.snp_counter import MOLECULE_DTYPE, SNP_CALL_DTYPE, CompressedSNPCalls
from .models.genotypes import ProbabilisticGenotypes


def synthesize_device_workload(
    n_barcodes: int,
    n_donors: int,
    n_snps: int,
    calls_per_barcode: int,
    seed: int = 0,
):
    """Device-level workload: ground truth + packed call arrays.

    Produces (betas, variant2snp, vid, cb, q, truth_donor) with calls sorted
    by barcode; two variants per SNP, each donor at beta 100 on its allele.
    """
    rng = np.random.RandomState(seed)
    n_variants = n_snps * 2
    variant2snp = np.repeat(np.arange(n_snps, dtype=np.int32), 2)

    # two alleles per snp; each donor picks one with high confidence
    donor_allele = rng.randint(0, 2, size=(n_snps, n_donors))
    betas = np.full((n_variants, n_donors), 0.5, dtype=np.float32)
    snp_base_rows = np.arange(n_snps) * 2
    for donor in range(n_donors):
        betas[snp_base_rows + donor_allele[:, donor], donor] = 100.0

    truth_donor = rng.randint(0, n_donors, size=n_barcodes)
    n_calls = n_barcodes * calls_per_barcode
    cb = np.repeat(np.arange(n_barcodes, dtype=np.int32), calls_per_barcode)
    snp = rng.randint(0, n_snps, size=n_calls)
    # barcode's donor emits its own allele with small error probability
    allele = donor_allele[snp, truth_donor[cb]]
    flip = rng.rand(n_calls) < 0.02
    allele = np.where(flip, 1 - allele, allele)
    vid = (snp * 2 + allele).astype(np.int32)
    q = (0.1 ** (0.1 * rng.randint(20, 41, size=n_calls))).astype(np.float32)
    return betas, variant2snp, vid, cb, q, truth_donor


def synthesize_compressed_calls(
    n_barcodes: int,
    n_donors: int,
    n_snps: int,
    calls_per_barcode: int,
    doublets_fraction: float = 0.2,
    flip_prob: float = 0.02,
    seed: int = 0,
):
    """Synthetic truth as (genotypes, {"chr1": calls}, truth, donor names).

    The generative model of :func:`synthesize_device_workload` (two alleles
    per SNP, per-donor allele at beta 100 vs 0.5, a small per-call flip)
    plus doublet barcodes, emitted as a genotype registry and
    ``CompressedSNPCalls`` so a run goes through packing and the EM engine.
    ``truth[b]`` lists the donor names of barcode b (two for a doublet).
    """
    rng = np.random.RandomState(seed)
    donor_names = [f"Donor{i + 1:02}" for i in range(n_donors)]
    donor_allele = rng.randint(0, 2, size=(n_snps, n_donors))

    # registry: two variants per SNP ("A" = allele 0, "C" = allele 1),
    # registered in SNP order
    genotypes = ProbabilisticGenotypes(donor_names)
    bases = ("A", "C")
    for pos in range(n_snps):
        for allele in (0, 1):
            genotypes.get_variant_id("chr1", pos, bases[allele])
    betas = np.full((2 * n_snps, n_donors), 0.5, dtype=np.float32)
    rows = np.arange(n_snps) * 2
    for donor in range(n_donors):
        betas[rows + donor_allele[:, donor], donor] = 100.0
    genotypes = genotypes._with_betas(betas)

    # barcode truth: one donor, or two distinct donors for doublets
    primary = rng.randint(0, n_donors, size=n_barcodes)
    is_doublet = rng.rand(n_barcodes) < doublets_fraction
    secondary = (primary + 1 + rng.randint(0, n_donors - 1, size=n_barcodes)) % n_donors
    truth = [
        sorted({donor_names[primary[b]], donor_names[secondary[b]]})
        if is_doublet[b] else [donor_names[primary[b]]]
        for b in range(n_barcodes)
    ]

    n_calls = n_barcodes * calls_per_barcode
    cb = np.repeat(np.arange(n_barcodes, dtype=np.int32), calls_per_barcode)
    # per call: pick one of the barcode's donors, emit that donor's allele
    use_secondary = is_doublet[cb] & (rng.rand(n_calls) < 0.5)
    call_donor = np.where(use_secondary, secondary[cb], primary[cb])
    snp = rng.randint(0, n_snps, size=n_calls).astype(np.int32)
    allele = donor_allele[snp, call_donor]
    flip = rng.rand(n_calls) < flip_prob
    allele = np.where(flip, 1 - allele, allele).astype(np.int64)
    q = (0.1 ** (0.1 * rng.randint(20, 41, size=n_calls))).astype(np.float32)

    molecules = np.empty(n_calls, dtype=MOLECULE_DTYPE)
    molecules["compressed_cb"] = cb
    molecules["compressed_ub"] = np.arange(n_calls, dtype=np.int32)
    molecules["p_group_misaligned"] = 0.01
    snp_calls = np.empty(n_calls, dtype=SNP_CALL_DTYPE)
    snp_calls["molecule_index"] = np.arange(n_calls, dtype=np.int32)
    snp_calls["snp_position"] = snp
    # base codes: A=0, C=1 (utils.encoding.base_lookup)
    snp_calls["base_index"] = allele.astype(np.uint8)
    snp_calls["p_base_wrong"] = q

    calls = CompressedSNPCalls()
    calls.molecules = molecules
    calls.snp_calls = snp_calls
    calls._finalized = True
    return genotypes, {"chr1": calls}, truth, donor_names


_BASE_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_SEQ_CODE = np.frombuffer(_SEQ_TRANS, dtype=np.uint8)  # ASCII -> 4-bit BAM code
# reads whose sequences are gathered at once (bounds the [reads, length] index array)
_CHUNK_READS = 1 << 16


def random_ascii_bases(rng: np.random.Generator, shape) -> np.ndarray:
    """uint8 ASCII codes of uniformly random A/C/G/T."""
    return _BASE_ASCII[rng.integers(0, 4, size=shape)]


class SyntheticReference:
    """Random reference genome; sequences are uint8 ASCII arrays per chromosome."""

    def __init__(self, chromosome2length: Dict[str, int], rng: np.random.Generator):
        self.chromosome2sequence = {
            chromosome: random_ascii_bases(rng, length) for chromosome, length in chromosome2length.items()
        }
        self.chromosome2length = dict(chromosome2length)

    def bam_header(self) -> dict:
        return {
            "HD": {"VN": "1.0"},
            "SQ": [dict(LN=length, SN=name) for name, length in self.chromosome2length.items()],
        }

    def mutate(self, mutation_prob: float, rng: np.random.Generator) -> "SyntheticReference":
        """Derive a donor genome by random point mutations."""
        result = SyntheticReference.__new__(SyntheticReference)
        result.chromosome2length = dict(self.chromosome2length)
        result.chromosome2sequence = {}
        for chrom, seq in self.chromosome2sequence.items():
            seq = seq.copy()
            mask = rng.random(len(seq)) < mutation_prob
            seq[mask] = random_ascii_bases(rng, int(mask.sum()))
            result.chromosome2sequence[chrom] = seq
        return result


def genotypes_from_donor_genomes(donor_genomes: List[SyntheticReference]) -> ProbabilisticGenotypes:
    """Ground-truth betas: 100 at each donor's base, 0.5 elsewhere.

    Only polymorphic positions (where donors disagree) become variants,
    registered per chromosome by ascending position, bases in first-seen
    donor order, as ``demuxalot_tpu.sim.genotypes_from_donor_genomes`` does.
    """
    donor_names = [f"Donor{donor_id + 1:02}" for donor_id in range(len(donor_genomes))]
    result = ProbabilisticGenotypes(donor_names)
    rows: List[int] = []
    donor_of_row: List[int] = []
    for chrom in donor_genomes[0].chromosome2length:
        seqs = np.stack([g.chromosome2sequence[chrom] for g in donor_genomes])  # [D, L]
        polymorphic = (seqs != seqs[:1]).any(axis=0)
        for pos in np.nonzero(polymorphic)[0]:
            local: Dict[int, int] = {}
            for donor_index, base in enumerate(seqs[:, pos].tolist()):
                row = local.get(base)
                if row is None:
                    row = local[base] = result.get_variant_id(chrom, int(pos), chr(base))
                rows.append(row)
                donor_of_row.append(donor_index)
    betas = np.full((result.n_variants, len(donor_names)), 0.5, dtype=np.float32)
    if rows:
        betas[np.asarray(rows), np.asarray(donor_of_row)] = 100.0
    return result._with_betas(betas)


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """``bamio.bam.reg2bin`` over arrays: the finest level holding [beg, end)."""
    last = end - 1
    out = np.zeros_like(beg)
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out = np.where((beg >> shift) == (last >> shift), base + (beg >> shift), out)
    return out


def _record_template(read_length: int, name_length: int, barcode: str, umi_length: int):
    """One encoded synthetic read, and the byte offsets of its variable fields.

    The record is what ``demuxalot_tpu.sim`` writes per read: flag 99,
    MAPQ 255, one M op, quality 27 everywhere, tags NM, RG, NH, AS, CB, UB.
    """
    read = AlignedRead()
    read.query_name = "N" * name_length
    read.query_sequence = "A" * read_length
    read.flag = 99
    read.reference_id = 0
    read.reference_start = 0
    read.mapping_quality = 255
    read.cigar = ((0, read_length),)
    read.template_length = read_length
    read.query_qualities = [27] * read_length
    read.tags = (
        ("NM", 1), ("RG", "L1"), ("NH", 1), ("AS", read_length - 2),
        ("CB", barcode), ("UB", "U" * umi_length),
    )
    raw = np.frombuffer(encode_record(read), dtype=np.uint8)
    seq_at = 4 + 32 + name_length + 1 + 4  # block size, fixed fields, name + NUL, one cigar op
    offsets = dict(
        ref=4, pos=8, bin=14, name=36, seq=seq_at,
        cb=raw.tobytes().index(b"CBZ") + 3, ub=raw.tobytes().index(b"UBZ") + 3,
    )
    return raw, offsets


def _fill_records(records: np.ndarray, offsets: dict, ref, pos, read_length, names, umis,
                  barcodes, sequences) -> None:
    """Write the variable fields of ``len(ref)`` reads into ``records`` rows."""
    def put(field: str, values: np.ndarray) -> None:
        width = values.shape[1]
        records[:, offsets[field]:offsets[field] + width] = values

    put("ref", ref.astype("<i4").view(np.uint8).reshape(-1, 4))
    put("pos", pos.astype("<i4").view(np.uint8).reshape(-1, 4))
    put("bin", _reg2bin(pos, pos + read_length).astype("<u2").view(np.uint8).reshape(-1, 2))
    put("name", names)
    put("ub", umis)
    put("cb", barcodes)
    codes = _SEQ_CODE[sequences]
    if read_length % 2:
        codes = np.concatenate([codes, np.zeros((len(codes), 1), np.uint8)], axis=1)
    put("seq", (codes[:, 0::2] << 4) | codes[:, 1::2])


def _write_bgzf(path: str, payload) -> None:
    """Write ``payload`` (any bytes-like object) as one BGZF file, fast.

    Exists only to make the fixture quickly: the payload is cut into
    ``MAX_BLOCK_PAYLOAD`` blocks exactly as ``BgzfWriter`` cuts a stream,
    and the blocks are compressed at its default level on a thread pool
    (zlib releases the GIL), so the file is byte-identical to writing the
    payload through ``BgzfWriter``.
    """
    from concurrent.futures import ThreadPoolExecutor

    view = memoryview(payload).cast("B")
    starts = range(0, len(view), MAX_BLOCK_PAYLOAD)
    with ThreadPoolExecutor() as pool:
        blocks = pool.map(lambda start: compress_block(view[start:start + MAX_BLOCK_PAYLOAD], 6), starts)
        with open(path, "wb") as fh:
            for block in blocks:
                fh.write(block)
            fh.write(BGZF_EOF)


def generate_bam_file(
    filename: str,
    n_genotypes: int = 20,
    doublets_fraction: float = 0.2,
    mutation_prob: float = 0.01,
    read_length: int = 100,
    n_barcodes: int = 1000,
    n_reads_per_barcode: int = 100,
    chromosome2length: Dict[str, int] = None,
    rng: Union[int, np.random.Generator] = 0,
):
    """Synthesize a coordinate-sorted, indexed BAM plus ground truth.

    Returns (filename, genotypes, barcode2donor_ids, barcode2donor_names)
    as ``demuxalot_tpu.sim.generate_bam_file`` does. ``doublets_fraction``
    of barcodes mix reads from two random donors (possibly the same one).
    Barcodes are distinct 10-base strings with a "-1" suffix; every read
    is its own molecule (a random 10-base UMI). ``rng`` is a
    ``np.random.Generator`` or its seed.
    """
    rng = np.random.default_rng(rng)
    if chromosome2length is None:
        chromosome2length = {"chr1": 1000, "chr2": 1000, "chr3": 1000}
    reference = SyntheticReference(chromosome2length, rng)
    donor_genomes = [reference.mutate(mutation_prob, rng) for _ in range(n_genotypes)]
    prob_genotypes = genotypes_from_donor_genomes(donor_genomes)

    # barcodes: distinct 10-base codes (4**10 of them) rendered as strings
    codes = rng.choice(4 ** 10, size=n_barcodes, replace=False)
    digits = (codes[:, None] >> (2 * np.arange(9, -1, -1))) & 3
    barcode_ascii = np.concatenate(
        [_BASE_ASCII[digits], np.frombuffer(b"-1", np.uint8)[None].repeat(n_barcodes, 0)], axis=1,
    )
    barcodes = [row.tobytes().decode("ascii") for row in barcode_ascii]
    is_doublet = rng.random(n_barcodes) < doublets_fraction
    donor_pairs = rng.integers(0, n_genotypes, size=(n_barcodes, 2))
    barcode2donor_ids = {}
    barcode2donor_names = {}
    for barcode, doublet, pair in zip(barcodes, is_doublet, donor_pairs):
        donor_ids = pair[: 1 + int(doublet)]
        barcode2donor_ids[barcode] = donor_ids
        barcode2donor_names[barcode] = [f"Donor{donor_id + 1:02}" for donor_id in donor_ids]

    # reads: barcode, donor (one of the barcode's), chromosome and start
    n_reads = n_barcodes * n_reads_per_barcode
    read_barcode = np.repeat(np.arange(n_barcodes), n_reads_per_barcode)
    pick = rng.integers(0, 1 + is_doublet[read_barcode])
    read_donor = donor_pairs[read_barcode, pick]
    lengths = np.array(list(chromosome2length.values()), dtype=np.int64)
    read_ref = rng.integers(0, len(lengths), size=n_reads)
    read_pos = rng.integers(0, lengths[read_ref] - read_length)
    names = random_ascii_bases(rng, (n_reads, 20))
    umis = random_ascii_bases(rng, (n_reads, 10))

    # coordinate order (stable: ties keep generation order, as sort_bam does)
    order = np.lexsort((read_pos, read_ref))
    template, offsets = _record_template(read_length, 20, barcodes[0], 10)
    head = header_bytes(BamHeader.from_dict(reference.bam_header()))
    payload = np.empty(len(head) + n_reads * len(template), dtype=np.uint8)
    payload[: len(head)] = np.frombuffer(head, np.uint8)
    records = payload[len(head):].reshape(n_reads, len(template))
    records[:] = template
    # donor genomes per chromosome, flattened [D * L] for one gather per read
    flat_genomes = [
        np.stack([g.chromosome2sequence[c] for g in donor_genomes]).reshape(-1) for c in chromosome2length
    ]
    window = np.arange(read_length)
    for lo in range(0, n_reads, _CHUNK_READS):
        rows = order[lo: lo + _CHUNK_READS]
        ref, pos, donor = read_ref[rows], read_pos[rows], read_donor[rows]
        sequences = np.empty((len(rows), read_length), np.uint8)
        for c, genome in enumerate(flat_genomes):
            on_c = ref == c
            starts = donor[on_c] * lengths[c] + pos[on_c]
            sequences[on_c] = genome[starts[:, None] + window]
        _fill_records(records[lo: lo + _CHUNK_READS], offsets, ref, pos, read_length, names[rows],
                      umis[rows], barcode_ascii[read_barcode[rows]], sequences)
    _write_bgzf(filename, payload)
    index_bam(filename)
    return filename, prob_genotypes, barcode2donor_ids, barcode2donor_names
