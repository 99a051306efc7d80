"""SAM text ingestion, format sniffing, and CRAM detection.

A copy of ``demuxalot_tpu.bamio.sam``. The reference accepts anything
``pysam.AlignmentFile`` opens (demuxalot/snp_counter.py:247-248), which transparently
includes SAM and CRAM alongside BAM. This framework reads BAM natively
(``bamio/bam.py``); SAM — plain or gzipped — is parsed here into the same
:class:`AlignedRead` records behind the same reader surface, so the entire
counting/detection stack works on SAM inputs unchanged. CRAM's reference-
compressed codec zoo is deliberately out of scope: opening one raises a
curated "convert with ``samtools view -b``" error instead of a magic-byte
failure.

Design note: SAM has no index, so :class:`SamReader` parses the whole file
once at open and keeps per-chromosome, position-sorted record lists;
``fetch`` is then a binary search plus the same overlap semantics as the
indexed BAM fetch. That makes region tasks O(1) after the one-time parse —
the right trade for SAM, which in practice is a small-file interchange
format (production pipelines ship coordinate-sorted BAM).
"""
from __future__ import annotations

import gzip
from bisect import bisect_left
from pathlib import Path
from typing import Iterator, List, Optional, Union

from .bam import AlignedRead, BamHeader, IndexStats

_GZIP_MAGIC = b"\x1f\x8b"
_CRAM_MAGIC = b"CRAM"
_BAM_MAGIC = b"BAM\x01"

CRAM_UNSUPPORTED_MESSAGE = (
    "{path}: CRAM input is not supported — convert to BAM first, e.g. "
    "`samtools view -b -o converted.bam {path}` (and index it with "
    "`samtools index converted.bam`)"
)


def sniff_format(path: Union[str, Path]) -> str:
    """Classify an alignment file: 'bam', 'sam', 'sam.gz', or 'cram'.

    BAM is gzip(BGZF)-framed with an inner ``BAM\\x01`` magic; CRAM has a
    raw ``CRAM`` magic; gzipped text that is not BAM is treated as SAM.gz;
    anything else is treated as SAM text (the parser gives a precise error
    if it is not).
    """
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:4] == _CRAM_MAGIC:
        return "cram"
    if head[:2] == _GZIP_MAGIC:
        with gzip.open(path, "rb") as g:
            inner = g.read(4)
        return "bam" if inner == _BAM_MAGIC else "sam.gz"
    return "sam"


def open_alignment(path: Union[str, Path]):
    """Open an alignment file of any supported format (pysam-polymorphic).

    Returns a :class:`~.bam.BamReader` for BAM, a :class:`SamReader` for
    SAM / SAM.gz, and raises ``ValueError`` with conversion instructions
    for CRAM.
    """
    kind = sniff_format(path)
    if kind == "cram":
        raise ValueError(CRAM_UNSUPPORTED_MESSAGE.format(path=path))
    if kind == "bam":
        from .bam import BamReader

        return BamReader(path)
    return SamReader(path)


_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(_CIGAR_OPS)}

_B_SUBTYPES = frozenset("cCsSiIf")


def _parse_cigar(cigar: str):
    tuples = []
    length = 0
    for ch in cigar:
        if ch.isdigit():
            length = length * 10 + ord(ch) - 48
        else:
            tuples.append((_CIGAR_CODE[ch], length))
            length = 0
    return tuples


def parse_sam_line(line: str, ref2id: dict) -> AlignedRead:
    """One SAM alignment line -> :class:`AlignedRead` (SAM spec §1.4)."""
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 11:
        raise ValueError(f"malformed SAM line ({len(fields)} fields): {line[:80]!r}")
    read = AlignedRead()
    read.query_name = fields[0]
    read.flag = int(fields[1])
    read.reference_id = ref2id.get(fields[2], -1)
    read.reference_start = int(fields[3]) - 1  # SAM is 1-based
    read.mapping_quality = int(fields[4])
    if fields[5] != "*":
        read.cigartuples = _parse_cigar(fields[5])
    if fields[9] != "*":
        read.query_sequence = fields[9]
    if fields[10] != "*":
        read.query_qualities = [ord(c) - 33 for c in fields[10]]
    tags = []
    for column in fields[11:]:
        tag, typ, raw = column.split(":", 2)
        if typ == "i":
            value = int(raw)
        elif typ == "f":
            value = float(raw)
        elif typ in ("A", "Z", "H"):
            value = raw
        elif typ == "B":
            sub, *items = raw.split(",")
            if sub not in _B_SUBTYPES:
                raise ValueError(f"unknown SAM B-array subtype {sub!r} in {column!r}")
            cast = float if sub == "f" else int
            value = [cast(x) for x in items]
        else:
            raise ValueError(f"unknown SAM tag type {typ!r} in {column!r}")
        tags.append((tag, value))
    read.tags = tags
    return read


def read_to_sam_line(read: AlignedRead, references: List[str]) -> str:
    """Serialize one :class:`AlignedRead` as a SAM alignment line."""
    rname = (
        references[read.reference_id]
        if 0 <= read.reference_id < len(references) else "*"
    )
    ct = read.cigartuples
    cigar = "".join(f"{length}{_CIGAR_OPS[op]}" for op, length in ct) if ct else "*"
    seq = read.query_sequence or "*"
    quals = read.query_qualities
    qual = "".join(chr(q + 33) for q in quals) if quals else "*"
    fields = [
        read.query_name or "*", str(read.flag), rname,
        str(read.reference_start + 1), str(read.mapping_quality), cigar,
        "*", "0", "0", seq, qual,
    ]
    for tag, value in read.tags:
        if isinstance(value, bool):
            raise ValueError("boolean tags are not part of the SAM spec")
        if isinstance(value, str):
            fields.append(f"{tag}:Z:{value}")
        elif isinstance(value, int):
            fields.append(f"{tag}:i:{value}")
        elif isinstance(value, float):
            fields.append(f"{tag}:f:{value}")
        elif isinstance(value, (list, tuple)):
            sub = "f" if any(isinstance(x, float) for x in value) else "i"
            fields.append(f"{tag}:B:{sub}," + ",".join(str(x) for x in value))
        else:
            raise ValueError(f"cannot encode SAM tag {tag}={value!r}")
    return "\t".join(fields)


def write_sam(path: Union[str, Path], header: BamHeader, reads) -> None:
    """Write reads as SAM text (gzipped when the path ends in .gz)."""
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        if header.text:
            f.write(header.text if header.text.endswith("\n") else header.text + "\n")
        for read in reads:
            f.write(read_to_sam_line(read, header.references) + "\n")


class SamReader:
    """SAM text reader with the :class:`~.bam.BamReader` surface.

    Parses the whole file at open (plain text or gzip) into per-chromosome
    position-sorted lists; ``fetch`` then mirrors the BAI-driven BAM fetch:
    yields reads overlapping ``[start, stop)`` in coordinate order.
    """

    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        opener = gzip.open if sniff_format(self.path) == "sam.gz" else open
        header_lines: List[str] = []
        references: List[str] = []
        lengths: List[int] = []
        self._records: List[AlignedRead] = []  # file order, for __iter__
        with opener(self.path, "rt") as f:
            ref2id: dict = {}
            for line in f:
                if not line.strip():
                    continue
                if line.startswith("@"):
                    header_lines.append(line.rstrip("\n"))
                    if line.startswith("@SQ"):
                        sq = dict(
                            kv.split(":", 1) for kv in line.rstrip("\n").split("\t")[1:]
                        )
                        ref2id[sq["SN"]] = len(references)
                        references.append(sq["SN"])
                        lengths.append(int(sq["LN"]))
                    continue
                self._records.append(parse_sam_line(line, ref2id))
        text = "\n".join(header_lines)
        self.header = BamHeader(text + "\n" if text else "", references, lengths)

        # per-chromosome coordinate-sorted views (stable: preserves file
        # order among equal positions, like a coordinate sort would)
        n_ref = len(references)
        by_ref: List[List[AlignedRead]] = [[] for _ in range(n_ref)]
        self._unmapped = 0
        for read in self._records:
            if 0 <= read.reference_id < n_ref:
                by_ref[read.reference_id].append(read)
            else:
                self._unmapped += 1
        self._by_ref = [
            sorted(reads, key=lambda r: r.reference_start) for reads in by_ref
        ]
        self._starts = [[r.reference_start for r in reads] for reads in self._by_ref]
        # longest reference span per chromosome bounds how far before a
        # window a still-overlapping read can start (fetch correctness)
        self._max_span = [
            max(
                ((r.reference_end or r.reference_start + 1) - r.reference_start
                 for r in reads),
                default=1,
            )
            for reads in self._by_ref
        ]

    # -- pysam-compatible surface -------------------------------------------
    @property
    def references(self) -> List[str]:
        return self.header.references

    def get_reference_length(self, chromosome: str) -> int:
        return self.header.lengths[self.header.ref2id[chromosome]]

    def get_index_statistics(self) -> List[IndexStats]:
        out = []
        for i, name in enumerate(self.header.references):
            reads = self._by_ref[i]
            mapped = sum(1 for r in reads if not (r.flag & 0x4))
            out.append(IndexStats(name, mapped, len(reads) - mapped))
        return out

    def close(self):
        pass  # fully parsed at open; nothing held

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()

    def __iter__(self) -> Iterator[AlignedRead]:
        return iter(self._records)

    def fetch(
        self,
        chromosome: Optional[str] = None,
        start: Optional[int] = None,
        stop: Optional[int] = None,
    ) -> Iterator[AlignedRead]:
        """Iterate reads overlapping [start, stop), coordinate-sorted.

        Same overlap semantics as ``BamReader.fetch``: a read is yielded
        when its reference span intersects the window.
        """
        if chromosome is None:
            yield from iter(self)
            return
        ref_id = self.header.ref2id[chromosome]
        ref_len = self.header.lengths[ref_id]
        beg = 0 if start is None else max(0, int(start))
        end = ref_len if stop is None else min(ref_len, int(stop))
        if end <= beg:
            return
        reads = self._by_ref[ref_id]
        starts = self._starts[ref_id]
        # reads are position-sorted; anything starting before
        # beg - max_span cannot reach the window
        lo = bisect_left(starts, beg - self._max_span[ref_id])
        for read in reads[lo:]:
            if read.reference_start >= end:
                return
            r_end = read.reference_end
            if r_end is None:
                r_end = read.reference_start + 1
            if r_end > beg:
                yield read
