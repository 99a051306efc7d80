"""BAM file reading and writing, from scratch.

Implements the BAM binary format (SAM spec §4) on top of the BGZF layer:
record parsing with lazy tag/sequence decoding, coordinate-sorted writing,
region fetch via BAI indexes, and a pysam-compatible-enough ``AlignedRead``
so that user-supplied ``parse_read`` callbacks look identical to the
reference's plugin interface (demuxalot/cellranger_specific.py:13-36).

The reference used pysam/htslib for all of this; the package carries its
own implementation instead (a copy of ``demuxalot_tpu.bamio.bam``). The
C++ bulk scanner (``demuxalot_tpu_torch.native.scanner``) replaces the
Python record loop on the counting path.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

BAM_MAGIC = b"BAM\x01"

# 4-bit nucleotide code used in BAM seq fields
SEQ_DECODE = "=ACMGRSVTWYHKDBN"
SEQ_ENCODE = {c: i for i, c in enumerate(SEQ_DECODE)}
SEQ_ENCODE["N"] = 15
# byte-level translation table: ASCII base -> 4-bit code (unknown -> N=15)
_SEQ_TRANS = bytes(
    SEQ_ENCODE.get(chr(b), 15) for b in range(256)
)
# hex digit (as emitted by bytes.hex()) -> decoded base character
_HEX2BASE = str.maketrans("0123456789abcdef", SEQ_DECODE)

CIGAR_OPS = "MIDNSHP=X"
CIGAR_ENCODE = {c: i for i, c in enumerate(CIGAR_OPS)}

# cigar ops that consume the reference
_REF_CONSUMING = frozenset([0, 2, 3, 7, 8])  # M, D, N, =, X

_FIXED = struct.Struct("<iiBBHHHIiii")


def qualitystring_to_array(s: str) -> List[int]:
    """Phred+33 quality string -> list of int quality scores."""
    return [ord(c) - 33 for c in s]


class AlignedRead:
    """One alignment record, lazily decoded.

    Attribute names follow pysam so that read-filtering plugins written
    against either library work unchanged: ``reference_start``,
    ``reference_end``, ``pos``, ``mapq``, ``seq``, ``query_qualities``,
    ``cigartuples``, ``has_tag``/``get_tag``/``set_tag``.
    """

    __slots__ = (
        "query_name", "flag", "reference_id", "reference_start", "mapping_quality",
        "next_reference_id", "next_reference_start", "template_length",
        "_cigar_raw", "_seq_raw", "_qual_raw", "_tags_raw", "_l_seq",
        "_cigartuples", "_seq", "_qual", "_tags", "_reference_end",
    )

    def __init__(self):
        self.query_name = ""
        self.flag = 0
        self.reference_id = -1
        self.reference_start = -1
        self.mapping_quality = 0
        self.next_reference_id = -1
        self.next_reference_start = -1
        self.template_length = 0
        self._cigar_raw = b""
        self._seq_raw = b""
        self._qual_raw = b""
        self._tags_raw = b""
        self._l_seq = 0
        self._cigartuples = None
        self._seq = None
        self._qual = None
        self._tags = None
        self._reference_end = None

    # -- aliases used by reference-style callbacks ------------------------
    @property
    def pos(self) -> int:
        return self.reference_start

    @pos.setter
    def pos(self, value: int):
        self.reference_start = value

    @property
    def mapq(self) -> int:
        return self.mapping_quality

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    # -- cigar ------------------------------------------------------------
    @property
    def cigartuples(self) -> Optional[List[Tuple[int, int]]]:
        if self._cigartuples is None and self._cigar_raw:
            raw = np.frombuffer(self._cigar_raw, dtype="<u4")
            self._cigartuples = [(int(v & 0xF), int(v >> 4)) for v in raw]
        return self._cigartuples

    @cigartuples.setter
    def cigartuples(self, tuples):
        self._cigartuples = [(int(op), int(length)) for op, length in tuples]
        self._cigar_raw = b""
        self._reference_end = None

    # pysam-style setter alias: read.cigar = ((0, 100),)
    @property
    def cigar(self):
        return self.cigartuples

    @cigar.setter
    def cigar(self, tuples):
        self.cigartuples = tuples

    @property
    def reference_end(self) -> Optional[int]:
        if self._reference_end is None:
            ct = self.cigartuples
            if not ct:
                return None
            span = sum(l for op, l in ct if op in _REF_CONSUMING)
            self._reference_end = self.reference_start + span
        return self._reference_end

    # -- sequence / qualities --------------------------------------------
    @property
    def query_sequence(self) -> Optional[str]:
        if self._seq is None and self._l_seq:
            # hex() emits one hex digit per nibble in order, so a hex-digit
            # -> base translation decodes the whole read in two C calls
            # (the per-char loop this replaces dominated scan profiles)
            self._seq = self._seq_raw.hex().translate(_HEX2BASE)[: self._l_seq]
        return self._seq

    @query_sequence.setter
    def query_sequence(self, value: str):
        self._seq = value
        self._l_seq = len(value) if value else 0
        self._seq_raw = b""

    @property
    def seq(self):
        return self.query_sequence

    @property
    def query_qualities(self):
        if self._qual is None and self._qual_raw:
            self._qual = list(self._qual_raw)
        return self._qual

    @query_qualities.setter
    def query_qualities(self, value):
        self._qual = list(value) if value is not None else None
        self._qual_raw = b""

    # -- tags -------------------------------------------------------------
    def _ensure_tags(self) -> dict:
        if self._tags is None:
            self._tags = _parse_tags(self._tags_raw) if self._tags_raw else {}
        return self._tags

    def has_tag(self, tag: str) -> bool:
        return tag in self._ensure_tags()

    def get_tag(self, tag: str):
        return self._ensure_tags()[tag]

    def set_tag(self, tag: str, value) -> None:
        self._ensure_tags()[tag] = value
        self._tags_raw = b""

    @property
    def tags(self):
        return list(self._ensure_tags().items())

    @tags.setter
    def tags(self, tag_list):
        self._tags = dict(tag_list)
        self._tags_raw = b""

    def __repr__(self):
        return (
            f"<AlignedRead {self.query_name} ref={self.reference_id} "
            f"pos={self.reference_start} flag={self.flag}>"
        )


def _parse_tags(raw: bytes) -> dict:
    tags = {}
    pos = 0
    n = len(raw)
    while pos + 3 <= n:
        tag = raw[pos : pos + 2].decode("ascii")
        typ = chr(raw[pos + 2])
        pos += 3
        if typ == "A":
            tags[tag] = chr(raw[pos]); pos += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", raw, pos)[0]; pos += 1
        elif typ == "C":
            tags[tag] = struct.unpack_from("<B", raw, pos)[0]; pos += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", raw, pos)[0]; pos += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", raw, pos)[0]; pos += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", raw, pos)[0]; pos += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", raw, pos)[0]; pos += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", raw, pos)[0]; pos += 4
        elif typ in ("Z", "H"):
            end = raw.index(b"\x00", pos)
            tags[tag] = raw[pos:end].decode("ascii")
            pos = end + 1
        elif typ == "B":
            sub = chr(raw[pos]); pos += 1
            (count,) = struct.unpack_from("<I", raw, pos); pos += 4
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            size = struct.calcsize(fmt)
            tags[tag] = list(struct.unpack_from(f"<{count}{fmt}", raw, pos))
            pos += count * size
        else:
            raise ValueError(f"unknown tag type {typ!r} for tag {tag}")
    return tags


def _encode_tags(tags) -> bytes:
    out = bytearray()
    for tag, value in tags:
        out.extend(tag.encode("ascii"))
        if isinstance(value, str):
            # strings always encode as 'Z'; single chars are never auto-'A'
            out.append(ord("Z"))
            out.extend(value.encode("ascii"))
            out.append(0)
        elif isinstance(value, bool):
            raise ValueError("boolean tags are not part of the BAM spec")
        elif isinstance(value, (int, np.integer)):
            value = int(value)
            if -(2**31) <= value < 2**31:
                out.append(ord("i"))
                out.extend(struct.pack("<i", value))
            else:
                raise ValueError(f"integer tag out of range: {value}")
        elif isinstance(value, (float, np.floating)):
            out.append(ord("f"))
            out.extend(struct.pack("<f", float(value)))
        elif isinstance(value, (list, tuple, np.ndarray)):
            out.append(ord("B"))
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.floating):
                sub, fmt = "f", "f"
                arr = arr.astype("<f4")
            else:
                sub, fmt = "i", "i"
                arr = arr.astype("<i4")
            out.extend(sub.encode("ascii"))
            out.extend(struct.pack("<I", len(arr)))
            out.extend(arr.tobytes())
        else:
            raise ValueError(f"cannot encode tag {tag}={value!r}")
    return bytes(out)


def parse_record(raw: bytes, offset: int = 0, end: Optional[int] = None) -> AlignedRead:
    """Parse one alignment record body (without the leading block_size)."""
    (
        ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
        next_ref_id, next_pos, tlen,
    ) = _FIXED.unpack_from(raw, offset)
    read = AlignedRead()
    read.reference_id = ref_id
    read.reference_start = pos
    read.mapping_quality = mapq
    read.flag = flag
    read.next_reference_id = next_ref_id
    read.next_reference_start = next_pos
    read.template_length = tlen

    p = offset + 32
    read.query_name = raw[p : p + l_read_name - 1].decode("ascii")
    p += l_read_name
    read._cigar_raw = raw[p : p + 4 * n_cigar]
    p += 4 * n_cigar
    seq_bytes = (l_seq + 1) // 2
    read._seq_raw = raw[p : p + seq_bytes]
    read._l_seq = l_seq
    p += seq_bytes
    read._qual_raw = raw[p : p + l_seq]
    p += l_seq
    read._tags_raw = raw[p : (end if end is not None else len(raw))]
    return read


def reg2bin(beg: int, end: int) -> int:
    """Compute the R-tree bin for interval [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins that may contain reads overlapping [beg, end)."""
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BamHeader:
    """Parsed BAM header: SAM text plus the reference dictionary."""

    def __init__(self, text: str, references: List[str], lengths: List[int]):
        self.text = text
        self.references = list(references)
        self.lengths = list(lengths)
        self.ref2id = {name: i for i, name in enumerate(self.references)}

    @staticmethod
    def from_dict(header: dict) -> "BamHeader":
        """Build from a pysam-style dict: {'HD': {...}, 'SQ': [{'SN', 'LN'}]}"""
        lines = []
        hd = header.get("HD")
        if hd:
            lines.append("@HD\t" + "\t".join(f"{k}:{v}" for k, v in hd.items()))
        references, lengths = [], []
        for sq in header.get("SQ", []):
            references.append(str(sq["SN"]))
            lengths.append(int(sq["LN"]))
            lines.append(f"@SQ\tSN:{sq['SN']}\tLN:{sq['LN']}")
        for rg in header.get("RG", []):
            lines.append("@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items()))
        text = "\n".join(lines)
        if text:
            text += "\n"
        return BamHeader(text, references, lengths)


class IndexStats:
    __slots__ = ("contig", "mapped", "unmapped", "total")

    def __init__(self, contig, mapped, unmapped):
        self.contig = contig
        self.mapped = mapped
        self.unmapped = unmapped
        self.total = mapped + unmapped


class BamReader:
    """Random-access BAM reader (``pysam.AlignmentFile`` work-alike).

    Supports full iteration and BAI-driven region ``fetch``; loads the
    companion ``.bai`` lazily from ``<path>.bai``.
    """

    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        self._bgzf = BgzfReader(self.path)
        magic = self._bgzf.read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        text = self._bgzf.read(l_text).decode("utf-8", errors="replace").rstrip("\x00")
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        references, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            references.append(name)
            lengths.append(l_ref)
        self.header = BamHeader(text, references, lengths)
        self._first_record_voffset = self._bgzf.virtual_offset
        self._index = None

    # -- pysam-compatible surface -----------------------------------------
    @property
    def references(self) -> List[str]:
        return self.header.references

    def get_reference_length(self, chromosome: str) -> int:
        return self.header.lengths[self.header.ref2id[chromosome]]

    def get_index_statistics(self) -> List[IndexStats]:
        index = self._load_index()
        out = []
        for i, name in enumerate(self.header.references):
            mapped, unmapped = index.mapped_unmapped(i)
            out.append(IndexStats(name, mapped, unmapped))
        return out

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()

    # -- iteration ---------------------------------------------------------
    def _read_record(self) -> Optional[AlignedRead]:
        size_raw = self._bgzf.read(4)
        if len(size_raw) < 4:
            return None
        (block_size,) = struct.unpack("<I", size_raw)
        body = self._bgzf.read(block_size)
        if len(body) < block_size:
            raise EOFError("truncated BAM record")
        return parse_record(body)

    def __iter__(self) -> Iterator[AlignedRead]:
        self._bgzf.seek_virtual(self._first_record_voffset)
        while True:
            read = self._read_record()
            if read is None:
                return
            yield read

    def _load_index(self):
        if self._index is None:
            from .bai import BaiIndex

            bai_path = Path(self.path + ".bai")
            if not bai_path.exists():
                alt = Path(self.path).with_suffix(".bai")
                if alt.exists():
                    bai_path = alt
                else:
                    raise FileNotFoundError(f"no index found for {self.path}")
            self._index = BaiIndex.load(bai_path)
        return self._index

    def fetch(
        self,
        chromosome: Optional[str] = None,
        start: Optional[int] = None,
        stop: Optional[int] = None,
    ) -> Iterator[AlignedRead]:
        """Iterate reads overlapping [start, stop) on ``chromosome``.

        Requires a BAI index (like pysam). With no arguments iterates the
        whole file in order.
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

        index = self._load_index()
        chunks = index.chunks_for_region(ref_id, beg, end)
        for chunk_beg, chunk_end in chunks:
            self._bgzf.seek_virtual(chunk_beg)
            while self._bgzf.virtual_offset < chunk_end:
                read = self._read_record()
                if read is None:
                    break
                if read.reference_id != ref_id:
                    if read.reference_id > ref_id or read.reference_id == -1:
                        break
                    continue
                if read.reference_start >= end:
                    break
                r_end = read.reference_end
                if r_end is None:
                    r_end = read.reference_start + 1
                if r_end > beg:
                    yield read

    # -- pileup-style coverage counting ------------------------------------
    def count_coverage(
        self,
        chromosome: str,
        start: Optional[int] = None,
        stop: Optional[int] = None,
        read_callback=None,
        quality_threshold: int = 15,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-position A/C/G/T coverage over [start, stop).

        Mirrors ``pysam.AlignmentFile.count_coverage`` closely enough for the
        SNP-discovery scan (reference: demuxalot/snp_detection.py:36-42):
        reads pass ``read_callback``, bases below ``quality_threshold`` are
        ignored (pysam's default threshold is 15).
        """
        ref_id = self.header.ref2id[chromosome]
        ref_len = self.header.lengths[ref_id]
        beg = 0 if start is None else max(0, int(start))
        end = ref_len if stop is None else min(ref_len, int(stop))
        length = max(0, end - beg)
        counts = np.zeros((4, length), dtype=np.int64)
        if length == 0:
            return tuple(counts)  # type: ignore[return-value]

        base_to_row = {"A": 0, "C": 1, "G": 2, "T": 3}
        for read in self.fetch(chromosome, beg, end):
            if read.is_unmapped:
                continue
            if read_callback is not None and not read_callback(read):
                continue
            seq = read.query_sequence
            qual = read.query_qualities
            if seq is None:
                continue
            read_pos = 0
            ref_pos = read.reference_start
            for op, l in read.cigartuples:
                if op in (0, 7, 8):  # M, =, X
                    lo = max(ref_pos, beg)
                    hi = min(ref_pos + l, end)
                    for rp in range(lo, hi):
                        qp = read_pos + (rp - ref_pos)
                        if qual is not None and qual[qp] < quality_threshold:
                            continue
                        row = base_to_row.get(seq[qp])
                        if row is not None:
                            counts[row, rp - beg] += 1
                    ref_pos += l
                    read_pos += l
                elif op in (2, 3):  # D, N
                    ref_pos += l
                elif op in (1, 4):  # I, S
                    read_pos += l
                # H, P consume nothing
        return counts[0], counts[1], counts[2], counts[3]


class BamWriter:
    """Coordinate-order BAM writer (``pysam.AlignmentFile(..., 'wb')`` work-alike)."""

    def __init__(self, path: Union[str, Path], header: Union[dict, BamHeader]):
        if isinstance(header, dict):
            header = BamHeader.from_dict(header)
        self.header = header
        self._bgzf = BgzfWriter(path)
        self._write_header()

    def _write_header(self):
        self._bgzf.write(header_bytes(self.header))

    def write(self, read: AlignedRead) -> None:
        self._bgzf.write(encode_record(read))

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()


def header_bytes(header: BamHeader) -> bytes:
    """The uncompressed BAM header: magic, SAM text and reference dictionary."""
    text = header.text.encode("utf-8")
    out = bytearray()
    out += BAM_MAGIC
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(header.references))
    for name, length in zip(header.references, header.lengths):
        name_b = name.encode("ascii") + b"\x00"
        out += struct.pack("<i", len(name_b))
        out += name_b
        out += struct.pack("<i", length)
    return bytes(out)


def encode_record(read: AlignedRead) -> bytes:
    """Serialize a record to its on-disk bytes (including leading block_size)."""
    name_b = read.query_name.encode("ascii") + b"\x00"
    ct = read.cigartuples or []
    cigar_raw = b"".join(struct.pack("<I", (l << 4) | op) for op, l in ct)
    seq = read.query_sequence or ""
    l_seq = len(seq)
    # nibble-pack via a byte translation + vectorized shift (the per-char
    # dict loop dominated write profiles at ~50 us/read)
    # errors="replace" turns non-ASCII codepoints into '?', which the table
    # maps to N — matching the old per-char loop's unknown-base handling
    codes = seq.encode("ascii", errors="replace").translate(_SEQ_TRANS)
    if l_seq % 2:
        codes += b"\x00"
    arr = np.frombuffer(codes, dtype=np.uint8)
    seq_raw = ((arr[0::2] << 4) | arr[1::2]).astype(np.uint8).tobytes()
    qual = read.query_qualities
    if qual is None:
        qual_raw = b"\xff" * l_seq
    else:
        qual_raw = bytes(qual)
    tags_raw = read._tags_raw or _encode_tags(read.tags)

    if ct:
        span = sum(l for op, l in ct if op in _REF_CONSUMING)
        bin_ = reg2bin(read.reference_start, read.reference_start + max(span, 1))
    else:
        bin_ = reg2bin(read.reference_start, read.reference_start + 1)

    body = (
        _FIXED.pack(
            read.reference_id,
            read.reference_start,
            len(name_b),
            read.mapping_quality,
            bin_,
            len(ct),
            read.flag,
            l_seq,
            read.next_reference_id,
            read.next_reference_start,
            read.template_length,
        )
        + name_b
        + cigar_raw
        + seq_raw
        + qual_raw
        + tags_raw
    )
    return struct.pack("<I", len(body)) + body


def sort_bam(in_path: Union[str, Path], out_path: Union[str, Path]) -> None:
    """Coordinate-sort a BAM in memory (``pysam.sort`` work-alike).

    Sorts RAW record bytes — (refID, pos) live at fixed offsets 0/4 of
    each record body, so no record is ever decoded or re-encoded.
    In-memory sort is fine for test fixtures; production inputs arrive
    already coordinate-sorted from cellranger/STARsolo.
    """
    reader = BamReader(in_path)  # parses the header and positions the stream
    bgzf = reader._bgzf
    records = []
    while True:
        head = bgzf.read(4)
        if len(head) < 4:
            break
        (block_size,) = struct.unpack("<I", head)
        body = bgzf.read(block_size)
        if len(body) < block_size:
            raise ValueError("truncated BAM record during sort")
        ref_id, pos = struct.unpack_from("<ii", body, 0)
        key = (ref_id if ref_id >= 0 else 2**31, pos)
        records.append((key, head + body))
    records.sort(key=lambda kv: kv[0])
    writer = BamWriter(str(out_path) + ".sorting.tmp", reader.header)
    for _, raw in records:
        writer._bgzf.write(raw)
    writer.close()
    Path(str(out_path) + ".sorting.tmp").replace(out_path)


def index_bam(path: Union[str, Path]) -> None:
    """Build a ``.bai`` index for a coordinate-sorted BAM (``pysam.index``)."""
    from .bai import build_bai

    build_bai(path)
