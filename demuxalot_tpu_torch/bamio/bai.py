"""BAI (BAM index) reading and writing (SAM spec §5).

Provides random region access for the streaming SNP counter: region-sharded
worker processes each fetch only their genomic slice of the BAM (the
reference achieved this through pysam/htslib; here the index handling is
native to the framework). A copy of ``demuxalot_tpu.bamio.bai``.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

from .bgzf import BgzfReader
from .bam import BAM_MAGIC, reg2bin, reg2bins, _FIXED

BAI_MAGIC = b"BAI\x01"
PSEUDO_BIN = 37450
LINEAR_SHIFT = 14  # 16 kb windows


class BaiIndex:
    def __init__(self, bins_per_ref, linear_per_ref, n_no_coor: int = 0):
        # bins_per_ref: list (per ref) of {bin: [(beg, end), ...]}
        self.bins_per_ref: List[Dict[int, List[Tuple[int, int]]]] = bins_per_ref
        self.linear_per_ref: List[List[int]] = linear_per_ref
        self.n_no_coor = n_no_coor

    @staticmethod
    def load(path: Union[str, Path]) -> "BaiIndex":
        data = Path(path).read_bytes()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"{path}: not a BAI index")
        pos = 4
        (n_ref,) = struct.unpack_from("<i", data, pos)
        pos += 4
        bins_per_ref, linear_per_ref = [], []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, pos)
            pos += 4
            bins: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
                pos += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, pos)
                    pos += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, pos)
            pos += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, pos))
            pos += 8 * n_intv
            bins_per_ref.append(bins)
            linear_per_ref.append(linear)
        n_no_coor = 0
        if pos + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, pos)
        return BaiIndex(bins_per_ref, linear_per_ref, n_no_coor)

    def save(self, path: Union[str, Path]) -> None:
        out = bytearray()
        out += BAI_MAGIC
        out += struct.pack("<i", len(self.bins_per_ref))
        for bins, linear in zip(self.bins_per_ref, self.linear_per_ref):
            out += struct.pack("<i", len(bins))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for beg, end in chunks:
                    out += struct.pack("<QQ", beg, end)
            out += struct.pack("<i", len(linear))
            out += struct.pack(f"<{len(linear)}Q", *linear)
        out += struct.pack("<Q", self.n_no_coor)
        Path(path).write_bytes(bytes(out))

    # -- queries -----------------------------------------------------------
    def mapped_unmapped(self, ref_id: int) -> Tuple[int, int]:
        """Counts from the metadata pseudo-bin (htslib convention)."""
        pseudo = self.bins_per_ref[ref_id].get(PSEUDO_BIN)
        if pseudo is None or len(pseudo) < 2:
            return 0, 0
        n_mapped, n_unmapped = pseudo[1]
        return n_mapped, n_unmapped

    def chunks_for_region(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged virtual-offset chunks possibly containing reads over [beg, end)."""
        bins = self.bins_per_ref[ref_id]
        linear = self.linear_per_ref[ref_id]
        window = beg >> LINEAR_SHIFT
        min_offset = linear[window] if window < len(linear) else (linear[-1] if linear else 0)

        chunks: List[Tuple[int, int]] = []
        for bin_id in reg2bins(beg, end):
            if bin_id == PSEUDO_BIN:
                continue
            for cbeg, cend in bins.get(bin_id, ()):
                if cend > min_offset:
                    chunks.append((max(cbeg, min_offset), cend))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged


def build_bai(bam_path: Union[str, Path], bai_path: Union[str, Path, None] = None) -> BaiIndex:
    """Index a coordinate-sorted BAM, writing ``<bam>.bai``.

    Single streaming pass: records fixed fields only (no tag/seq decode), so
    indexing cost is dominated by BGZF decompression.
    """
    bgzf = BgzfReader(bam_path)
    magic = bgzf.read(4)
    assert magic == BAM_MAGIC, f"{bam_path} is not a BAM"
    (l_text,) = struct.unpack("<i", bgzf.read(4))
    bgzf.read(l_text)
    (n_ref,) = struct.unpack("<i", bgzf.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", bgzf.read(4))
        bgzf.read(l_name + 4)

    bins_per_ref: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    linear_per_ref: List[List[int]] = [[] for _ in range(n_ref)]
    counts = [[0, 0] for _ in range(n_ref)]  # mapped, unmapped per ref
    ref_span: List[List[int]] = [[0, 0] for _ in range(n_ref)]  # voffset beg/end
    ref_seen = [False] * n_ref
    n_no_coor = 0

    REF_CONSUMING = (0, 2, 3, 7, 8)

    while True:
        vbeg = bgzf.virtual_offset
        size_raw = bgzf.read(4)
        if len(size_raw) < 4:
            break
        (block_size,) = struct.unpack("<I", size_raw)
        body = bgzf.read(block_size)
        vend = bgzf.virtual_offset
        (
            ref_id, pos, _l_read_name, _mapq, _bin, n_cigar, flag, _l_seq,
            _next_ref, _next_pos, _tlen,
        ) = _FIXED.unpack_from(body, 0)
        if ref_id < 0:
            n_no_coor += 1
            continue
        if flag & 0x4:
            counts[ref_id][1] += 1
        else:
            counts[ref_id][0] += 1

        # reference span from cigar (fixed-offset read, no object construction)
        name_len = body[8]
        cigar_off = 32 + name_len
        span = 0
        for i in range(n_cigar):
            (v,) = struct.unpack_from("<I", body, cigar_off + 4 * i)
            if (v & 0xF) in REF_CONSUMING:
                span += v >> 4
        end = pos + max(span, 1)

        bin_id = reg2bin(pos, end)
        bins = bins_per_ref[ref_id]
        chunk_list = bins.setdefault(bin_id, [])
        if chunk_list and chunk_list[-1][1] == vbeg:
            chunk_list[-1] = (chunk_list[-1][0], vend)
        else:
            chunk_list.append((vbeg, vend))

        linear = linear_per_ref[ref_id]
        w_beg, w_end = pos >> LINEAR_SHIFT, (end - 1) >> LINEAR_SHIFT
        while len(linear) <= w_end:
            linear.append(0)
        for w in range(w_beg, w_end + 1):
            if linear[w] == 0 or vbeg < linear[w]:
                linear[w] = vbeg

        if not ref_seen[ref_id]:
            ref_span[ref_id][0] = vbeg
            ref_seen[ref_id] = True
        ref_span[ref_id][1] = vend

    # fill zero holes in the linear indexes with the previous non-zero offset
    for linear in linear_per_ref:
        last = 0
        for i, v in enumerate(linear):
            if v == 0:
                linear[i] = last
            else:
                last = v

    for ref_id in range(n_ref):
        if ref_seen[ref_id] or counts[ref_id][0] or counts[ref_id][1]:
            bins_per_ref[ref_id][PSEUDO_BIN] = [
                (ref_span[ref_id][0], ref_span[ref_id][1]),
                (counts[ref_id][0], counts[ref_id][1]),
            ]

    index = BaiIndex(bins_per_ref, linear_per_ref, n_no_coor)
    index.save(bai_path if bai_path is not None else str(bam_path) + ".bai")
    return index
