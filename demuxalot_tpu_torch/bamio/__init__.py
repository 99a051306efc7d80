"""Self-contained genomics I/O: BGZF, BAM (+BAI index), SAM, VCF.

The file formats of ``demuxalot_tpu.bamio``, in pure Python; the C++
scanner (``demuxalot_tpu_torch.native``) reads BAM on the counting path.
"""
from .bai import BaiIndex, build_bai
from .bam import (
    AlignedRead,
    BamHeader,
    BamReader,
    BamWriter,
    encode_record,
    index_bam,
    parse_record,
    qualitystring_to_array,
    sort_bam,
)
from .bgzf import BgzfReader, BgzfWriter
from .sam import SamReader, open_alignment, sniff_format, write_sam
from .vcf import VariantFile, VariantRecord, read_vcf_to_header_and_pandas

# pysam-flavoured alias; format-polymorphic like pysam.AlignmentFile
# (BAM via BamReader, SAM via SamReader, CRAM -> curated error)
AlignmentFile = open_alignment

__all__ = [
    "AlignedRead",
    "AlignmentFile",
    "BaiIndex",
    "BamHeader",
    "BamReader",
    "BamWriter",
    "BgzfReader",
    "BgzfWriter",
    "SamReader",
    "VariantFile",
    "VariantRecord",
    "build_bai",
    "encode_record",
    "index_bam",
    "open_alignment",
    "parse_record",
    "qualitystring_to_array",
    "read_vcf_to_header_and_pandas",
    "sniff_format",
    "sort_bam",
    "write_sam",
]
