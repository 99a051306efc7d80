"""BAM ingest: SNP counting into the columnar call tables the packing reads."""
from .snp_counter import (
    MOLECULE_DTYPE,
    SNP_CALL_DTYPE,
    ChromosomeSNPLookup,
    CompressedSNPCalls,
    consensus_call_molecule,
    count_call_variants_for_chromosome,
    count_snps,
    load_snp_counts,
    prepare_counting_tasks,
    save_snp_counts,
)

__all__ = [
    "MOLECULE_DTYPE",
    "SNP_CALL_DTYPE",
    "ChromosomeSNPLookup",
    "CompressedSNPCalls",
    "consensus_call_molecule",
    "count_call_variants_for_chromosome",
    "count_snps",
    "load_snp_counts",
    "prepare_counting_tasks",
    "save_snp_counts",
]
