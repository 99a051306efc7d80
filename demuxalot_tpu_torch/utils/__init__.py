from .barcodes import BarcodeHandler
from .encoding import (
    base_lookup,
    compress_base,
    compress_bases_vectorized,
    decompress_base,
    fast_np_add_at_1d,
    hash_string,
)
from .files import as_str
from .lookup import FeatureLookup
from .profiling import (AggregateRoofline, GatherRoofline, MStepRoofline, Roofline, StreamRoofline, VariantRoofline,
                        device_trace)
from .summary import _compute_qualities, compute_qualities, summarize_counted_SNPs
from .timing import Timer


def read_vcf_to_header_and_pandas(vcf_filename):
    """Parity re-export; implementation lives in demuxalot_tpu_torch.bamio.vcf."""
    from ..bamio.vcf import read_vcf_to_header_and_pandas as _impl

    return _impl(vcf_filename)


__all__ = [
    "BarcodeHandler",
    "FeatureLookup",
    "GatherRoofline",
    "MStepRoofline",
    "Roofline",
    "StreamRoofline",
    "VariantRoofline",
    "AggregateRoofline",
    "Timer",
    "as_str",
    "base_lookup",
    "compress_base",
    "compress_bases_vectorized",
    "compute_qualities",
    "decompress_base",
    "device_trace",
    "fast_np_add_at_1d",
    "hash_string",
    "read_vcf_to_header_and_pandas",
    "summarize_counted_SNPs",
]
