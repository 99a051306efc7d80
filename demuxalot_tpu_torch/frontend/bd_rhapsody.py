"""Read-filtering callback tuned for BD Rhapsody WTA (RNA) assays.

Same rules as the cellranger plugin but with the Rhapsody UMI tag ('MA');
reference: demuxalot/BDRhapsody_specific.py:13-36.
"""
from __future__ import annotations

from typing import Optional, Tuple

from .cellranger import parse_read as _parse_read


def parse_read(
    read,
    umi_tag: str = "MA",
    nhits_tag: str = "NH",
    score_tag: str = "AS",
    score_diff_max: int = 8,
    mapq_threshold: int = 20,
    p_misaligned_default: float = 0.01,
) -> Optional[Tuple[float, int]]:
    return _parse_read(
        read,
        umi_tag=umi_tag,
        nhits_tag=nhits_tag,
        score_tag=score_tag,
        score_diff_max=score_diff_max,
        mapq_threshold=mapq_threshold,
        p_misaligned_default=p_misaligned_default,
    )
