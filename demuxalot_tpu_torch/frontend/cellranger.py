"""Read-filtering plugin for cellranger-aligned BAMs.

A ``parse_read`` plugin decides, per aligned read, whether the read is
usable evidence, returning ``None`` to drop it or
``(p_misaligned, umi_code)`` to keep it. ``count_snps`` accepts any such
callable — pass a ``functools.partial`` of this one to retune tags or
thresholds (see examples/3), or a custom function for other aligners.

The acceptance predicate is behavioral parity with the reference plugin
(demuxalot/cellranger_specific.py:13-36); this module additionally exposes
the decision as a labeled verdict (``classify_read``) so callers can
histogram WHY reads were dropped, and surfaces thresholds as keyword
parameters rather than hard-coded constants.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..utils.encoding import hash_string

#: verdict labels returned by :func:`classify_read`
USABLE = "usable"
SCORE_BELOW_FLOOR = "score_below_floor"
MULTIMAPPED = "multimapped"
MISSING_UMI = "missing_umi"
LOW_MAPQ = "low_mapq"

#: every verdict a cellranger read can receive, in evaluation order
VERDICTS = (SCORE_BELOW_FLOOR, MULTIMAPPED, MISSING_UMI, LOW_MAPQ, USABLE)


def classify_read(
    read,
    umi_tag: str = "UB",
    nhits_tag: str = "NH",
    score_tag: str = "AS",
    score_diff_max: int = 8,
    mapq_threshold: int = 20,
) -> str:
    """Label one read with the first disqualifying condition (or USABLE).

    Checks, in order:

    * ``SCORE_BELOW_FLOOR`` — cellranger's alignment score (``AS``) tops
      out at the read length, so requiring it to exceed
      ``len(seq) - score_diff_max`` bounds the number of edits (≤2 at the
      default 8);
    * ``MULTIMAPPED`` — the aligner reported more than one placement
      (``NH`` tag);
    * ``MISSING_UMI`` — no corrected molecule barcode under ``umi_tag``;
    * ``LOW_MAPQ`` — mapping quality under ``mapq_threshold``; with unique
      placement this is near-redundant, kept as a belt-and-braces guard.

    Cell-barcode whitelisting is not this plugin's job — it happens later,
    in the counting loop.
    """
    score_floor = len(read.seq) - score_diff_max
    if read.get_tag(score_tag) <= score_floor:
        return SCORE_BELOW_FLOOR
    if read.get_tag(nhits_tag) > 1:
        return MULTIMAPPED
    if not read.has_tag(umi_tag):
        return MISSING_UMI
    if read.mapq < mapq_threshold:
        return LOW_MAPQ
    return USABLE


def parse_read(
    read,
    umi_tag: str = "UB",
    nhits_tag: str = "NH",
    score_tag: str = "AS",
    score_diff_max: int = 8,
    mapq_threshold: int = 20,
    p_misaligned_default: float = 0.01,
) -> Optional[Tuple[float, int]]:
    """Accept/reject one read; on accept return (p_misaligned, umi_code)."""
    verdict = classify_read(
        read,
        umi_tag=umi_tag,
        nhits_tag=nhits_tag,
        score_tag=score_tag,
        score_diff_max=score_diff_max,
        mapq_threshold=mapq_threshold,
    )
    if verdict is not USABLE:
        return None
    return p_misaligned_default, hash_string(read.get_tag(umi_tag))
