"""Reporting helpers: counting summaries and assignment quality metrics.

A copy of ``demuxalot_tpu.utils.summary`` with pandas (and matplotlib, for
the optional plot) imported inside the functions. Host-side diagnostics
covering the reference's surface (demuxalot/utils.py:163-204, 265-296)
with vectorized implementations.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def summarize_counted_SNPs(snp_counts: Dict[str, "CompressedSNPCalls"], show_plot: bool = True):
    """Tabulate a ``count_snps`` result per chromosome; optionally plot.

    Returns a dataframe (index = chromosome, columns ``n_molecules`` /
    ``n_snp_calls``). With ``show_plot`` the per-droplet distributions of
    SNP calls and distinct transcripts are drawn as step histograms.
    """
    import pandas as pd

    rows = {}
    calls_per_slot: np.ndarray = np.zeros(0, dtype=np.int64)
    transcripts_per_slot: np.ndarray = np.zeros(0, dtype=np.int64)

    def grow_to(n: int):
        nonlocal calls_per_slot, transcripts_per_slot
        if n > len(calls_per_slot):
            calls_per_slot = np.concatenate([calls_per_slot, np.zeros(n - len(calls_per_slot), np.int64)])
            transcripts_per_slot = np.concatenate(
                [transcripts_per_slot, np.zeros(n - len(transcripts_per_slot), np.int64)]
            )

    for chromosome, calls in snp_counts.items():
        rows[chromosome] = dict(n_molecules=calls.n_molecules, n_snp_calls=calls.n_snp_calls)
        molecule_slots = np.asarray(calls.molecules["compressed_cb"], dtype=np.int64)
        call_slots = molecule_slots[np.asarray(calls.snp_calls["molecule_index"], dtype=np.int64)]
        grow_to(int(max(molecule_slots.max(initial=-1), call_slots.max(initial=-1))) + 1)
        transcripts_per_slot += np.bincount(molecule_slots, minlength=len(transcripts_per_slot)).astype(np.int64)
        calls_per_slot += np.bincount(call_slots, minlength=len(calls_per_slot)).astype(np.int64)

    if show_plot:
        from matplotlib import pyplot as plt

        def clipped(values: np.ndarray, q: float = 99.5) -> np.ndarray:
            return np.minimum(values, np.percentile(values, q)) if len(values) else values

        _fig, axes = plt.subplots(ncols=2, figsize=[12, 5])
        for axis, values, label in zip(
            axes,
            # each panel shows only droplets that appear in its own metric
            [calls_per_slot[calls_per_slot > 0], transcripts_per_slot[transcripts_per_slot > 0]],
            ["SNP calls per droplet", "transcripts per droplet"],
        ):
            axis.hist(clipped(values), bins=20, histtype="step")
            axis.set_xlabel(label)
            axis.set_ylabel("barcodes")
        plt.show()

    summary = pd.DataFrame.from_dict(rows, orient="index").sort_index()
    summary.index.name = "chromosome"
    return summary


def compute_qualities(probs, barcode2possible_donors: dict):
    """Accuracy and logloss of posteriors against known admissible donors.

    ``probs``: a pandas frame of barcodes × (singlet + doublet) assignment
    probabilities. ``barcode2possible_donors``: each barcode's list of
    acceptable column names. A barcode counts as correct when its argmax
    column is acceptable; its logloss is -log of the total acceptable mass.
    """
    missing = [bc for bc in probs.index if bc not in barcode2possible_donors]
    assert not missing, f"no admissible donors specified for barcodes: {missing[:5]}"
    assert np.allclose(probs.sum(axis=1), 1, atol=1e-2), "rows of probs must be distributions"

    column_slot = {name: j for j, name in enumerate(probs.columns)}
    admissible = np.zeros(probs.shape, dtype=bool)
    for i, barcode in enumerate(probs.index):
        donors: List[str] = barcode2possible_donors[barcode]
        unknown = [d for d in donors if d not in column_slot]
        assert not unknown, f"admissible donors absent from probs columns: {unknown}"
        admissible[i, [column_slot[d] for d in donors]] = True

    matrix = probs.to_numpy()
    admissible_mass = (matrix * admissible).sum(axis=1)
    hit = admissible[np.arange(len(matrix)), matrix.argmax(axis=1)]
    accuracy = float(hit.mean())
    return {
        "logloss": float(-np.log(admissible_mass.clip(min=1e-4)).mean()),
        "accuracy": accuracy,
        "error rate": 1 - accuracy,
    }


# the reference exposes this metric helper under a private name; keep an alias
_compute_qualities = compute_qualities
