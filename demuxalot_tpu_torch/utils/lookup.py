"""Dense re-indexing of integer feature tuples (a copy of ``demuxalot_tpu.utils.lookup``).

``FeatureLookup`` assigns contiguous ids 0..K-1 to the distinct tuples
observed across several aligned integer feature arrays — e.g. giving every
seen (barcode, snp) pair one dense id for host-side aggregation. Device
code uses sorted segment ids instead; this host utility mirrors the
reference's lookup surface (demuxalot/utils.py:207-262) on top of numpy's
``ravel_multi_index`` machinery rather than hand-rolled mixed-radix codes.
"""
from __future__ import annotations

import numpy as np


class FeatureLookup:
    """Bidirectional map between feature tuples and dense ids.

    The constructor scans the given feature arrays (all the same length,
    non-negative ints) and records the sorted set of distinct tuples;
    ``compress`` later maps any arrays drawn from the same tuple set to
    dense ids, and ``uncompress`` inverts that.
    """

    def __init__(self, *features: np.ndarray):
        if not features:
            raise ValueError("at least one feature array is required")
        self._shape = tuple(int(np.max(f)) + 1 for f in features)
        if np.prod(self._shape, dtype=np.float64) >= 2**63:
            raise RuntimeError(f"feature space {self._shape} overflows int64 keys")
        self._seen_keys = np.unique(self._flatten(features))

    @property
    def nvalues(self) -> int:
        """Number of distinct tuples observed at construction."""
        return len(self._seen_keys)

    def _flatten(self, features) -> np.ndarray:
        arrays = tuple(np.asarray(f) for f in features)
        return np.ravel_multi_index(arrays, self._shape)

    def _unflatten(self, keys: np.ndarray) -> list:
        return [np.asarray(axis) for axis in np.unravel_index(keys, self._shape)]

    def compress(self, *features):
        """Map feature arrays to dense ids; also return per-id occurrence counts.

        Raises if any tuple was not part of the construction set (dense ids
        are only meaningful for observed tuples).
        """
        keys = self._flatten(features)
        dense = np.searchsorted(self._seen_keys, keys)
        dense = np.minimum(dense, self.nvalues - 1)
        if not np.array_equal(self._seen_keys[dense], keys):
            raise KeyError("compress() called with tuples unseen at construction")
        return dense, np.bincount(dense, minlength=self.nvalues)

    def uncompress(self, dense_ids: np.ndarray) -> list:
        """Dense ids -> list of per-feature arrays (inverse of compress)."""
        return self._unflatten(self._seen_keys[dense_ids])

    def lookup_for_individual_features(self) -> list:
        """Per-feature values of every distinct tuple, in dense-id order."""
        return self._unflatten(self._seen_keys)
