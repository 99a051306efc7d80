"""Filename helpers (``as_str`` of ``demuxalot_tpu.utils.files``)."""
from __future__ import annotations

from pathlib import Path


def as_str(filename) -> str:
    """Normalize a str-or-Path filename to str (reject anything else)."""
    if not isinstance(filename, (str, Path)):
        raise TypeError(f"expected a filename (str or Path), got {type(filename)}")
    return str(filename)
