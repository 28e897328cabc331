"""The yardstick of the roofline metrics: published peaks and the bytes a
product needs whatever implements it (the operator's values, x and y
once). The plan's own bytes (padding, offsets) are not counted, so the
bound stays the same across layouts; a change that stored fewer values
than nnz (a constant-coefficient form, say) needs this recounted."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def hbm_bytes_per_s(kind: str):
    """Published HBM rate of the card `kind`, or None for another card."""
    entry = json.loads(PEAKS.read_text()).get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def spmv_bytes(n_rows: int, n_cols: int, nnz: int, value_bytes: int = 8,
               columns: int = 1) -> int:
    """Values once, x (n_cols x columns) and y (n_rows x columns) once."""
    return value_bytes * (nnz + (n_rows + n_cols) * columns)


def share_percent(bound_s: float, measured_s: float):
    """100 * bound / measured, or None where nothing was measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
