"""Common machinery for matrix formats.

Counterpart of rocalution_tpu/formats/base.py. A format is a frozen
dataclass holding tensors plus free functions that operate on it. Formats
built on the host keep numpy copies of their arrays (the host cache), so
setup code (plans, preconditioners) never reads device memory back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class MatrixBase:
    """Mixin providing the common query surface (GetM/GetN/GetNnz analogs)."""

    shape: Tuple[int, int]

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype  # type: ignore[attr-defined]

    @property
    def device(self) -> torch.device:
        return self.data.device  # type: ignore[attr-defined]

    def __matmul__(self, x):
        from ..ops.spmv import spmv

        return spmv(self, x)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """numpy array -> tensor on ``device`` (one copy)."""
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    if not a.flags.writeable:          # torch.from_numpy needs writable
        a = a.copy()
    return torch.from_numpy(a).to(device)


def expand(vals, x_gathered):
    """vals * x_gathered with 1-D nonzero values broadcast over the
    trailing right-hand-side dimension of a gathered (…, k) x."""
    if x_gathered.dim() == vals.dim():
        return vals * x_gathered
    return vals[(...,) + (None,) * (x_gathered.dim() - vals.dim())] \
        * x_gathered


def set_host_cache(obj, **arrays) -> None:
    object.__setattr__(obj, "_host_cache", dict(arrays))


def get_host(obj, name: str) -> np.ndarray:
    """Host numpy version of field `name`; falls back to a device read."""
    cache = getattr(obj, "_host_cache", None)
    if cache is not None and name in cache:
        return cache[name]
    return getattr(obj, name).cpu().numpy()
