"""Matrix-free stencil operators.

Counterpart of rocalution_tpu/formats/stencil.py (reference: LocalStencil,
src/base/local_stencil.hpp:59+, stencil_types.hpp:36-39; Laplace2D is the
only type the reference ships). A constant-coefficient stencil on a
regular 2-D or 3-D grid, Dirichlet (zero) boundaries. The apply is plain
torch: one shifted add a stencil point on the reshaped grid, no indices.
The JAX package's apply is XLA, not Pallas, so it has no kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import numpy_dtype, resolve_device
from .base import MatrixBase, to_device


def _windows(off, grid):
    """(source, destination) slices per axis of a grid shift by `off`."""
    src, dst = [], []
    for o, nax in zip(off, grid):
        if o >= 0:
            src.append(slice(o, nax))
            dst.append(slice(0, nax - o))
        else:
            src.append(slice(0, nax + o))
            dst.append(slice(-o, nax))
    return tuple(src), tuple(dst)


@dataclasses.dataclass(frozen=True)
class Stencil(MatrixBase):
    """Constant-coefficient stencil on a regular grid: `offsets` are grid
    shifts, `weights` the matching coefficients."""

    weights: torch.Tensor                                   # (npoints,)
    offsets: Tuple[Tuple[int, ...], ...] = ()
    grid: Tuple[int, ...] = ()                              # grid extents

    @property
    def shape(self) -> Tuple[int, int]:
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def nnz(self) -> int:   # dense-equivalent entry count
        return int(np.prod(self.grid)) * len(self.offsets)

    def _host_weights(self):
        w = self.__dict__.get("_w")
        if w is None:
            w = self.__dict__["_w"] = self.weights.cpu().tolist()
        return w

    def diagonal(self) -> torch.Tensor:
        """The diagonal: the weight of the zero offset on every row."""
        w = sum(w for w, off in zip(self._host_weights(), self.offsets)
                if not any(off))
        return torch.full((self.shape[0],), float(w), dtype=self.dtype,
                          device=self.device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape (n,) or (n, k): y[dst] += w * x[src]
        per stencil point, in the offsets' order."""
        g = x.reshape(self.grid + tuple(x.shape[1:]))
        y = torch.zeros_like(g)
        for w, off in zip(self._host_weights(), self.offsets):
            src, dst = _windows(off, self.grid)
            y[dst].add_(g[src], alpha=w)
        return y.reshape(x.shape)

    def to_csr(self):
        from .csr import CSR

        idx = np.arange(int(np.prod(self.grid))).reshape(self.grid)
        rows, cols, vals = [], [], []
        w = self.weights.cpu().numpy()
        for k, off in enumerate(self.offsets):
            src, dst = _windows(off, self.grid)
            r = idx[dst].ravel()
            c = idx[src].ravel()
            rows.append(r)
            cols.append(c)
            vals.append(np.full(len(r), w[k]))
        return CSR.from_coo(
            np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), self.shape, device=self.device,
        )


def _stencil(weights, offsets, grid, dtype, device) -> Stencil:
    return Stencil(weights=to_device(np.asarray(weights, numpy_dtype(dtype)),
                                     resolve_device(device)),
                   offsets=offsets, grid=grid)


def laplace2d_stencil(n: int, dtype=np.float64, device=None) -> Stencil:
    """The reference's ndim=2 Laplace stencil (stencil_types.hpp:36-39,
    host_stencil_laplace2d.cpp) on an n x n grid."""
    return _stencil([4.0, -1.0, -1.0, -1.0, -1.0],
                    ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (n, n),
                    dtype, device)


def laplace3d_stencil(n: int, dtype=np.float64, device=None) -> Stencil:
    """The 7-point Laplace stencil on an n x n x n grid."""
    return _stencil([6.0] + [-1.0] * 6,
                    ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0),
                     (0, 1, 0), (0, 0, -1), (0, 0, 1)), (n, n, n),
                    dtype, device)
