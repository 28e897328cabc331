"""The numbers that decide `correct`, each worked out in float64."""

from __future__ import annotations

import torch

from . import csr


def rel_residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                 x0: torch.Tensor) -> float:
    """|b - A x|_2 / |b - A x0|_2, the base of CG's stopping rule; an x of
    another shape reads inf."""
    if tuple(x.shape) != tuple(b.shape):
        return float("inf")
    x = x.to(torch.float64)
    b = b.to(torch.float64)
    r0 = b - csr.apply(A, x0.to(torch.float64))
    return float(torch.linalg.vector_norm(b - csr.apply(A, x))
                 / torch.linalg.vector_norm(r0))


def rel_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    """|x - ref|_2 / |ref|_2; an x of another shape reads inf."""
    if tuple(x.shape) != tuple(ref.shape):
        return float("inf")
    x = x.to(torch.float64)
    ref = ref.to(torch.float64)
    return float(torch.linalg.vector_norm(x - ref)
                 / torch.linalg.vector_norm(ref))


def column_gap(Y: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst column's |Y - ref|_2 / |ref|_2; a Y of another shape
    reads inf."""
    if tuple(Y.shape) != tuple(ref.shape):
        return float("inf")
    Y = Y.to(torch.float64)
    ref = ref.to(torch.float64)
    num = torch.linalg.vector_norm(Y - ref, dim=0)
    den = torch.linalg.vector_norm(ref, dim=0)
    return float(torch.max(num / den))


def worst(values) -> float:
    """The largest of the readings; NaN reads inf, no reading 0."""
    out = 0.0
    for v in values:
        v = float(v)
        out = max(out, v if v == v else float("inf"))
    return out
