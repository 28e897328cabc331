"""Level-1 vector operations.

Counterpart of rocalution_tpu/ops/blas1.py (reference: the LocalVector op
surface, src/base/local_vector.hpp), with the same formulas. Reductions
return 0-d tensors on the operands' device: no host read. Complex-aware
like the reference.

The random fills draw on the host from ``torch.Generator().manual_seed(
seed)`` in f64 and then cast and move, so the CPU and the card get one
draw (the JAX package draws with jax.random's threefry, which torch
cannot reproduce).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, torch_dtype


def dot(x, y):
    """Conjugated dot <x,y> (reference: LocalVector::Dot)."""
    return torch.vdot(x, y)


def dot_nonconj(x, y):
    """Non-conjugated dot (reference: LocalVector::DotNonConj)."""
    return torch.sum(x * y)


def norm(x):
    """Euclidean norm (reference: LocalVector::Norm)."""
    return torch.sqrt(torch.real(torch.vdot(x, x)))


def asum(x):
    """Sum of absolute values (reference: LocalVector::Asum)."""
    return torch.sum(torch.abs(x))


def amax(x):
    """Index and value of the max-|x| entry (reference: LocalVector::Amax)."""
    idx = torch.argmax(torch.abs(x))
    return idx, x[idx]


def amax_value(x):
    """Largest absolute value (the L-infinity norm)."""
    return torch.max(torch.abs(x))


def reduce_sum(x):
    """Sum reduction (reference: LocalVector::Reduce)."""
    return torch.sum(x)


def scale(x, alpha):
    return alpha * x


def add_scale(x, y, alpha):
    """x + alpha*y (reference: LocalVector::AddScale — axpy)."""
    return x + alpha * y


def scale_add(x, y, alpha):
    """alpha*x + y (reference: LocalVector::ScaleAdd)."""
    return alpha * x + y


def scale_add_scale(x, y, alpha, beta):
    """alpha*x + beta*y (reference: LocalVector::ScaleAddScale)."""
    return alpha * x + beta * y


def scale_add2(x, y, z, alpha, beta, gamma):
    """alpha*x + beta*y + gamma*z (reference: LocalVector::ScaleAdd2)."""
    return alpha * x + beta * y + gamma * z


def pointwise_mult(x, y, z=None):
    """x .* y (or y .* z) (reference: LocalVector::PointWiseMult)."""
    if z is None:
        return x * y
    return y * z


def power(x, p):
    """Elementwise power (reference: LocalVector::Power)."""
    return torch.pow(x, p)


def inclusive_sum(x):
    """Inclusive prefix sum (reference: LocalVector::InclusiveSum)."""
    return torch.cumsum(x, dim=0)


def exclusive_sum(x):
    """Exclusive prefix sum (reference: LocalVector::ExclusiveSum)."""
    return torch.cumsum(x, dim=0) - x


def permute(x, perm):
    """out[perm[i]] = x[i] (reference: LocalVector::Permute semantics)."""
    out = torch.zeros_like(x)
    out[perm.long()] = x
    return out


def permute_backward(x, perm):
    """out[i] = x[perm[i]] (reference: LocalVector::PermuteBackward)."""
    return x[perm.long()]


def get_index_values(x, idx):
    """Gather (reference: LocalVector::GetIndexValues — halo gather)."""
    return x[idx.long()]


def set_index_values(x, idx, values):
    """Scatter into a copy of x (reference: LocalVector::SetIndexValues)."""
    out = x.clone()
    out[idx.long()] = values
    return out


def add_index_values(x, idx, values):
    """Scatter-add into a copy of x; repeated indices accumulate."""
    return x.clone().index_put_((idx.long(),), torch.as_tensor(
        values, dtype=x.dtype, device=x.device), accumulate=True)


def sigma_norm(x, sigma):
    return torch.sqrt(torch.real(torch.vdot(x, x)) + sigma)


def restriction(x_fine, fmap, n_coarse: int):
    """Map-based restriction: coarse[fmap[i]] += fine[i] for fmap[i] != -1
    (reference: LocalVector::Restriction, host_vector.cpp:1415-1439): one
    segment sum with the -1 entries routed to a dropped slot."""
    fmap = fmap.long()
    safe = torch.where(fmap < 0, n_coarse, fmap)
    vals = torch.where(fmap < 0, torch.zeros_like(x_fine), x_fine)
    out = x_fine.new_zeros(n_coarse + 1)
    return out.index_add_(0, safe, vals)[:n_coarse]


def prolongation(x_coarse, fmap):
    """Map-based prolongation: fine[i] = coarse[fmap[i]], 0 where the map
    is -1 (reference: LocalVector::Prolongation, host_vector.cpp:1441+)."""
    fmap = fmap.long()
    vals = x_coarse[torch.clamp(fmap, min=0)]
    return torch.where(fmap < 0, torch.zeros_like(vals), vals)


def _host_draw(seed: int, n: int, normal: bool) -> torch.Tensor:
    gen = torch.Generator().manual_seed(int(seed))
    if normal:
        return torch.randn(n, generator=gen, dtype=torch.float64)
    return torch.rand(n, generator=gen, dtype=torch.float64)


def set_random_uniform(seed: int, n: int, low=-1.0, high=1.0, dtype=None,
                       device=None):
    """Uniform random fill in [low, high) (reference:
    LocalVector::SetRandomUniform), from `seed` (module docstring)."""
    u = low + (high - low) * _host_draw(seed, n, normal=False)
    return u.to(torch_dtype(dtype or torch.float64)).to(
        resolve_device(device))


def set_random_normal(seed: int, n: int, mean=0.0, std=1.0, dtype=None,
                      device=None):
    """Normal random fill (reference: LocalVector::SetRandomNormal), from
    `seed` (module docstring)."""
    g = mean + std * _host_draw(seed, n, normal=True)
    return g.to(torch_dtype(dtype or torch.float64)).to(
        resolve_device(device))


def extract_coarse_mapping(vec, index, nc: int):
    """Renumber the coarse ids hit by boundary points into a dense local
    numbering, first-seen order (reference: LocalVector<int>::
    ExtractCoarseMapping, host_vector.cpp:1594-1632; distributed AMG
    setup). Host-side numpy. Returns (map, size)."""
    vec = np.asarray(vec)
    index = np.asarray(index, np.int64)
    coarse = vec[index]
    uniq, first_idx, inv = np.unique(coarse, return_index=True,
                                     return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(uniq))
    return rank[inv.reshape(-1)], len(uniq)


def extract_coarse_boundary(vec, index, nc: int):
    """Unique coarse ids hit by boundary points, first-seen order
    (reference: LocalVector<int>::ExtractCoarseBoundary,
    host_vector.cpp:1643+). Host-side numpy."""
    vec = np.asarray(vec)
    index = np.asarray(index, np.int64)
    coarse = vec[index]
    _, first_idx = np.unique(coarse, return_index=True)
    return coarse[np.sort(first_idx)]
