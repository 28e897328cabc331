"""Multigrid cycle machinery.

Counterpart of rocalution_tpu/solvers/multigrid/base.py (reference:
BaseMultiGrid, src/solvers/multigrid/base_multigrid.{hpp,cpp} — V/W/F/K
cycles, Vcycle_ base_multigrid.cpp:720-916: pre-smooth, restrict, recurse,
prolong + correct, post-smooth; MultiGrid, multigrid.{hpp,cpp}, with a
user-supplied hierarchy).

Where a hierarchy lives: the fine operator is the caller's and stays where
it is. The levels and transfers that setup makes (aggregation, Galerkin
products, casts) are host-resident CSRs, as the JAX package keeps them
host-side. `cycle_closure` places every one of them on the fine operator's
device before anything else (an operator's device copy is uploaded once
from its host arrays and kept on it, so later closures reuse it and its
WJD plan), rebuilds their smoothers there, attaches the WJD fast applies,
and factors the coarse level there. The cycle is then a Python recursion
of SpMV, BLAS-1 and one small dense solve, each on that device; on the
card every level operator and transfer that is a CSR is served by the WJD
kernels (ops/cuda/spmv_wjd.py). As a standalone solver the cycle is the
preconditioner of a FixedPoint iteration (`mg_solve`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ...formats import CSR, to_csr
from ...formats.base import get_host, set_host_cache, to_device
from ...ops.spmv import maybe_attach_wjd, spmv
from ...precond.jacobi import extract_diagonal, inverse_diagonal_host
from ..direct import qr_factor
from ..fixed_point import fixed_point
from ..iter_ctrl import IterationControl


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One grid level: operator + transfer ops + smoother closure."""

    A: object                       # operator (format)
    P: Optional[object]             # prolongation (None on coarsest)
    R: Optional[object]             # restriction (None on coarsest)
    smooth: Optional[Callable]      # (b, x, sweeps) -> x


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: List[MGLevel]
    coarse_solve: Callable          # (b,) -> x on the coarsest level
    pre_sweeps: int = 1
    post_sweeps: int = 2
    cycle: str = "V"                # V | W | F | K
    # energy-minimizing correction scaling (reference: SetScaling,
    # base_multigrid.cpp:766-789/891-897): scale the pre-smoothed iterate
    # and the prolonged correction by <w,t>/<t,At>.
    scaling: bool = False
    # number of COARSEST levels computed on the host with numpy/scipy
    # (reference: SetHostLevels, base_multigrid.cpp:802-813)
    host_levels: int = 0
    # smoother factory A -> closure (None = damped Jacobi); a cycle
    # closure calls it again for the levels it places on the device
    smoother: Optional[Callable] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def operator_sizes(self):
        return [lv.A.shape[0] for lv in self.levels]

    def with_options(self, **kw) -> "Hierarchy":
        """Return a copy with cycle options changed (cycle/scaling/
        host_levels/pre_sweeps/post_sweeps) — the analog of the reference's
        SetCycle/SetScaling/SetHostLevels setters."""
        return dataclasses.replace(self, **kw)


def jacobi_smoother(A, omega: float = 2.0 / 3.0) -> Callable:
    """Default smoother: damped-Jacobi FixedPoint sweeps (reference:
    BaseAMG::BuildSmoothers default FixedPoint+Jacobi, base_amg.cpp). Its
    vector omega/diag(A) lies on A's device (``smooth.inv_d``)."""
    host = inverse_diagonal_host(A)
    if host is not None:          # setup reads no device memory
        inv_d = to_device(omega * host, A.device)
    else:
        d = extract_diagonal(A)
        inv_d = torch.where(d != 0, omega / torch.where(d == 0, 1.0, d),
                            omega)

    def smooth(b, x, sweeps):
        for _ in range(sweeps):
            x = x + inv_d * (b - spmv(A, x))
        return x

    smooth.inv_d = inv_d
    return smooth


def precond_smoother(A, M: Callable, omega: float = 1.0) -> Callable:
    """Smoother from any preconditioner closure (reference: manual smoothers
    via SetSmoother — e.g. multicolored GS)."""

    def smooth(b, x, sweeps):
        for _ in range(sweeps):
            x = x + omega * M(b - spmv(A, x))
        return x

    return smooth


def build_hierarchy(
    ops: Sequence,
    prolongs: Sequence,
    restricts: Optional[Sequence] = None,
    *,
    smoother: Optional[Callable] = None,
    coarse_solve: Optional[Callable] = None,
    pre_sweeps: int = 1,
    post_sweeps: int = 2,
    cycle: str = "V",
) -> Hierarchy:
    """Assemble a Hierarchy from operator + transfer lists (the geometric-MG
    entry point; AMG builders call this too). `smoother(A) -> closure`
    defaults to damped Jacobi; `coarse_solve` defaults to dense QR."""
    if restricts is None:
        restricts = [P.transpose_host() for P in prolongs]
    mk_smooth = smoother or jacobi_smoother
    levels = []
    for i, A in enumerate(ops):
        last = i == len(ops) - 1
        levels.append(MGLevel(
            A=A,
            P=None if last else prolongs[i],
            R=None if last else restricts[i],
            smooth=None if last else mk_smooth(A),
        ))
    if coarse_solve is None:
        coarse_solve = _DeferredCoarse(ops[-1])
    return Hierarchy(levels, coarse_solve, pre_sweeps, post_sweeps, cycle,
                     smoother=smoother)


class _DeferredCoarse:
    """Coarse-solve closure whose factorization runs on FIRST USE, not at
    hierarchy assembly: an f64 setup hierarchy that is converted to f32
    right away would otherwise factor a coarse level nothing calls.
    `cycle_closure` resolves it when the closure is built, on the device
    the closure runs on, never inside a solver loop."""

    def __init__(self, A):
        self._A = A
        self._fn = None

    def resolve(self) -> Callable:
        if self._fn is None:
            self._fn = default_coarse_solve(self._A)
        return self._fn

    def __call__(self, b):
        return self.resolve()(b)


# dense coarse factorization above this size would allocate O(n^2)
_DENSE_COARSE_MAX = 8192


def default_coarse_solve(A) -> Callable:
    """Coarsest-level solve: dense QR when small (reference default
    LU/redundant, base_amg.cpp), else a fixed-budget Jacobi-CG closure —
    never a dense factorization of a large operator."""
    if A.shape[0] <= _DENSE_COARSE_MAX:
        return qr_factor(A)
    from ...precond.jacobi import inverse_diagonal
    from ...utils.log import log_info
    from ..krylov.cg import cg

    log_info(
        f"AMG coarse level has {A.shape[0]} rows (> {_DENSE_COARSE_MAX}); "
        "using an iterative (CG+Jacobi) coarse solve instead of dense QR"
    )
    inv_d = inverse_diagonal(A)
    # tolerance scaled to the operator dtype: 1e-10 is unreachable in f32.
    # A truncated inner Krylov makes the cycle a VARIABLE preconditioner:
    # pair it with a flexible outer solver when this path triggers.
    rel_tol = 1e-10 if A.dtype == torch.float64 else 1e-6

    def solve(b):
        x, _ = cg(A, b, M=lambda r: inv_d * r, rel_tol=rel_tol,
                  max_iter=200)
        return x

    return solve


def _with_values(pattern: CSR, data) -> CSR:
    """The CSR of `pattern` with values `data`, on data's device (no host
    cache: the values were computed there)."""
    return dataclasses.replace(_on_device(pattern, data.device), data=data)


def rebuild_hierarchy_numeric(h: Hierarchy, A_new, *,
                              plans=None) -> Hierarchy:
    """ReBuildNumeric analog (reference: Solver::ReBuildNumeric — refresh
    the hierarchy for NEW VALUES on the same nonzero structure): transfers
    P/R are kept frozen and every level operator is recomputed as the
    Galerkin product R·A·P, smoothers and the coarse solve rebuilt against
    the refreshed operators. No strength graphs, no aggregation.

    `plans` (from `make_galerkin_plans(h)`): frozen symbolic patterns per
    level — the numeric Galerkin then runs on the device of A_new's values
    (ops/spgemm.triple_product_plan). Such levels carry no host cache: on
    the card a cycle closure reads each one's triplet back once to plan
    its WJD apply (ops/spmv.maybe_attach_wjd)."""
    from ...ops.spgemm import triple_product

    levels = []
    A = to_csr(A_new)
    for li, lv in enumerate(h.levels):
        if lv.P is None:
            levels.append(MGLevel(A=A, P=None, R=None, smooth=None))
            break
        levels.append(MGLevel(A=A, P=lv.P, R=lv.R,
                              smooth=jacobi_smoother(A)))
        if plans is not None:
            pat, update = plans[li]
            A = _with_values(pat, update(A.data))
        else:
            A = triple_product(to_csr(lv.R), A, to_csr(lv.P))
    return Hierarchy(levels, _DeferredCoarse(levels[-1].A), h.pre_sweeps,
                     h.post_sweeps, h.cycle, h.scaling, h.host_levels)


def make_galerkin_plans(h: Hierarchy):
    """One frozen-symbolic Galerkin plan per non-coarsest level (see
    `rebuild_hierarchy_numeric`): the host symbolic pass runs once here;
    every later numeric rebuild runs on the device."""
    from ...ops.spgemm import triple_product_plan

    plans = []
    for lv in h.levels:
        if lv.P is None:
            break
        plans.append(triple_product_plan(to_csr(lv.R), to_csr(lv.A),
                                         to_csr(lv.P)))
    return plans


def convert_hierarchy(h: Hierarchy, fmt: str = "auto",
                      max_diags: int = 96, dtype=None) -> Hierarchy:
    """Convert level operators to a faster device format (reference:
    SetOperatorFormat/DefaultSmootherOperatorFormat on BaseAMG). "auto"
    picks DIA when the level's band has few distinct offsets, else keeps
    CSR, except where the WJD kernels will serve the levels (auto-attach
    on for the fine operator: on the card by default). There "auto" keeps
    every CSR, a deliberate difference from the JAX package: a DIA level is
    a few plain torch ops per diagonal on the H100, where the kernel
    serves the same CSR in one launch (ROADMAP.md section 3, fault 6).
    `dtype` additionally casts every level's values, from their host
    arrays. Each operator stays where it is: the fine one on its device,
    the setup levels on the host, so no value is uploaded only to be
    replaced. Smoothers and the coarse solver are rebuilt against the
    converted operators."""
    from ...formats import DIA, cast_values, convert
    from ...formats.wjd import X_VMEM_BUDGET
    from ...ops.spmv import auto_wjd_applies

    if fmt == "auto" and auto_wjd_applies(h.levels[0].A):
        fmt = "CSR"

    def cast(M):
        if dtype is None or M is None:
            return M
        return cast_values(M, dtype)

    new_levels = []
    for lv in h.levels:
        # cast FIRST so a format conversion only ever materializes the
        # final dtype
        A = cast(lv.A)
        if fmt in ("auto", "DIA") and not isinstance(A, DIA) and hasattr(
                A, "numpy_triplet"):
            # beyond-budget operators stay CSR (the JAX package's rule: its
            # windowed WJD apply beats DIA there); kept for parity
            big = A.shape[1] * 4 > X_VMEM_BUDGET
            idx = get_host(A, "indices").astype(np.int64)
            rows = get_host(A, "row_ids").astype(np.int64)
            ndiag = len(np.unique(idx - rows))
            if fmt == "DIA" or (ndiag <= max_diags and not big):
                A = convert(A, "DIA")
        new_levels.append(MGLevel(
            A=A, P=cast(lv.P), R=cast(lv.R),
            smooth=None if lv.smooth is None else jacobi_smoother(A),
        ))
    coarse = h.coarse_solve
    if dtype is not None:
        coarse = _DeferredCoarse(new_levels[-1].A)
    return Hierarchy(new_levels, coarse, h.pre_sweeps,
                     h.post_sweeps, h.cycle, h.scaling, h.host_levels)


def _upload(M, device):
    """A copy of matrix M on `device`: from its host arrays where it has
    them (one upload each), else tensor by tensor."""
    if isinstance(M, CSR) and getattr(M, "_host_cache", None):
        return CSR.from_arrays(get_host(M, "data"), get_host(M, "indices"),
                               get_host(M, "indptr"), M.shape, device=device)
    out = dataclasses.replace(M, **{
        f.name: getattr(M, f.name).to(device)
        for f in dataclasses.fields(M)
        if isinstance(getattr(M, f.name), torch.Tensor)})
    cache = getattr(M, "_host_cache", None)
    if cache:
        set_host_cache(out, **cache)
    return out


def _on_device(M, device):
    """M on `device`: M itself where it lies there, else its copy there,
    made once and kept on M, so every later closure over M reuses the
    copy and the WJD plan attached to it."""
    if M is None or M.device == device:
        return M
    copies = M.__dict__.setdefault("_device_copies", {})
    if device not in copies:
        copies[device] = _upload(M, device)
    return copies[device]


def place_hierarchy(h: Hierarchy) -> Hierarchy:
    """h with every level operator, transfer and smoother on the fine
    operator's device. Levels that move get their smoother rebuilt there
    (h.smoother, else damped Jacobi) and a deferred coarse solve follows
    the coarsest level."""
    device = h.levels[0].A.device
    make = h.smoother or jacobi_smoother
    levels = []
    for lv in h.levels:
        A = _on_device(lv.A, device)
        smooth = lv.smooth
        if A is not lv.A and smooth is not None:
            smooth = make(A)
        levels.append(MGLevel(A=A, P=_on_device(lv.P, device),
                              R=_on_device(lv.R, device), smooth=smooth))
    coarse = h.coarse_solve
    if isinstance(coarse, _DeferredCoarse) and coarse._A is not levels[-1].A:
        coarse = _DeferredCoarse(levels[-1].A)
    return dataclasses.replace(h, levels=levels, coarse_solve=coarse)


def _energy_factor(w, t, At):
    """Energy-minimizing scale <w,t>/<t,At>, 1 on zero denominator
    (reference: base_multigrid.cpp:766-789)."""
    num = torch.sum(w * t)
    den = torch.sum(t * At)
    return torch.where(den == 0, 1.0, num / torch.where(den == 0, 1.0, den))


def _attach_fast_applies(h: Hierarchy) -> None:
    """Give every level operator AND its transfers their WJD fast applies
    now, at setup: on the card every CSR gets a plan, and a plan that
    fails raises (ops/spmv.maybe_attach_wjd). Transfers are servable
    because the coarse numbering follows fine-row order
    (aggregation._relabel_by_first_row)."""
    for lv in h.levels:
        maybe_attach_wjd(lv.A)
        if lv.P is not None:
            maybe_attach_wjd(lv.P)
        if lv.R is not None:
            maybe_attach_wjd(lv.R)


def cycle_closure(h: Hierarchy) -> Callable:
    """The multigrid cycle as a preconditioner closure r -> e ≈ A^{-1} r.

    The hierarchy is first placed on the fine operator's device
    (`place_hierarchy`), its operators get their WJD fast applies and the
    coarse level is factored there; the placed hierarchy is the closure's
    ``hierarchy`` attribute. With `h.scaling` the pre-smoothed iterate
    (levels 0<l<L-2) and the prolonged correction (levels l<L-2) are
    energy-min scaled; with `h.host_levels` the coarsest levels run on the
    host with numpy/scipy (reference: Vcycle_/Wcycle_/Fcycle_/Kcycle_,
    base_multigrid.cpp:720-981; SetHostLevels, :802-813).
    """
    h = place_hierarchy(h)
    _attach_fast_applies(h)
    cyc = h.cycle.upper()
    L = h.num_levels
    boundary = max(0, L - h.host_levels) if h.host_levels > 0 else None
    host_entry = _host_subtree(h, boundary) if boundary is not None else None
    coarse = (h.coarse_solve.resolve()
              if isinstance(h.coarse_solve, _DeferredCoarse)
              else h.coarse_solve)

    def level_apply(l: int, b, mode: str):
        lv = h.levels[l]
        if boundary is not None and l == boundary:
            out = host_entry(b.cpu().numpy(), mode=mode)
            return torch.from_numpy(out).to(b.device)
        if lv.P is None:
            return coarse(b)
        x = lv.smooth(b, torch.zeros_like(b), h.pre_sweeps)
        if h.scaling and 0 < l < L - 2 and h.pre_sweeps > 0:
            x = x * _energy_factor(b, x, spmv(lv.A, x))
        res_f = b - spmv(lv.A, x)
        res = spmv(lv.R, res_f)
        Ac = h.levels[l + 1].A
        if l + 2 == h.num_levels or mode == "V":
            e = level_apply(l + 1, res, "V" if mode == "F" else mode)
        elif mode == "W":
            e = level_apply(l + 1, res, "W")
            e = e + level_apply(l + 1, res - spmv(Ac, e), "W")
        elif mode == "F":
            # F-cycle: one F recursion then one V recursion
            e = level_apply(l + 1, res, "F")
            e = e + level_apply(l + 1, res - spmv(Ac, e), "V")
        elif mode == "K":
            # K-cycle: two FCG steps on the coarse system, preconditioned
            # by the deeper cycle (Notay; reference SetKcycleFull)
            e = _fcg_steps(Ac, res, lambda r: level_apply(l + 1, r, "K"), 2)
        else:
            raise ValueError(f"unknown cycle {mode!r}")
        t = spmv(lv.P, e)
        if h.scaling and l < L - 2:
            # level 0 numerator uses the post-pre-smooth residual, deeper
            # levels the level rhs (base_multigrid.cpp:862-897)
            w = res_f if l == 0 else b
            x = x + _energy_factor(w, t, spmv(lv.A, t)) * t
        else:
            x = x + t
        return lv.smooth(b, x, h.post_sweeps)

    def apply(r):
        return level_apply(0, r, cyc)

    apply.hierarchy = h
    return apply


def _host_subtree(h: Hierarchy, boundary: int) -> Callable:
    """Numpy/scipy execution of levels >= `boundary`, so coarse grids run
    on the host CPU while the fine levels stay on the device (SetHostLevels
    analog). Mirrors level_apply's recursion exactly."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    mats = {}   # id(matrix) -> scipy matrix

    def as_sp(M):
        key = id(M)
        if key not in mats:
            c = to_csr(M)
            d, i, p = c.numpy_triplet()
            mats[key] = sp.csr_matrix((d, i, p), shape=c.shape)
        return mats[key]

    levels = h.levels
    Ac = to_csr(levels[-1].A)
    dc, ic, pc = Ac.numpy_triplet()
    dense = sp.csr_matrix((dc, ic, pc), shape=Ac.shape).toarray()
    lu = sla.lu_factor(dense)
    inv_diags = {}

    def smooth(l, b, x, sweeps, omega=2.0 / 3.0):
        A = as_sp(levels[l].A)
        if l not in inv_diags:
            d = A.diagonal()
            inv_diags[l] = np.where(d != 0, omega / np.where(d == 0, 1, d),
                                    omega)
        for _ in range(sweeps):
            x = x + inv_diags[l] * (b - A @ x)
        return x

    def factor(w, t, At):
        den = float(np.dot(t, At))
        return 1.0 if den == 0 else float(np.dot(w, t)) / den

    def apply_(l, b, mode):
        lv = levels[l]
        if lv.P is None:
            return sla.lu_solve(lu, b.astype(dense.dtype)).astype(b.dtype)
        x = smooth(l, b, np.zeros_like(b), h.pre_sweeps)
        if h.scaling and 0 < l < len(levels) - 2 and h.pre_sweeps > 0:
            x = x * factor(b, x, as_sp(lv.A) @ x)
        res_f = b - as_sp(lv.A) @ x
        res = as_sp(lv.R) @ res_f
        if l + 2 == len(levels) or mode == "V":
            e = apply_(l + 1, res, "V" if mode == "F" else mode)
        elif mode == "W":
            e = apply_(l + 1, res, "W")
            e = e + apply_(l + 1, res - as_sp(levels[l + 1].A) @ e, "W")
        elif mode == "F":
            e = apply_(l + 1, res, "F")
            e = e + apply_(l + 1, res - as_sp(levels[l + 1].A) @ e, "V")
        else:  # K on host: collapse to V (host subtree is the tail levels)
            e = apply_(l + 1, res, "V")
        t = as_sp(lv.P) @ e
        if h.scaling and l < len(levels) - 2:
            w = res_f if l == 0 else b
            x = x + factor(w, t, as_sp(lv.A) @ t) * t
        else:
            x = x + t
        return smooth(l, b, x, h.post_sweeps)

    def entry(b, mode="V"):
        b = np.asarray(b)
        return apply_(boundary, b, str(mode)).astype(b.dtype)

    return entry


def _fcg_steps(A, b, M: Callable, steps: int):
    """Fixed-step flexible CG (no convergence checks) — K-cycle smoother."""
    x = torch.zeros_like(b)
    r = b
    p = None
    rho = None
    r_prev = None
    for _ in range(steps):
        z = M(r)
        if p is None:
            p = z
            rho = torch.sum(r * z)
        else:
            rho_new = torch.sum(r * z)
            beta = torch.where(rho == 0, 0.0,
                               (rho_new - torch.sum(z * r_prev))
                               / torch.where(rho == 0, 1.0, rho))
            p = z + beta * p
            rho = rho_new
        q = spmv(A, p)
        denom = torch.sum(p * q)
        alpha = torch.where(denom == 0, 0.0,
                            rho / torch.where(denom == 0, 1.0, denom))
        x = x + alpha * p
        r_prev = r
        r = r - alpha * q
    return x


def mg_solve(h: Hierarchy, b, x0=None, *,
             ctrl: Optional[IterationControl] = None, **kwargs):
    """Standalone multigrid solve: FixedPoint iteration with the cycle as
    preconditioner (reference: BaseMultiGrid::Solve cycling until
    tolerance). Returns (x, SolverInfo)."""
    M = cycle_closure(h)
    return fixed_point(M.hierarchy.levels[0].A, b, x0, M,
                       omega=1.0, ctrl=ctrl, **kwargs)
