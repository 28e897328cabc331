"""Multigrid solvers: geometric MG + the AMG family.

Counterpart of rocalution_tpu/solvers/multigrid/__init__.py (reference:
BaseMultiGrid/MultiGrid, BaseAMG hierarchy autobuild until coarse_size,
base_amg.cpp:192-325, RugeStuebenAMG, SAAMG, UAAMG, PairwiseAMG).

    h = amg_hierarchy(A, "sa", coarse_size=300)
    x, info = rt.cg(A, b, M=cycle_closure(h))
"""

from __future__ import annotations

from typing import Callable, Optional

from .aggregation import pairwise_level, sa_level, ua_level
from .base import (Hierarchy, MGLevel, build_hierarchy, convert_hierarchy,
                   cycle_closure, jacobi_smoother, make_galerkin_plans,
                   mg_solve, place_hierarchy, precond_smoother,
                   rebuild_hierarchy_numeric)
from .rs import rs_level

_LEVEL_BUILDERS = {
    "sa": sa_level,
    "ua": ua_level,
    "rs": rs_level,
    "pairwise": pairwise_level,
}


def amg_hierarchy(
    A,
    kind: str = "sa",
    *,
    coarse_size: int = 300,
    max_levels: int = 10,
    smoother: Optional[Callable] = None,
    coarse_solve: Optional[Callable] = None,
    pre_sweeps: int = 1,
    post_sweeps: int = 2,
    cycle: str = "V",
    **level_kwargs,
) -> Hierarchy:
    """Autobuild an AMG hierarchy (reference: BaseAMG::BuildHierarchy loop
    until op->GetM() <= coarse_size, base_amg.cpp:192-325).

    kind: "sa" | "ua" | "rs" | "pairwise"; level_kwargs pass through to
    the per-kind coarsening (eps/omega/strategy for sa, theta/coarsening/
    interpolation for rs, beta/npass for pairwise, over_interp for ua).
    The levels below A are host-resident until a cycle closure places
    them on A's device.
    """
    level_fn = _LEVEL_BUILDERS[kind]
    ops = [A]
    prolongs, restricts = [], []
    while ops[-1].shape[0] > coarse_size and len(ops) < max_levels:
        kw = dict(level_kwargs)
        kw.setdefault("seed", len(ops))     # vary Luby priorities per level
        if kind in ("sa", "ua"):
            # coupling threshold HALVES per level (reference:
            # smoothed_amg.cpp:263-267 — eps *= 0.5 for each built level)
            kw["eps"] = (kw.get("eps", 0.08) * 0.5 ** (len(ops) - 1))
        try:
            P, R, Ac = level_fn(ops[-1], **kw)
        except ValueError:
            break
        if Ac.shape[0] >= ops[-1].shape[0] or Ac.shape[0] == 0:
            break                            # coarsening stalled
        prolongs.append(P)
        restricts.append(R)
        ops.append(Ac)
    if len(ops) == 1 and A.shape[0] > max(coarse_size, 4096):
        raise ValueError(
            f"AMG({kind}) failed to coarsen a {A.shape[0]}-row matrix at "
            "all — refusing to fall back to a dense coarse solve; check "
            "strength/coarsening parameters"
        )
    return build_hierarchy(
        ops, prolongs, restricts, smoother=smoother,
        coarse_solve=coarse_solve, pre_sweeps=pre_sweeps,
        post_sweeps=post_sweeps, cycle=cycle,
    )


def saamg(A, **kwargs) -> Hierarchy:
    """Smoothed-aggregation AMG hierarchy (reference: SAAMG)."""
    return amg_hierarchy(A, "sa", **kwargs)


def uaamg(A, **kwargs) -> Hierarchy:
    """Unsmoothed-aggregation AMG hierarchy (reference: UAAMG)."""
    return amg_hierarchy(A, "ua", **kwargs)


def rsamg(A, **kwargs) -> Hierarchy:
    """Ruge-Stüben AMG hierarchy (reference: RugeStuebenAMG)."""
    return amg_hierarchy(A, "rs", **kwargs)


def pairwise_amg(A, **kwargs) -> Hierarchy:
    """Pairwise-aggregation AMG hierarchy (reference: PairwiseAMG)."""
    return amg_hierarchy(A, "pairwise", **kwargs)


def amg_precond(A_or_hierarchy, kind: str = "sa", **kwargs) -> Callable:
    """One AMG cycle as a preconditioner closure (the usual CG+AMG
    pairing, reference samples cg-amg.cpp etc.)."""
    h = (A_or_hierarchy if isinstance(A_or_hierarchy, Hierarchy)
         else amg_hierarchy(A_or_hierarchy, kind, **kwargs))
    return cycle_closure(h)


__all__ = [
    "Hierarchy", "MGLevel", "amg_hierarchy", "amg_precond",
    "build_hierarchy", "convert_hierarchy", "cycle_closure",
    "jacobi_smoother", "make_galerkin_plans", "mg_solve",
    "pairwise_amg", "pairwise_level", "place_hierarchy",
    "precond_smoother", "rebuild_hierarchy_numeric", "rs_level", "rsamg",
    "sa_level", "saamg", "ua_level", "uaamg",
]
