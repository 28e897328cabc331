"""Composable benchmark/driver CLI.

Counterpart of rocalution_tpu/bench_cli.py (reference: `rocalution_bench`,
clients/benchmarks/*): an itsolver x preconditioner x format x matrix-init
sweep (rocalution_enum_itsolver.hpp:33-46,
rocalution_enum_preconditioner.hpp:33-48,
rocalution_enum_matrix_init.hpp:33-36) with the results struct
(convergence, iter, time_import/analyze/solve, norm_residual,
rocalution_bench_solver_results.hpp:33-78).

Usage:
  python -m rocalution_tpu_torch.bench_cli --solver cg --precond jacobi \
      --format DIA --matrix laplacian2d --size 256 --tol 1e-8
Prints one JSON object with timings and solve quality. The matrix is
built on the port's default device: the card, unless the caller set
another (`rocalution_tpu_torch.set_default_device("cpu")`).

Sweep mode (the `rocalution_bench_cmdlines` expander,
clients/benchmarks/rocalution_bench_cmdlines.hpp:100): `--solver`,
`--precond`, `--format` and `--size` accept comma-separated lists; every
combination of the cartesian product runs as its own case, one JSON line
each, with a final `{"sweep_summary": ...}` line. `--out FILE` appends the
JSONL to a file for `scripts/bench_regression.py` /
`scripts/bench_plot.py`.

`engine` names what served the solve: the WJD kernel entry points whose
launch counters moved during it (ops/cuda/spmv_wjd.py `launches`, joined
by "+"), or "plain" when none moved, as on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

SOLVERS = ["cg", "cr", "fcg", "bicgstab", "bicgstabl", "gmres", "fgmres",
           "idr", "qmrcgstab", "chebyshev", "fixed_point",
           "saamg", "uaamg", "rsamg", "pairwise_amg"]
PRECONDS = ["none", "jacobi", "gs", "sgs", "sor", "ssor", "ilu", "ilut",
            "itilu0", "ic", "mcgs", "mcsgs", "mcilu", "fsai", "spai", "tns",
            "aichebyshev", "blockjacobi", "as", "ras", "me",
            "saamg", "uaamg", "rsamg", "pairwise_amg"]
FORMATS = ["CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE", "WJD"]
MATRICES = ["laplacian2d", "laplacian3d", "permuted_identity", "file"]
AMG_KINDS = {"saamg": "sa", "uaamg": "ua", "rsamg": "rs",
             "pairwise_amg": "pairwise"}


def build_matrix(args, rt, np):
    if args.matrix == "laplacian2d":
        return rt.laplacian_2d(args.size, dtype=np.dtype(args.dtype))
    if args.matrix == "laplacian3d":
        return rt.laplacian_3d(args.size, dtype=np.dtype(args.dtype))
    if args.matrix == "permuted_identity":
        return rt.utils.generators.permuted_identity(
            args.size, dtype=np.dtype(args.dtype))
    if args.matrix == "file":
        if not args.file:
            sys.exit("--matrix file requires --file PATH")
        return rt.io.read_mtx(args.file, dtype=np.dtype(args.dtype))
    raise ValueError(args.matrix)


def precond_table():
    """Every name of PRECONDS to the builder of its counterpart."""
    import rocalution_tpu_torch.precond as pc
    from rocalution_tpu_torch.solvers.multigrid import amg_precond

    table = {
        "none": lambda A: None,
        "jacobi": pc.jacobi, "gs": pc.gs, "sgs": pc.sgs,
        "sor": lambda A: pc.sor(A, 1.2), "ssor": lambda A: pc.ssor(A, 1.2),
        "ilu": pc.ilu, "ilut": pc.ilut_precond, "itilu0": pc.itilu0,
        "ic": pc.ic, "mcgs": pc.multicolored_gs,
        "mcsgs": pc.multicolored_sgs, "mcilu": pc.multicolored_ilu,
        "fsai": pc.fsai, "spai": pc.spai, "tns": pc.tns,
        "aichebyshev": pc.aichebyshev, "blockjacobi": pc.block_jacobi,
        "as": pc.additive_schwarz, "ras": pc.restricted_additive_schwarz,
        "me": pc.multi_elimination,
    }
    for name, kind in AMG_KINDS.items():
        table[name] = lambda A, kind=kind: amg_precond(A, kind)
    return table


def build_precond(name, A):
    """The preconditioner `name` of A (None for "none")."""
    return precond_table()[name](A)


def _csv(choices):
    """Argparse type: comma-separated subset of `choices` (sweep lists)."""
    def parse(s):
        vals = [v for v in s.split(",") if v]
        for v in vals:
            if v not in choices:
                raise argparse.ArgumentTypeError(
                    f"{v!r} not in {sorted(choices)}")
        return vals
    return parse


def main(argv=None):
    p = argparse.ArgumentParser(prog="rocalution_tpu_torch.bench_cli")
    p.add_argument("--solver", type=_csv(SOLVERS), default=["cg"])
    p.add_argument("--precond", type=_csv(PRECONDS), default=["none"])
    p.add_argument("--format", dest="fmt", type=_csv(FORMATS),
                   default=["CSR"])
    p.add_argument("--matrix", choices=MATRICES, default="laplacian2d")
    p.add_argument("--file", default=None, help="MTX path for --matrix file")
    p.add_argument("--size", type=lambda s: [int(v) for v in s.split(",")],
                   default=[64])
    p.add_argument("--dtype", default="float64")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--abs-tol", type=float, default=1e-15)
    p.add_argument("--max-iter", type=int, default=10000)
    p.add_argument("--out", default=None,
                   help="append result JSONL to this file")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    # cartesian sweep (rocalution_bench_cmdlines.hpp:100 expander): one
    # case per (solver, precond, format, size) combination
    combos = list(itertools.product(args.solver, args.precond, args.fmt,
                                    args.size))
    results, fails = [], 0
    for sol, pre, fmt, size in combos:
        case = argparse.Namespace(**vars(args))
        case.solver, case.precond, case.fmt, case.size = sol, pre, fmt, size
        try:
            res = run_case(case)
        except Exception as e:  # one bad combo must not kill the sweep
            res = {"solver": sol, "precond": pre, "format": fmt,
                   "size": size, "convergence": False,
                   "error": f"{type(e).__name__}: {e}"}
        results.append(res)
        print(json.dumps(res), flush=True)
        fails += 0 if res.get("convergence") else 1
    if args.out:
        with open(args.out, "a") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")
    if len(combos) > 1:
        print(json.dumps({"sweep_summary": {
            "cases": len(combos), "converged": len(combos) - fails,
            "failed": fails}}))
    return 0 if fails == 0 else 1


def run_case(args):
    import numpy as np
    import torch

    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.ops.cuda.spmv_wjd import launches
    from rocalution_tpu_torch.ops.spmv import maybe_attach_wjd
    from rocalution_tpu_torch.solvers.multigrid import (amg_hierarchy,
                                                        cycle_closure,
                                                        mg_solve)

    t0 = time.perf_counter()
    A_csr = build_matrix(args, rt, np)
    b = rt.spmv(A_csr, torch.ones(A_csr.shape[1], dtype=A_csr.dtype,
                                  device=A_csr.device))
    rt.sync()
    t_import = time.perf_counter() - t0

    # analyze/build phase: format conversion, preconditioner setup and the
    # WJD plans the solve will use (the operator's; for AMG every level's
    # and transfer's, on the levels placed where the cycle runs)
    t0 = time.perf_counter()
    A = rt.convert(A_csr, args.fmt) if args.fmt != "CSR" else A_csr
    if args.solver in AMG_KINDS:
        h = cycle_closure(amg_hierarchy(A_csr, AMG_KINDS[args.solver]))
        h = h.hierarchy
    else:
        solver_fn = getattr(rt, args.solver)
        M = build_precond(args.precond, A_csr)
        maybe_attach_wjd(A)
    rt.sync()
    t_analyze = time.perf_counter() - t0

    kw = dict(rel_tol=args.tol, abs_tol=args.abs_tol, max_iter=args.max_iter)
    before = dict(launches)
    t0 = time.perf_counter()
    if args.solver in AMG_KINDS:
        x, info = mg_solve(h, b, **kw)
    elif args.solver == "chebyshev":
        # Gershgorin bounds apply to A, not M^{-1}A: a preconditioner would
        # invalidate them, so chebyshev always runs unpreconditioned here
        lo, hi = rt.gershgorin(A_csr)
        x, info = rt.chebyshev(A, b, lambda_min=max(float(lo), 1e-6),
                               lambda_max=float(hi), **kw)
    elif args.solver == "fixed_point":
        x, info = rt.fixed_point(A, b, M=M, **kw)
    else:
        x, info = solver_fn(A, b, M=M, **kw)
    x = x.cpu().numpy()   # the result on the host ends the timer
    t_solve = time.perf_counter() - t0
    moved = sorted(k for k, n in launches.items() if n != before[k])

    return {
        "solver": args.solver, "precond": args.precond, "format": args.fmt,
        "engine": "+".join(moved) or "plain",
        "matrix": f"{args.matrix}({args.size})",
        "n": A_csr.shape[0], "nnz": A_csr.nnz,
        "convergence": int(info.status) in (1, 2),
        "iter": int(info.iterations),
        "norm_residual": float(info.final_res),
        "time_import_s": round(t_import, 4),
        "time_analyze_s": round(t_analyze, 4),
        "time_solve_s": round(t_solve, 4),
        "time_global_s": round(t_import + t_analyze + t_solve, 4),
        "nrmmax_err": float(np.max(np.abs(x - 1.0))),
    }


if __name__ == "__main__":
    sys.exit(main())
