"""A closed loop of solves: one client, the next solve starts when the
last one's SolverInfo is on the host. The traffic mix names the
right-hand side (`rhs`) and the initial guesses (`x0`); this driver
knows rocALUTION's test oracle, b = A 1 (`"A_times_ones"`), and x0 drawn
uniform in `x0_range` from --seed on the device (`"uniform"`), a pool of
`pool` of them taken in turn. Any other value is refused.

The operator is the configuration's CSR on the card with its WJD plan
attached at set-up (`rt.attach_wjd`, timed as `plan_s`). In the traced
stretch the same A and M go to the solver as callables wrapped in
``bench.operator`` and ``bench.precond`` ranges, each solve in a
``bench.solve`` range. Each solve's steps come from the port's launch
counters: launches over those of one apply, less the initial residual's.
"""

from __future__ import annotations

import importlib
import time

from bench_h100.harness import derived_seed, mark
from bench_h100.reference import cg as ref_cg
from bench_h100.reference import checks, csr


def _launches(run) -> int:
    mod = importlib.import_module("rocalution_tpu_torch.ops.cuda.spmv_wjd")
    return sum(mod.launches.values())


def _sync(run):
    if run.device.startswith("cuda"):
        run.torch.cuda.synchronize()


RHS = ("A_times_ones",)
X0 = ("uniform",)


def _mix(run):
    """The mix's rhs and x0, refused where this driver does not make
    them."""
    tr = run.traffic
    if tr.get("rhs") not in RHS or tr.get("x0") not in X0:
        raise ValueError(f"solve_stream makes rhs in {RHS} and x0 in {X0}; "
                         f"the mix asks rhs {tr.get('rhs')!r}, "
                         f"x0 {tr.get('x0')!r}")
    low, high = (float(v) for v in tr["x0_range"])
    return low, high


def setup(run):
    rt, tr = run.rt, run.traffic
    _mix(run)
    op = run.operator
    A = rt.CSR.from_arrays(op["data"], op["indices"], op["indptr"],
                           op["shape"], device=run.device)
    mark(run, "upload")
    t = time.perf_counter()
    rt.attach_wjd(A)
    run.plan_s = time.perf_counter() - t
    mark(run, "plan")
    M = getattr(rt, tr["preconditioner"])(A)
    make_inputs(run)
    mark(run, "inputs")
    before = _launches(run)
    rt.spmv(A, run.b)
    _sync(run)
    state = {"A": A, "M": M, "solve": getattr(rt, tr["solver"]),
             "per_apply": _launches(run) - before}
    solve(run, state, 0, A, M)                         # warm-up
    run.sample.reserve(run.inputs[0])
    _sync(run)
    mark(run, "warm_up")
    return state


def make_inputs(run):
    """b = A 1, the row sums of the harness's arrays (float64, on the
    host), and the pool of initial guesses, drawn from --seed on the
    device."""
    import numpy as np

    torch = run.torch
    low, high = _mix(run)
    op = run.operator
    starts = np.asarray(op["indptr"][:-1], dtype=np.int64)
    b = np.add.reduceat(np.asarray(op["data"], dtype=np.float64), starts)
    b[np.diff(op["indptr"]) == 0] = 0.0
    run.b = torch.from_numpy(b).to(run.device)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(derived_seed(run.seed, "inputs"))
    run.inputs = torch.rand((int(run.traffic["pool"]), run.n_rows),
                            generator=gen, dtype=torch.float64,
                            device=run.device)
    run.inputs.mul_(high - low).add_(low)


def solve(run, state, k, op, M):
    """One solve from pool entry k: (x, iterations, status, steps)."""
    before = _launches(run)
    x, info = state["solve"](op, run.b, x0=run.inputs[k], M=M,
                             rel_tol=float(run.traffic["rel_tol"]))
    it, status = run.torch.stack([info.iterations.long(),
                                  info.status.long()]).tolist()
    per = state["per_apply"]
    steps = (_launches(run) - before) // per - 1 if per else None
    return x, it, status, steps


def _done(run, i, k, x, it, status, steps):
    run.sample.offer(i, (k, x, it))
    c = run.counters
    c["failed"] = c.get("failed", 0) + (status not in (1, 2))
    c["iterations"] = c.get("iterations", 0) + it
    if steps is not None:
        c["steps"] = c.get("steps", 0) + steps


def window(run, state, seconds):
    pool = int(run.traffic["pool"])
    lat = []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        k = i % pool
        ts = time.perf_counter()
        x, it, status, steps = solve(run, state, k, state["A"], state["M"])
        te = time.perf_counter()
        lat.append(te - ts)
        _done(run, i, k, x, it, status, steps)
        i += 1
        if te >= deadline:
            break
    run.window = {"wall_s": te - t0, "count": i, "latencies_s": lat}


def traced(run, state, tracer):
    rt, A, M = run.rt, state["A"], state["M"]

    def op(v):
        with tracer.range("bench.operator"):
            return rt.spmv(A, v)

    def pc(r):
        with tracer.range("bench.precond"):
            return M(r)

    pool = int(run.traffic["pool"])
    units = int(run.traffic["trace_units"])
    with tracer.window():
        for i in range(units):
            with tracer.range("bench.solve"):
                x, it, status, steps = solve(run, state, i % pool, op, pc)
            _done(run, i, i % pool, x, it, status, steps)
    run.counters["units"] = units


def release(run, state):
    state.clear()


def control(run, count, dtype):
    """The control in the program's place: the reference's CG + Jacobi
    in `dtype` on the first `count` solves of the loop, offered as the
    program's answers are."""
    A = csr.csr_tensor(run.operator, run.device, dtype)
    d = csr.diagonal(run.operator, run.device, dtype)
    pool = int(run.traffic["pool"])
    for i in range(count):
        x, it = ref_cg.pcg_jacobi(A, d, run.b.to(dtype),
                                  float(run.traffic["rel_tol"]),
                                  x0=run.inputs[i % pool].to(dtype))
        run.sample.offer(i, (i % pool, x.to(run.torch.float64), it))


def check(run):
    """Each sampled solve against the reference: the true residual over
    the initial one, the gap to the reference's x from the same x0, the
    gap in iterations."""
    torch = run.torch
    rel_tol = float(run.traffic["rel_tol"])
    A = csr.csr_tensor(run.operator, run.device)
    d = csr.diagonal(run.operator, run.device)
    refs, out = {}, []
    b = run.b
    for _, (k, x, it) in run.sample.items():
        x0 = run.inputs[k]
        if k not in refs:
            refs[k] = ref_cg.pcg_jacobi(A, d, b, rel_tol, x0=x0)
        xr, itr = refs[k]
        out.append({"resid": checks.rel_residual(A, x, b, x0),
                    "x_gap": checks.rel_gap(x, xr),
                    "iter_gap": abs(int(it) - int(itr))})
    del A, d, refs
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out
