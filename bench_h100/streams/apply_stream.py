"""Block operator application: Y = rt.spmv(A, X) back to back, X of
`columns` columns taken in turn from a pool drawn from --seed on the
device, no host read between products; the window closes with a device
synchronize.

In the traced stretch each product runs in a ``bench.apply`` range. The
wrapper's host time is read apart, by the host clock around bursts of
`host_burst` products issued right after a synchronize, until
`host_seconds` of host time are summed.
"""

from __future__ import annotations

import time

from bench_h100.harness import derived_seed, mark
from bench_h100.reference import checks, csr


def _sync(run):
    if run.device.startswith("cuda"):
        run.torch.cuda.synchronize()


def setup(run):
    rt, tr = run.rt, run.traffic
    op = run.operator
    A = rt.CSR.from_arrays(op["data"], op["indices"], op["indptr"],
                           op["shape"], device=run.device)
    mark(run, "upload")
    t = time.perf_counter()
    rt.attach_wjd(A)
    run.plan_s = time.perf_counter() - t
    mark(run, "plan")
    make_inputs(run)
    mark(run, "inputs")
    for k in range(min(2, int(tr["pool"]))):          # warm-up
        Y = rt.spmv(A, run.inputs[k])
    run.sample.reserve(Y)
    _sync(run)
    mark(run, "warm_up")
    return {"A": A}


def make_inputs(run):
    """The pool of X blocks, drawn from --seed on the device."""
    torch, tr = run.torch, run.traffic
    gen = torch.Generator(device=run.device)
    gen.manual_seed(derived_seed(run.seed, "inputs"))
    run.inputs = torch.randn((int(tr["pool"]), run.n_cols,
                              int(tr["columns"])), generator=gen,
                             dtype=torch.float64, device=run.device)


def window(run, state, seconds):
    rt, A = run.rt, state["A"]
    pool = int(run.traffic["pool"])
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        k = i % pool
        run.sample.offer(i, (k, rt.spmv(A, run.inputs[k])))
        i += 1
    _sync(run)
    run.window = {"wall_s": time.perf_counter() - t0, "count": i}


def traced(run, state, tracer):
    rt, A, tr = run.rt, state["A"], run.traffic
    pool = int(tr["pool"])
    units = int(tr["trace_units"])
    with tracer.window():
        for i in range(units):
            with tracer.range("bench.apply"):
                Y = rt.spmv(A, run.inputs[i % pool])
            run.sample.offer(i, (i % pool, Y))
    burst, spent, calls, i = int(tr["host_burst"]), 0.0, 0, units
    while spent < float(tr["host_seconds"]):
        _sync(run)
        t = time.perf_counter()
        for _ in range(burst):
            run.sample.offer(i, (i % pool, rt.spmv(A, run.inputs[i % pool])))
            i += 1
        spent += time.perf_counter() - t
        calls += burst
    _sync(run)
    run.host_call_us = spent / calls * 1e6
    run.counters["units"] = i


def release(run, state):
    state.clear()


def control(run, count, dtype):
    """The control in the program's place: the reference's CSR product in
    `dtype` on the first `count` products of the loop."""
    A = csr.csr_tensor(run.operator, run.device, dtype)
    pool = int(run.traffic["pool"])
    for i in range(count):
        Y = csr.apply(A, run.inputs[i % pool].to(dtype))
        run.sample.offer(i, (i % pool, Y.to(run.torch.float64)))


def check(run):
    """Each sampled product against the reference's float64 CSR product."""
    A = csr.csr_tensor(run.operator, run.device)
    refs, out = {}, []
    for _, (k, Y) in run.sample.items():
        if k not in refs:
            refs[k] = csr.apply(A, run.inputs[k])
        out.append({"y_gap": checks.column_gap(Y, refs[k])})
    del A, refs
    if run.device.startswith("cuda"):
        run.torch.cuda.empty_cache()
    return out
