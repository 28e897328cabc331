"""The metric arithmetic on fixed inputs, and the trace reduction on a
made-up trace."""

from types import SimpleNamespace

import pytest

from bench_h100 import harness, roofline, tracing
from bench_h100.tests.conftest import BENCH

H100 = "NVIDIA H100 80GB HBM3"


def metric(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", "t_m")


class FakeCuda:
    @staticmethod
    def get_device_name(_):
        return H100


def fake_run(**kw):
    base = dict(window=None, trace=None, counters={}, setup_s=12.5,
                plan_s=3.25, host_call_us=250.0, n_rows=1000, n_cols=1000,
                nnz=7000, traffic={"columns": 32},
                torch=SimpleNamespace(cuda=FakeCuda))
    base.update(kw)
    return SimpleNamespace(**base)


TRACE = {"window_s": 2.0, "busy_s": 1.5, "device_ops": 30,
         "device_s_by_range": {"bench.solve": 0.6, "bench.operator": 0.3,
                               "bench.precond": 0.1, "bench.apply": 0.8},
         "device_ops_by_range": {"bench.solve": 20, "bench.operator": 6,
                                 "bench.precond": 4},
         "range_counts": {"bench.operator": 6, "bench.apply": 4}}


def test_window_rates_and_the_tail():
    lat = [0.1] * 95 + [0.2] * 5
    run = fake_run(window={"wall_s": 10.0, "count": 100,
                           "latencies_s": lat})
    assert metric("solve_ms").read(run) == pytest.approx(100.0)
    assert metric("apply_us").read(run) == pytest.approx(1e5)
    p95 = metric("solve_p95_ms")
    assert p95.percentile([1, 2, 3, 4, 5], 50) == 3
    assert p95.percentile([0, 10], 95) == pytest.approx(9.5)
    assert p95.read(run) == pytest.approx(100.0 + 0.05 * 100.0)
    assert metric("setup_s").read(run) == 12.5
    assert metric("plan_s").read(run) == 3.25
    assert metric("wrapper_host_us.apply").read(run) == 250.0
    assert metric("solve_ms").read(fake_run()) is None


def test_layer_shares_and_rooflines():
    run = fake_run(trace=TRACE, counters={"steps": 10, "iterations": 7})
    assert metric("masked_step_share.solve").read(run) == pytest.approx(0.3)
    assert metric("vector_ms_per_step.solve").read(run) == pytest.approx(60)
    assert metric("precond_ms_per_step.solve").read(run) == pytest.approx(10)
    assert metric("device_ops_per_step.solve").read(run) == pytest.approx(3)
    for name in ("idle_share.solve", "idle_share.apply"):
        assert metric(name).read(run) == pytest.approx(0.25)
    bound = (7000 + 2000) * 8 / 3.35e12
    assert metric("spmv_roofline").read(run) == pytest.approx(
        100 * bound / 0.05)
    bound32 = (7000 + 2000 * 32) * 8 / 3.35e12
    assert metric("spmm_roofline").read(run) == pytest.approx(
        100 * bound32 / 0.2)
    assert roofline.hbm_bytes_per_s("some other card") is None


def test_readers_find_nothing_and_return_none():
    run = fake_run(trace={**TRACE, "device_ops": 0})
    for name in ("vector_ms_per_step.solve", "spmv_roofline",
                 "spmm_roofline", "idle_share.solve",
                 "masked_step_share.solve"):
        assert metric(name).read(run) is None


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction_charges_device_time_to_the_innermost_range():
    events = [
        _x("user_annotation", "bench.window", 0, 1000),
        _x("user_annotation", "bench.solve", 10, 900),
        _x("user_annotation", "bench.operator", 100, 100),
        _x("cpu_op", "aten::mul", 300, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 5, corr=3),
        _x("kernel", "axpy", 30, 100, tid=7, corr=1),
        _x("kernel", "spmv", 160, 200, tid=7, corr=2),   # overlaps axpy? no
        _x("kernel", "scale", 400, 50, tid=7, corr=3),
    ]
    s = tracing.reduce_trace(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["device_s_by_range"] == pytest.approx(
        {"bench.solve": 150e-6, "bench.operator": 200e-6})
    assert s["device_ops_by_range"] == {"bench.solve": 2,
                                        "bench.operator": 1}
    assert s["range_counts"]["bench.operator"] == 1
    assert s["top_device_ops"][0] == ("spmv", pytest.approx(200e-6))
    gaps = dict(s["idle_gaps"])
    # idle from 0 to 30 (the window, no host event yet but bench.window is
    # excluded), 130-160 in the operator range, 360-400 in the solve range
    # (aten::mul ended at 350), 450-1000 partly after the solve range
    assert gaps["bench.operator"] == pytest.approx(30e-6)
    assert gaps["bench.solve"] == pytest.approx(40e-6 + 550e-6)
    assert gaps["host"] == pytest.approx(30e-6)


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        tracing.reduce_trace([_x("kernel", "k", 0, 1, corr=1)])


def test_the_sample_is_drawn_from_the_seed_copied_and_keeps_the_last():
    import torch

    def draw(seed):
        r = harness.Reservoir(harness.derived_seed(seed, "sample"), 4)
        r.reserve(torch.zeros(3))
        for i in range(50):
            r.offer(i, (i, torch.full((3,), float(i))))
        return r

    a, b, c = draw(2200000000), draw(2200000000), draw(2200000001)
    ia = [i for i, _ in a.items()]
    assert ia == [i for i, _ in b.items()] != [i for i, _ in c.items()]
    assert ia[-1] == 49 and len(ia) in (4, 5)
    for i, (k, t) in a.items():
        assert k == i and torch.equal(t, torch.full((3,), float(i)))
    kept = [t for i, (_, t) in a.items() if i != 49 or len(ia) == 4]
    assert all(any(t is buf for buf in a.buffers) for t in kept[:4])
    assert harness.derived_seed(-5, "x") >= 0

