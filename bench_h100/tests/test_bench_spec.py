"""BENCHMARK.json and the benchmark's files: the contract's shapes, and a
cell and a metric added as files alone."""

import json
import re

import pytest

from bench_h100 import harness
from bench_h100.tests.conftest import REPO, with_held

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
WITH_HELD = with_held(BENCH)
CELLS = [w["name"] for w in WITH_HELD["workloads"]]


@pytest.mark.parametrize("bench", [BENCH, WITH_HELD],
                         ids=["committed", "with_held"])
def test_benchmark_json_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_h100"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/")
        assert c["name"] in {w["config"] for w in bench["workloads"]}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_held_cells_are_out_of_the_benchmark_and_unmeasured():
    cells = {w["name"] for w in BENCH["workloads"]}
    for path in (REPO / "bench_h100" / "held").glob("*.json"):
        held = json.loads(path.read_text())
        assert not {w["name"] for w in held["workloads"]} & cells
        assert all(m["bound"] is None for m in held["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_loads(cell, tiny_root):
    c = harness.load_cell(tiny_root, cell)
    gen = c.bench_dir / "operators" / f"{c.config['generator']}.py"
    assert hasattr(harness.load_module(gen, "t_op"), "build")
    stream = harness.load_module(
        c.bench_dir / "streams" / f"{c.traffic['kind']}.py", "t_stream")
    for fn in ("setup", "make_inputs", "window", "traced", "release",
               "control", "check"):
        assert callable(getattr(stream, fn))
    assert c.spec["checks"] and c.spec["sample"] >= 1
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        mod = harness.load_module(c.bench_dir / "metrics" / f"{m['name']}.py",
                                  "t_metric")
        assert callable(mod.read)
    for k, v in c.spec["checks"].items():
        assert NAME.match(k) and harness.limit_of(v["limit"], c) >= 0


def test_a_cell_and_a_metric_added_as_files_alone_run(tiny_root,
                                                      port_on_cpu):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as files and BENCHMARK.json entries only, are found and run."""
    bench_dir = tiny_root / "bench_h100"
    (bench_dir / "configs" / "heat3d_7pt_5_f64.json").write_text(json.dumps(
        {"name": "heat3d_7pt_5_f64", "generator": "heat3d_7pt", "grid": 5,
         "tau": 1.0, "dtype": "float64", "reduced": []}))
    (bench_dir / "traffic" / "cg_loose.json").write_text(json.dumps(
        {"kind": "solve_stream", "solver": "cg",
         "preconditioner": "jacobi", "rel_tol": 1e-4, "rhs": "A_times_ones",
         "x0": "uniform", "x0_range": [0.0, 2.0], "pool": 2,
         "trace_units": 2}))
    (bench_dir / "workloads" / "heat3d5.cg_loose.json").write_text(
        json.dumps({"sample": 2, "checks": {
            "resid": {"limit": "rel_tol"},
            "x_gap": {"limit": 1e-10}}}))
    (bench_dir / "metrics" / "solves_traced.solve.py").write_text(
        "def read(run):\n    return run.counters.get('units')\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "heat3d_7pt_5_f64", "source": "test",
                             "file": "bench_h100/configs/heat3d_7pt_5_f64.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "heat3d5.cg_loose",
                               "config": "heat3d_7pt_5_f64",
                               "traffic": "cg_loose", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("heat3d5.cg_loose")
    bench["per_layer"].append({"name": "solves_traced.solve",
                               "unit": "solves", "better": "higher",
                               "source": "program_counter",
                               "layer": "solvers", "moves": "solve_ms",
                               "workloads": ["heat3d5.cg_loose"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tiny_root, "heat3d5.cg_loose")
    out = harness.run_cell(cell, 7, 0.05, False, "cpu", 0.0, rt=port_on_cpu)
    assert out["correct"] and set(out["metrics"]) == {"solve_ms", "setup_s"}
    out = harness.run_cell(cell, 7, 0.05, True, "cpu", 0.0, rt=port_on_cpu)
    assert out["correct"]
    assert out["metrics"]["solves_traced.solve"]["value"] == 2
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("key,value", [("rhs", "randn"), ("x0", "zero")])
def test_a_mix_the_driver_cannot_make_is_refused(key, value, tiny_root,
                                                 port_on_cpu):
    """A traffic mix's rhs or x0 that its driver does not make stops the
    run: it never runs silently as another mix."""
    p = tiny_root / "bench_h100" / "traffic" / "cg_jacobi.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), key: value}))
    cell = harness.load_cell(tiny_root, "heat3d.cg_jacobi")
    with pytest.raises(ValueError, match=value):
        harness.run_cell(cell, 7, 0.05, False, "cpu", 0.0, rt=port_on_cpu)
