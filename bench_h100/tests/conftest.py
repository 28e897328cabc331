"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
configurations, and the port on the CPU. Tests that need the card carry
the marker `cuda` and decide inside a fixture whether to skip."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench_h100"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"heat3d_7pt_256_f64": {"grid": 6},
        "fem2d_p1_525825_f64": {"points": 600}}
TINY_TRAFFIC = {"cg_jacobi": {"trace_units": 3},
                "spmm32": {"trace_units": 4, "host_seconds": 0.05,
                           "host_burst": 2}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def with_held(bench: dict) -> dict:
    """BENCHMARK.json with the entries of every cell held back under
    `held/` added, as a later change would add them (a held bound that is
    not measured yet reads the largest allowed)."""
    bench = json.loads(json.dumps(bench))
    for path in sorted((BENCH / "held").glob("*.json")):
        held = json.loads(path.read_text())
        cells = [w["name"] for w in held["workloads"]]
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in held[key]:
                if key == "end_to_end" and entry["bound"] is None:
                    entry = {**entry, "bound": 0.25}
                bench[key].append(entry)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in held["also_reports"]:
                m["workloads"] = m["workloads"] + cells
    return bench


def copy_bench(dest: Path) -> Path:
    """A copy of BENCHMARK.json, with the held-back cells added, and the
    benchmark's files under `dest`, with every configuration and traffic
    mix cut to a CPU test's size."""
    shutil.copytree(BENCH, dest / "bench_h100",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dest / "BENCHMARK.json").write_text(json.dumps(with_held(bench)))
    for name, keys in TINY.items():
        p = dest / "bench_h100" / "configs" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **keys}))
    for name, keys in TINY_TRAFFIC.items():
        p = dest / "bench_h100" / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **keys}))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return copy_bench(tmp_path)


@pytest.fixture
def port_on_cpu(monkeypatch):
    """The port on the CPU, planning with no plan cache, one thread."""
    import torch

    import rocalution_tpu_torch as rt

    monkeypatch.setenv("ROCALUTION_TPU_TORCH_PLAN_CACHE", "0")
    threads = torch.get_num_threads()
    device = rt.get_config().default_device
    torch.set_num_threads(1)
    rt.set_default_device("cpu")
    yield rt
    rt.set_default_device(device)
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the WJD kernels have no CPU mode")
    return "cuda"
