"""The harness on the card at a tiny size: each cell measured and traced
through the WJD kernels, one process a run as in the benchmark (the
profiler traces the card once a process). Skips without an NVIDIA GPU;
run on the card with

    python -m pytest -p no:cacheprovider bench_h100/tests -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from bench_h100.tests.conftest import REPO

pytestmark = pytest.mark.cuda

CELLS = ("heat3d.cg_jacobi", "fem2d.spmm32")

RUN = """
import json, sys, time
sys.path.insert(0, {repo!r})
from bench_h100 import harness
cell = harness.load_cell(harness.Path({root!r}), {cell!r})
out = harness.run_cell(cell, 2200000000, 0.5, {trace}, "cuda",
                       time.perf_counter())
print(json.dumps(out))
"""


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_card(cell, trace, card, tiny_root):
    env = dict(os.environ, ROCALUTION_TPU_TORCH_PLAN_CACHE="0")
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(repo=str(REPO), root=str(tiny_root),
                                          cell=cell, trace=trace)],
        cwd=tiny_root, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
        assert out["breakdown"]["device_ops"]
        for name, m in out["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < m["value"] <= 105
    else:
        assert out["metrics"]["setup_s"]["value"] > 0
