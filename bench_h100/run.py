"""Run one cell of the benchmark once on the card:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers compared, each beside its limit.
"""

import os
import sys
import time


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc), so that
    set-up counts the interpreter's start too; now where /proc has none."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


T0 = process_start()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
# no plan is read from an earlier run: every run plans in its set-up
os.environ["ROCALUTION_TPU_TORCH_PLAN_CACHE"] = "0"
# compiler caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from bench_h100 import harness

    sys.exit(harness.main(sys.argv[1:], T0))
