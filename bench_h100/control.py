"""The two readings that a cell's limits are set from, at the cell's own
size, in one process (set-up once):

- lower: the program's worst reading of each compared number, a short
  window at the cell's load on each of --seeds, its sample compared as a
  run compares it;
- upper: the control's, on each of --control-seeds: the reference put in
  the program's place and computed one precision below the configuration's
  (float32 for float64), on as many answers as a run compares.

    python3 bench_h100/control.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103 [--seconds 2] [--out FILE]

The benchmark's own runs never run this. It prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["ROCALUTION_TPU_TORCH_PLAN_CACHE"] = "0"
sys.path.insert(0, os.path.dirname(HERE))

# the precision below the configuration's, the step a later change might take
LOWER_DTYPE = {"float64": "float32"}


def readings(cell, run, stream, state, seeds, seconds, control_dtype=None):
    """{seed: {number: worst reading}} over the seeds."""
    from bench_h100 import harness
    from bench_h100.reference.checks import worst

    out = {}
    for seed in seeds:
        run.seed = int(seed)
        run.counters = {}
        harness.new_sample(run)
        stream.make_inputs(run)
        if control_dtype is None:
            stream.window(run, state, seconds)
        else:
            stream.control(run, int(cell.spec["sample"]) + 1, control_dtype)
        got = stream.check(run)
        out[seed] = {k: worst(r[k] for r in got) for k in got[0]}
        out[seed]["answers"] = len(got)
        out[seed]["failed"] = run.counters.get("failed", 0)
        print(f"{'control' if control_dtype else 'program'} seed {seed}: "
              f"{out[seed]}", file=sys.stderr, flush=True)
    return out


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from bench_h100 import harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(harness.ROOT, args.workload)
    run, stream = harness.new_run(cell, args.seeds[0] if args.seeds
                                  else args.control_seeds[0], "cuda")
    state = stream.setup(run)
    lower = readings(cell, run, stream, state, args.seeds, args.seconds)
    stream.release(run, state)
    del state
    torch.cuda.empty_cache()
    dtype = getattr(torch, LOWER_DTYPE[cell.config["dtype"]])
    upper = readings(cell, run, stream, None, args.control_seeds,
                     args.seconds, dtype)
    result = {"workload": args.workload, "card": harness.power_limit(),
              "program": lower, "control": upper,
              "seconds": time.perf_counter() - T0}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
