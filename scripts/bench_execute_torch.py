#!/usr/bin/env python3
"""Execute a set of bench_cli command lines from a .json file, through the
PyTorch/CUDA port.

The twin of scripts/bench_execute.py for `rocalution_tpu_torch` (reference
parity: scripts/rocalution-bench-execute.py): the file must contain an
array ``"cmdlines"`` of option strings; each runs as one
`python -m rocalution_tpu_torch.bench_cli <options>` invocation, on the
port's default device (the card). Results stream to stdout and (with
--out) accumulate as JSONL for bench_plot.py / bench_regression.py, which
read the port's rows as they read the JAX package's.

Usage:
  python scripts/bench_execute_torch.py cases.json [--out results.jsonl] [-v]
"""

from __future__ import annotations

import argparse
import json
import shlex
import subprocess
import sys


def main():
    p = argparse.ArgumentParser()
    p.add_argument("cases", help=".json file with a 'cmdlines' array")
    p.add_argument("--out", default=None, help="JSONL output path")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args()

    with open(args.cases) as f:
        spec = json.load(f)
    cmdlines = spec["cmdlines"]

    fails = 0
    for line in cmdlines:
        cmd = [sys.executable, "-m", "rocalution_tpu_torch.bench_cli"]
        cmd += shlex.split(line)
        if args.out:
            cmd += ["--out", args.out]
        if args.verbose:
            print("+", " ".join(cmd), file=sys.stderr, flush=True)
        r = subprocess.run(cmd, text=True, capture_output=True)
        sys.stdout.write(r.stdout)
        sys.stdout.flush()
        if r.returncode != 0:
            fails += 1
            print(f"[FAIL rc={r.returncode}] {line}\n{r.stderr[-1000:]}",
                  file=sys.stderr, flush=True)
    print(json.dumps({"executed": len(cmdlines), "failed": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
