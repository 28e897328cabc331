"""Run one cell of BENCHMARK.json once and print its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by its name in BENCHMARK.json, under the benchmark's directory
(the first of `paths`):

- ``BENCHMARK.json``'s configuration entry names its file, which names its
  generator, ``operators/<generator>.py`` (``build(config) -> arrays``);
- ``traffic/<traffic>.json`` holds the mix's parameters, and its ``kind``
  names the code that drives it, ``streams/<kind>.py``;
- ``workloads/<cell>.json`` holds the cell's sample size and the limits
  of the numbers that decide ``correct``;
- ``metrics/<metric>.py`` reads one metric (``read(run) -> float|None``).

A stream module has ``setup(run)``, ``window(run, state, seconds)``,
``traced(run, state, tracer)``, ``release(run, state)`` and
``check(run) -> [readings of each answer compared]``. The inputs it
draws from --seed stay on ``run.inputs`` and the answers it offers on
``run.sample``; ``release`` frees the program's state before ``check``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "rocalution_tpu")
ROOT = Path(__file__).resolve().parent.parent


def loaded_forbidden() -> list:
    """Top-level names in sys.modules that the port's runs may not load,
    compared whole: `rocalution_tpu_torch` is not `rocalution_tpu`."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of --seed, the same on every machine."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


class Reservoir:
    """A uniform sample, drawn from a seed, of the answers offered, and
    always the last one. An answer is a tuple; a kept tensor is copied
    into a buffer reserved at set-up (`reserve`), so that holding the
    sample neither allocates in the window nor keeps the program's own
    tensors alive. The last answer is held as it came."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size
        self.kept = []
        self.seen = 0
        self.last = None
        self.buffers = []

    def reserve(self, like) -> None:
        """A buffer shaped as `like` for each answer the sample keeps."""
        self.buffers = [like.new_empty(like.shape) for _ in range(self.size)]

    def _copy(self, slot: int, answer):
        def keep(v):
            if hasattr(v, "copy_") and slot < len(self.buffers) \
                    and tuple(v.shape) == tuple(self.buffers[slot].shape):
                return self.buffers[slot].copy_(v)
            return v.clone() if hasattr(v, "clone") else v
        return tuple(keep(v) for v in answer)

    def offer(self, index: int, answer) -> None:
        self.last = (index, answer)
        if len(self.kept) < self.size:
            self.kept.append((index, self._copy(len(self.kept), answer)))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (index, self._copy(j, answer))
        self.seen += 1

    def items(self) -> list:
        out = sorted(self.kept, key=lambda kv: kv[0])
        if self.last is not None and self.last[0] not in {i for i, _ in out}:
            out.append(self.last)
        return out


def load_module(path: Path, name: str):
    """A plug-in module from its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: Path, cell: str) -> SimpleNamespace:
    """Everything BENCHMARK.json and the benchmark's files say of a cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench_dir = root / bench["paths"][0]
    entries = [w for w in bench["workloads"] if w["name"] == cell]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
    entry = entries[0]
    cfg = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    spec = json.loads((bench_dir / "workloads" / f"{cell}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, cell, e2e_names)]
    return SimpleNamespace(root=root, bench_dir=bench_dir, name=cell,
                           entry=entry, config_file=root / cfg["file"],
                           config=config, traffic=traffic, spec=spec,
                           end_to_end=e2e, per_layer=per_layer)


def build_operator(cell) -> dict:
    """The configuration's operator arrays, from its generator; kept in
    ``_cache/`` inside the benchmark's directory where the configuration
    asks for it, keyed by the configuration file and the generator."""
    import numpy as np

    gen = cell.bench_dir / "operators" / f"{cell.config['generator']}.py"
    if not cell.config.get("cache"):
        return load_module(gen, "bench_operator").build(cell.config)
    key = hashlib.sha256(cell.config_file.read_bytes()
                         + gen.read_bytes()).hexdigest()[:16]
    path = cell.bench_dir / "_cache" / f"{cell.config['name']}-{key}.npz"
    if path.is_file():
        with np.load(path) as z:
            return {"indptr": z["indptr"], "indices": z["indices"],
                    "data": z["data"], "shape": tuple(int(v) for v in
                                                      z["shape"])}
    op = load_module(gen, "bench_operator").build(cell.config)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, indptr=op["indptr"], indices=op["indices"],
             data=op["data"], shape=np.asarray(op["shape"]))
    tmp.replace(path)
    return op


def limit_of(value, cell) -> float:
    """A limit as a number, or by the name of a key of the traffic mix or
    the configuration that states it (a solve's rel_tol)."""
    if isinstance(value, str):
        return float(cell.traffic.get(value, cell.config.get(value)))
    return float(value)


def judge(readings: list, cell) -> tuple:
    """(worst reading and limit of each number, answers over a limit)."""
    from bench_h100.reference.checks import worst

    limits = {k: limit_of(v["limit"], cell)
              for k, v in cell.spec["checks"].items()}
    checks = {k: {"value": worst(r[k] for r in readings), "limit": lim}
              for k, lim in limits.items()}
    bad = sum(1 for r in readings
              if any(not float(r[k]) <= lim for k, lim in limits.items()))
    return checks, bad


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def mark(run, phase: str) -> None:
    """Close a phase of set-up on the host clock (logged, not a metric)."""
    run.marks.append((phase, time.perf_counter()))


def new_run(cell, seed: int, device: str, rt=None):
    """A run's namespace with the operator built, and its stream."""
    t = time.perf_counter()
    import torch

    if rt is None:
        import rocalution_tpu_torch as rt
    run = SimpleNamespace(
        cell=cell, seed=int(seed), device=device, torch=torch, rt=rt,
        config=cell.config, traffic=cell.traffic, window=None, trace=None,
        counters={}, plan_s=None, host_call_us=None, marks=[("start", t)])
    mark(run, "imports")
    if device.startswith("cuda"):
        torch.zeros(1, device=device)
        mark(run, "cuda_init")
    new_sample(run)
    run.operator = build_operator(cell)
    mark(run, "operator")
    shape = run.operator["shape"]
    run.n_rows, run.n_cols = int(shape[0]), int(shape[1])
    run.nnz = int(len(run.operator["data"]))
    stream = load_module(cell.bench_dir / "streams"
                         / f"{cell.traffic['kind']}.py", "bench_stream")
    return run, stream


def new_sample(run) -> None:
    """An empty sample of answers, drawn from the run's seed."""
    run.sample = Reservoir(derived_seed(run.seed, "sample"),
                           int(run.cell.spec["sample"]))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, chips: int = 1, rt=None, log=None) -> dict:
    """Set up, measure or trace, check; return the result's fields (and
    the set-up, planning and check seconds in `log`, where given)."""
    run, stream = new_run(cell, seed, device, rt)
    torch = run.torch
    on_card = device.startswith("cuda")
    state = stream.setup(run)
    if on_card:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0
    if trace:
        from bench_h100.tracing import Tracer

        tracer = Tracer(torch)
        stream.traced(run, state, tracer)
        run.trace = tracer.summary
    else:
        stream.window(run, state, seconds)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
           if on_card else 0}
    if trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    stream.release(run, state)
    del state
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = stream.check(run)
    run.check_s = time.perf_counter() - t_check
    checks, bad = judge(readings, cell)
    attempted = run.window["count"] if run.window else run.counters["units"]
    failed = run.counters.get("failed", 0) + bad
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py",
                          "bench_metric")
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    found = loaded_forbidden()
    if found:
        raise ForbiddenImport(found)
    correct = (failed == 0 and attempted > 0 and bool(readings)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in run.trace["top_device_ops"]],
            "idle_gaps": [[k, v] for k, v in run.trace["idle_gaps"]]}
    out["checks"] = checks
    if log is not None:
        log.update(setup_s=run.setup_s, check_s=run.check_s,
                   main_s=run.marks[0][1] - t0)
        log.update((f"{b[0]}_s", b[1] - a[1])
                   for a, b in zip(run.marks, run.marks[1:]))
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules loaded in the run's process: "
                         + ", ".join(names))
        self.names = names


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float, root: Path = ROOT) -> int:
    args = parse(argv)
    cell = load_cell(root, args.workload)
    chips = int(cell.entry["chips"])
    t = time.perf_counter()
    import torch

    log = {"python_s": t - t0, "torch_import_s": time.perf_counter() - t}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t0, chips, log=log)
    except ForbiddenImport as e:
        print(f"bench_h100: {e}", file=sys.stderr)
        return 4
    print(f"bench_h100: card {power_limit()}; "
          + ", ".join(f"{k} {v!r}" for k, v in log.items()), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
