"""The traced stretch of a run: torch.profiler over whole solves or
products, and its reduction to device time by the benchmark's ranges.

The harness puts `record_function` ranges named ``bench.*`` around its
calls into each layer of the program. A device operation (kernel, copy,
fill) is charged to the innermost ``bench.*`` range that was open on the
host when it was launched: the profiler's Chrome trace links each one to
its launch call by a correlation id. Busy time is the union of the device
operations' intervals inside ``bench.window``; an idle gap is charged to
what the host was doing when it began (the innermost host event open on
the window's thread).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
TOP = 10


class Tracer:
    """Profiles one stretch (`window()`), then holds its `summary`."""

    def __init__(self, torch):
        self.torch = torch
        self.summary = None

    def range(self, name: str):
        return self.torch.profiler.record_function(name)

    def sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        prof_mod = self.torch.profiler
        acts = [prof_mod.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(prof_mod.ProfilerActivity.CUDA)
        prof = prof_mod.profile(activities=acts, record_shapes=False,
                                with_stack=False, profile_memory=False)
        with prof:
            self.sync()
            with self.range(WINDOW):
                yield
                self.sync()
        fd, path = tempfile.mkstemp(prefix="bench_h100_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = reduce_trace(events)


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class _Ranges:
    """Host intervals of each bench range name, for innermost lookup."""

    def __init__(self, ranges):
        self.by_name = defaultdict(list)
        for e in ranges:
            self.by_name[e["name"]].append((float(e["ts"]),
                                            float(e["ts"]) + float(e["dur"])))
        for v in self.by_name.values():
            v.sort()
        self.starts = {k: [s for s, _ in v] for k, v in self.by_name.items()}

    def innermost(self, t: float):
        best, best_len = None, None
        for name, spans in self.by_name.items():
            i = bisect.bisect_right(self.starts[name], t) - 1
            if i >= 0 and spans[i][1] >= t:
                length = spans[i][1] - spans[i][0]
                if best_len is None or length < best_len:
                    best, best_len = name, length
        return best


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(host_events, times):
    """For each time (ascending), the name of the innermost host event
    open then, or "host" where none is: one sweep over events nested as
    a call tree."""
    evs = sorted(host_events, key=lambda e: (float(e["ts"]),
                                             -float(e["dur"])))
    names, stack, j = [], [], 0
    for t in times:
        while j < len(evs) and float(evs[j]["ts"]) <= t:
            e = evs[j]
            s = float(e["ts"])
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((s + float(e["dur"]), e["name"]))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        names.append(stack[-1][1] if stack else "host")
    return names


def reduce_trace(events) -> dict:
    """Device seconds and operation counts by innermost bench range, the
    count of each range, busy and window seconds, the top device
    operations and the idle gaps by host activity."""
    ranges = [e for e in _complete(events, ("user_annotation",))
              if str(e.get("name", "")).startswith("bench.")]
    windows = [e for e in ranges if e["name"] == WINDOW]
    if not windows:
        raise ValueError("the trace holds no bench.window range")
    win = windows[-1]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    lookup = _Ranges(ranges)
    launch_ts = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch_ts[corr] = float(e["ts"])
    dev_s = defaultdict(float)
    dev_n = defaultdict(int)
    by_op = defaultdict(float)
    spans = []
    for e in _complete(events, DEVICE_CATS):
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < w0 or s > w1:
            continue
        t = launch_ts.get((e.get("args") or {}).get("correlation"))
        where = (lookup.innermost(t) if t is not None else None) or "none"
        dev_s[where] += d * 1e-6
        dev_n[where] += 1
        by_op[e["name"]] += d * 1e-6
        spans.append((max(s, w0), min(s + d, w1)))
    busy = _merge(spans)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    tid = win.get("tid")
    host = [e for e in _complete(events, HOST_CATS)
            if e.get("tid") == tid and e is not win
            and w0 <= float(e["ts"]) <= w1]
    idle = defaultdict(float)
    for (s, e), name in zip(gaps, _host_at(host, [s for s, _ in gaps])):
        idle[name] += (e - s) * 1e-6
    counts = {k: len(v) for k, v in lookup.by_name.items()}
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "device_ops": sum(dev_n.values()),
        "device_s_by_range": dict(dev_s),
        "device_ops_by_range": dict(dev_n),
        "range_counts": counts,
        "top_device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    }
