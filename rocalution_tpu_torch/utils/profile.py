"""Profiling hooks.

Counterpart of rocalution_tpu/utils/profile.py, over torch.profiler in
place of jax.profiler: `with profile(logdir):` records the enclosed block
(host operators, and the card's kernels where the default device is the
card) and writes a Chrome trace into `logdir`; `annotate(name)` labels a
region so solver phases can be found in the trace.

Usage:
    with rt.utils.profile.profile("trace_dir"):
        x, info = rt.cg(A, b, M=M, rel_tol=1e-8)
    # then open latest_trace_file("trace_dir") in chrome://tracing or
    # https://ui.perfetto.dev
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Iterator, Optional

import torch

from ..config import default_device

TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def profile(logdir: str = "rocalution_tpu_torch_trace",
            enabled: bool = True) -> Iterator[Optional[str]]:
    """Record a torch.profiler trace of the enclosed block into `logdir`.

    Yields the log directory (or None when disabled). CUDA activity is
    recorded where the default device is the card; pending device work
    is waited for before the trace is written."""
    if not enabled:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    on_card = default_device().type == "cuda"
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
        if on_card:
            torch.cuda.synchronize()
    name = f"trace_{os.getpid()}_{time.time_ns()}{TRACE_SUFFIX}"
    prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """Label a region in the profiler timeline:

        with annotate("amg-vcycle"):
            e = M(r)
    """
    return torch.profiler.record_function(name)


def latest_trace_file(logdir: str) -> Optional[str]:
    """Path of the newest trace that `profile` wrote under `logdir`."""
    hits = glob.glob(os.path.join(logdir, "**", "*" + TRACE_SUFFIX),
                     recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None
