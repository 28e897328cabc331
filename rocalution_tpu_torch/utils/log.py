"""Call tracing and verbose logging.

Counterpart of rocalution_tpu/utils/log.py (reference: `log_debug`,
src/utils/log.hpp:67-86, every public call traced to a per-run file, and
the LOG_INFO / LOG_VERBOSE_INFO levels, :100-124). The port's solvers run
eagerly, so `log_debug` writes one line each time a solve starts (the JAX
package writes one when a call site is traced). With no log file set it
costs one attribute read.
"""

from __future__ import annotations

import os
import time

from ..config import get_config

_CONFIG = get_config()     # the one config object; set_* mutate it


def log_debug(obj, fn: str, *args) -> None:
    """Trace a public call (reference: log_debug): one line appended to
    the config's `log_file`, if one is set."""
    path = _CONFIG.log_file
    if path is None:
        return
    rep = ", ".join(repr(a)[:80] for a in args)
    with open(path, "a") as f:
        f.write(f"[{time.time():.6f}] [pid {os.getpid()}] "
                f"{type(obj).__name__ if obj is not None else '-'}::{fn}"
                f"({rep})\n")


def log_info(*msg) -> None:
    """LOG_INFO analog: an informational print at verbose >= 1."""
    if _CONFIG.verbose >= 1:
        print(*msg, flush=True)


def log_verbose(level: int, *msg) -> None:
    """LOG_VERBOSE_INFO(level) analog."""
    if _CONFIG.verbose >= level:
        print(*msg, flush=True)
