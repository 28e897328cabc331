"""Informational logging.

Counterpart of the part of rocalution_tpu/utils/log.py that this package
uses (reference: LOG_INFO, src/utils/log.hpp:100-124).
"""

from __future__ import annotations

import sys


def log_info(*msg) -> None:
    """LOG_INFO analog: a notice on standard error."""
    print(*msg, file=sys.stderr, flush=True)
