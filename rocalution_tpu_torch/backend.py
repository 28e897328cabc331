"""Backend / platform management on torch.cuda.

Counterpart of rocalution_tpu/backend.py (reference: backend_manager.cpp
`init_rocalution`, `stop_rocalution`, `info_rocalution`). PyTorch owns the
CUDA runtime; what remains is choosing the default device, waiting for the
device and describing it.
"""

from __future__ import annotations

import torch

from .config import default_device, get_config, set_default_device

_initialized = False


def init(device=None) -> None:
    """Initialize the runtime (analog of init_rocalution). ``device`` sets
    the default device; a CUDA device initializes the CUDA context."""
    global _initialized
    if device is not None:
        set_default_device(device)
    if default_device().type == "cuda":
        torch.cuda.init()
    _initialized = True


def stop() -> None:
    """Wait for pending device work (analog of stop_rocalution)."""
    global _initialized
    sync()
    _initialized = False


def sync() -> None:
    """Block until all in-flight device work completes (analog
    _rocalution_sync)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def info() -> str:
    """Platform description (analog of info_rocalution)."""
    cfg = get_config()
    dev = default_device()
    lines = [
        "rocalution_tpu_torch platform info:",
        f"  torch version    : {torch.__version__}",
        f"  torch CUDA       : {torch.version.cuda}",
        f"  default device   : {dev}",
    ]
    if dev.type == "cuda":
        lines.append(f"  device name      : {torch.cuda.get_device_name(dev)}")
        lines.append(f"  device count     : {torch.cuda.device_count()}")
    lines.append(f"  default dtype    : {cfg.default_dtype}")
    lines.append(f"  index dtype      : {cfg.index_dtype}")
    out = "\n".join(lines)
    if cfg.verbose >= 1:
        print(out)
    return out
