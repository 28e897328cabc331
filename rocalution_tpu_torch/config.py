"""Global configuration for rocalution_tpu_torch.

Counterpart of rocalution_tpu/config.py: a small typed config of dtype
policy, verbosity, the debug and call-tracing switches, the default device
and the WJD auto-attach switch. The environment variables are the port's
own (ROCALUTION_TPU_TORCH_VERBOSE, _DEBUG, _LOG), read when the config is
made; the JAX package's are not read. The default
device is the card ("cuda"). It is not probed and does not give way to the
CPU: without a card a constructor raises torch's own error unless the
caller passes ``device="cpu"`` or calls ``set_default_device("cpu")``.
Importing the package makes no tensor, so it needs no card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Config:
    """Runtime configuration snapshot."""

    # rocALUTION defaults to double precision everywhere; so does the port.
    default_dtype: torch.dtype = torch.float64
    # Index dtype. rocALUTION: LocalType=int32 by default
    # (src/utils/types.hpp.in); the formats keep int32 indices.
    index_dtype: torch.dtype = torch.int32
    # Verbosity: 0 = silent, 1 = informational notices and `info()`,
    # higher levels for `log_verbose` (reference: VERBOSE_LEVEL def.hpp:28).
    verbose: int = dataclasses.field(default_factory=lambda: int(
        os.environ.get("ROCALUTION_TPU_TORCH_VERBOSE", "1")))
    # DEBUG_MODE analog (src/utils/def.hpp:33-36): a solver checks its
    # matrix and right-hand side (utils/validate.py) on entry.
    debug: bool = dataclasses.field(default_factory=lambda: os.environ.get(
        "ROCALUTION_TPU_TORCH_DEBUG", "0") == "1")
    # File that `log_debug` appends one line a traced call to (reference:
    # src/utils/log.hpp); None = no tracing.
    log_file: Optional[str] = dataclasses.field(
        default_factory=lambda: os.environ.get("ROCALUTION_TPU_TORCH_LOG")
        or None)
    # Device that constructors use when none is given: the card.
    default_device: torch.device = torch.device("cuda")
    # Auto-attach the WJD fast-apply representation when a CSR operand
    # reaches a solver. None = decide by the operand: on when its tensors
    # live on CUDA, where the hand-written WJD kernels serve the apply.
    # `set_auto_wjd` is the only switch.
    auto_wjd: Optional[bool] = None


_config = Config()


def get_config() -> Config:
    return _config


def set_verbose(level: int) -> None:
    _config.verbose = int(level)


def set_debug(flag: bool) -> None:
    _config.debug = bool(flag)


def index_dtype() -> torch.dtype:
    return _config.index_dtype


def default_dtype() -> torch.dtype:
    return _config.default_dtype


def set_default_dtype(dtype) -> None:
    _config.default_dtype = torch_dtype(dtype)


def default_device() -> torch.device:
    return _config.default_device


def set_default_device(device) -> None:
    _config.default_device = torch.device(device)


def set_auto_wjd(flag: Optional[bool]) -> None:
    """Force WJD auto-attach on/off (None = on for CUDA operands)."""
    _config.auto_wjd = flag


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)


_NP_OF_TORCH = {
    torch.float64: np.dtype(np.float64),
    torch.float32: np.dtype(np.float32),
    torch.complex128: np.dtype(np.complex128),
    torch.complex64: np.dtype(np.complex64),
    torch.int64: np.dtype(np.int64),
    torch.int32: np.dtype(np.int32),
}


def numpy_dtype(dtype=None) -> np.dtype:
    """numpy dtype of a torch or numpy dtype (None = the default dtype)."""
    if dtype is None:
        dtype = default_dtype()
    if isinstance(dtype, torch.dtype):
        return _NP_OF_TORCH[dtype]
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    np_dt = np.dtype(dtype)
    for t, n in _NP_OF_TORCH.items():
        if n == np_dt:
            return t
    raise TypeError(f"unsupported dtype {np_dt}")
