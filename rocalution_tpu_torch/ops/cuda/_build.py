"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``rocalution_tpu_torch/_build/``, keyed by a
hash of the source and the flags, then loaded with ``ctypes``. The first
load builds all sources at once, one ``nvcc`` process each. Nothing is
built when a module is imported: only a launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA home PyTorch finds."""
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_all() -> None:
    """Build every ``csrc/*.cu`` whose library is missing: one nvcc per
    source, all started together. Each compiles to a temporary name that
    is renamed at the end, so a concurrent or cut build never leaves a
    partial library under the final name."""
    missing = [src.stem for src in sorted(CSRC.glob("*.cu"))
               if not library_path(src.stem).exists()]
    if not missing:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in missing:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}:\n{out}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library, building the package's sources
    first where a library is missing; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
