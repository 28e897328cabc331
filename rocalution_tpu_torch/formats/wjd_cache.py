"""On-disk WJD plan cache: pay the planning cost once per machine.

Counterpart of rocalution_tpu/formats/wjd_cache.py. Planning is a host
numpy pass (seconds at millions of rows), so the finished plan (its host
arrays and static fields) is kept, keyed by a content hash of the CSR
triplet and the planner's options. A later process reads it back from
one uncompressed ``.npz`` instead of planning again. Only host arrays are
stored, and the compact slice form is made from the plan at upload as
after a cold plan.

The port keeps its own cache, with its own ``PLAN_VERSION`` and
directory, so it never reads a plan of the JAX package's (whose f64 plans
hold f32 hi/lo planes). ``ROCALUTION_TPU_TORCH_PLAN_CACHE=0`` turns it
off; any other value is the cache directory (default
``~/.cache/rocalution_tpu_torch/wjd_plans``).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

# bump when the plan layout or the meaning of a field changes
PLAN_VERSION = 1

ENV = "ROCALUTION_TPU_TORCH_PLAN_CACHE"
_ARRAY_FIELDS = ("data", "uloc", "brow", "diag_u", "win_base", "real",
                 "dia_data", "spill_row", "spill_col", "spill_val")
_STATIC_FIELDS = ("shape", "pad_lo", "xp_len", "nnz", "group", "wlog",
                  "win_rows", "value_dtype", "kernel_mode", "dia_offsets")
# the whole directory is kept under this many bytes (oldest entries go
# first); a plan above the per-entry cap is not kept at all
_DIR_BUDGET_BYTES = 16 << 30
_MAX_ENTRY_BYTES = 4 << 30


def cache_dir() -> Optional[str]:
    env = os.environ.get(ENV)
    if env == "0":
        return None
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "rocalution_tpu_torch", "wjd_plans")


def plan_key(vals: np.ndarray, cols: np.ndarray, indptr: np.ndarray,
             shape, opts: dict) -> str:
    """Content hash of (triplet, shape, planner options, version): the JAX
    module's key (after LocalMatrix::Key, src/base/local_matrix.cpp)."""
    h = hashlib.sha256()
    h.update(f"wjd-plan-v{PLAN_VERSION}".encode())
    h.update(json.dumps(sorted((k, str(v)) for k, v in opts.items()))
             .encode())
    h.update(np.asarray(shape, np.int64).tobytes())
    h.update(str(np.asarray(vals).dtype).encode())
    h.update(np.ascontiguousarray(vals).view(np.uint8).tobytes())
    h.update(np.ascontiguousarray(cols, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(indptr, dtype=np.int64).tobytes())
    return h.hexdigest()[:32]


def load_plan(key: str) -> Optional[dict]:
    """The plan stored under `key`, or None (no cache, no entry, another
    version, or a file that does not read)."""
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            if meta.get("version") != PLAN_VERSION:
                return None
            plan = dict(meta["statics"])
            plan["shape"] = tuple(plan["shape"])
            plan["dia_offsets"] = tuple(plan.get("dia_offsets") or ())
            for f in _ARRAY_FIELDS:
                plan[f] = z[f] if f in meta["arrays"] else None
            return plan
    except Exception:
        return None          # a corrupt or partial file: plan again


def _evict(d: str, incoming: int) -> None:
    try:
        entries = []
        total = incoming
        for f in os.listdir(d):
            if not f.endswith(".npz"):
                continue
            p = os.path.join(d, f)
            st = os.stat(p)
            entries.append((st.st_mtime, st.st_size, p))
            total += st.st_size
        entries.sort()
        for _, sz, p in entries:
            if total <= _DIR_BUDGET_BYTES:
                break
            os.unlink(p)
            total -= sz
    except OSError:
        pass


def save_plan(key: str, plan: dict) -> None:
    """Store `plan` under `key`, published atomically (a reader never sees
    a partial file). A failure to write leaves the cache as it was: the
    cache only saves time, so it never fails a setup."""
    d = cache_dir()
    if d is None:
        return
    arrays = {f: np.asarray(plan[f]) for f in _ARRAY_FIELDS
              if plan.get(f) is not None}
    size = sum(a.nbytes for a in arrays.values())
    if size > _MAX_ENTRY_BYTES:
        return
    try:
        os.makedirs(d, exist_ok=True)
        _evict(d, size)
        meta = json.dumps({
            "version": PLAN_VERSION,
            "arrays": sorted(arrays),
            "statics": {k: plan[k] for k in _STATIC_FIELDS},
        }).encode()
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, meta=np.frombuffer(meta, dtype=np.uint8),
                         **arrays)
            os.replace(tmp, os.path.join(d, key + ".npz"))
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass
