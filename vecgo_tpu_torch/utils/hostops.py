"""Native host-side ingest kernels (fused copy + validate) via ctypes (copy
of vecgo_tpu/utils/hostops.py; `hostops.cpp` is the JAX package's source).

At first use g++ compiles hostops.cpp into a shared library in
`build/vecgo_tpu_torch/` at the root of the checkout (git-ignored), named by
a hash of the source, the flags and the host CPU (the build targets
`-march=native`), as `kernels/_build.py` builds the CUDA sources; an
unchanged source on the same CPU is reused. This is a host fast path, not a device kernel:
where the toolchain is missing or the build fails, `available()` is False
and the callers (`utils/hostmem.all_finite`, the memtable's ingest copy) run
their numpy versions, which give the same answers.

ctypes releases the GIL for the call, so the memtable drives
copy_validate_range from a thread pool over disjoint row ranges.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("vecgo_tpu_torch")

_SRC = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "vecgo_tpu_torch"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False
_off = 0  # depth of `disabled()` blocks


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode() + _cpu_id()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libvghostops-{tag}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)  # atomic publish
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("hostops native build failed (%s); numpy fallback", e)
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as e:
        logger.warning("hostops native load failed (%s); numpy fallback", e)
        return None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.vg_copy_validate_f32.argtypes = [p, p, i64]
    lib.vg_copy_validate_f32.restype = ctypes.c_int
    lib.vg_validate_f32.argtypes = [p, i64]
    lib.vg_validate_f32.restype = ctypes.c_int
    lib.vg_fill_arange_i64.argtypes = [p, i64, i64]
    lib.vg_fill_arange_i64.restype = None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _off:
        return None
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build_and_load()
                _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


@contextlib.contextmanager
def disabled():
    """Within the block `available()` is False and the callers take their
    numpy versions (to time ingest without the native path, and to hold the
    two to the same answers)."""
    global _off
    _off += 1
    try:
        yield
    finally:
        _off -= 1


def copy_validate_range(x: np.ndarray, out: np.ndarray, a: int, b: int) -> bool:
    """Copy rows [a, b) of contiguous f32 `x` into `out`, returning False on
    any NaN/Inf. Raises RuntimeError if the native library is unavailable."""
    lib = _get()
    if lib is None:
        raise RuntimeError("hostops native library unavailable")
    n = (b - a) * x.shape[1]
    if n <= 0:
        return True
    return bool(lib.vg_copy_validate_f32(x.ctypes.data + a * x.strides[0],
                                         out.ctypes.data + a * out.strides[0], n))


def validate_range(x: np.ndarray, a: int, b: int) -> bool:
    """Finiteness-check rows [a, b) of contiguous f32 `x` (no copy)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("hostops native library unavailable")
    n = (b - a) * x.shape[1]
    if n <= 0:
        return True
    return bool(lib.vg_validate_f32(x.ctypes.data + a * x.strides[0], n))
