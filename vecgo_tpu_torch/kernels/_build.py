"""Build and load the port's CUDA kernels.

At first use, nvcc compiles every `vecgo_tpu_torch/csrc/*.cu` into an object
file, one nvcc process per source, all started together, and links them
into one shared library with a plain C interface, which `ctypes` loads. The
library lands in `build/vecgo_tpu_torch/` at the root of the checkout, named
by a hash of the sources, the headers they share (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged tree is
reused. A failed build raises with nvcc's stderr; ptxas's register, spill
and shared-memory report of each source is kept in `BUILD_LOG` and beside
the library (`<library>.ptxas.json`), where a process that reuses the
library reads it. Nothing here runs at import time: the CPU tests import
every module of the port on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vecgo_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None  # the loaded library, shared by every wrapper in the process
# ptxas's report (registers, shared memory, spills, warnings) per source of the library.
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vecgo_scan_topk.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.vecgo_scan_topk.restype = i
    lib.vecgo_scan_topk_plan.argtypes = [i, i, i, i, p]
    lib.vecgo_scan_topk_plan.restype = i
    lib.vecgo_scan_columns.argtypes = [p, i, i, i, p, p, i, i, i, i, i, p, p, p, p, p, p, p, p,
                                       p, p]
    lib.vecgo_scan_columns.restype = i
    lib.vecgo_scan_columns_plan.argtypes = [i, i, p]
    lib.vecgo_scan_columns_plan.restype = i
    lib.vecgo_coded_group_scan.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.vecgo_coded_group_scan.restype = i
    lib.vecgo_coded_group_scan_pooled.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                                  p, p, p, p, p]
    lib.vecgo_coded_group_scan_pooled.restype = i
    lib.vecgo_coded_group_scan_layout.argtypes = [i, i, i, i, p, p, p]
    lib.vecgo_coded_group_scan_layout.restype = i
    lib.vecgo_coded_group_scan_prepare.argtypes = []
    lib.vecgo_coded_group_scan_prepare.restype = i
    lib.vecgo_cuda_error_string.argtypes = [i]
    lib.vecgo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + sorted(CSRC.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out = BUILD_DIR / f"libvecgo_kernels_{h.hexdigest()[:16]}.so"
        log = out.with_suffix(".ptxas.json")
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
            procs = [
                (src, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                ))
                for src, obj in zip(sources, objs)
            ]
            for src, proc in procs:
                _, err = proc.communicate()
                BUILD_LOG[src.name] = err
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{err}")
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
            tmp_log = log.with_suffix(f".{os.getpid()}.tmp")
            tmp_log.write_text(json.dumps({src.name: BUILD_LOG[src.name] for src in sources}))
            os.replace(tmp_log, log)
            os.replace(tmp, out)
            for obj in objs:
                obj.unlink()
        elif log.exists():
            BUILD_LOG.update(json.loads(log.read_text()))
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if code != 0:
        msg = library().vecgo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
