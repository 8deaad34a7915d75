"""Host-memory primitives for the bulk-ingest hot path.

Big fresh numpy allocations pay one minor page fault per 4 KiB page on
first touch. On ordinary hosts that is ~25% of a large memcpy's cost; on
ballooned/para-virtualized VMs it can be catastrophic (measured on the dev
box in its degraded regime: 256 MB first-touch through np.empty at
11-17 MB/s = ~240 us/fault, while writes to already-touched pages run at
2.8-9.5 GB/s). Which backing escapes the tax is host-dependent:

- private anonymous mmap + madvise(MADV_HUGEPAGE): real anon THP on
  madvise-mode kernels (512x fewer faults) — the right answer on healthy
  prod hosts;
- anonymous *shared* (shmem) mmap: ignores MADV_HUGEPAGE under the default
  shmem_enabled=never, yet measured 1.3 GB/s on the dev box while anon
  private faults were throttled to 11 MB/s (the hypervisor throttles the
  two paths differently);
- plain np.empty: fastest when the host is healthy (no madvise syscall, no
  THP compaction stalls).

`huge_empty` therefore SELF-CALIBRATES: on the first slab-sized allocation
it touches one small probe buffer per backend and locks in the fastest for
the process lifetime (override with VECGO_HOSTMEM=private|shared|plain).
The mmap object rides along as the array's base, so lifetime is the
array's lifetime.

`fill_arange` / `all_finite` are the allocation-free twins of np.arange
and np.isfinite(x).all() — both otherwise materialize full-size temporaries
(pure page-fault cost) on every bulk batch.

Reference parity note: the Go reference gets this for free from its
long-lived arena allocator (internal/arena/arena.go) — slabs there are
allocated once and reused. This module is the TPU-host analogue.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import sys
import time

import numpy as np

_MADV_HUGEPAGE = 14
_HUGE_MIN_BYTES = 2 << 20  # below one hugepage, np.empty is fine
_PROBE_BYTES = 8 << 20  # per-backend calibration probe

_libc = None
if sys.platform.startswith("linux"):
    try:
        _libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:  # pragma: no cover - exotic libc
        _libc = None


def _alloc_private(nbytes: int) -> np.ndarray:
    # MAP_PRIVATE | MAP_ANONYMOUS, NOT the mmap default MAP_SHARED: shmem
    # ignores MADV_HUGEPAGE under shmem_enabled=never; private anonymous
    # mappings honor the madvise-mode anon THP policy.
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    _libc.madvise(
        ctypes.c_void_p(addr), ctypes.c_size_t(nbytes), _MADV_HUGEPAGE
    )  # advisory: ignore failure, the mapping still works
    return np.frombuffer(buf, np.uint8)


def _alloc_shared(nbytes: int) -> np.ndarray:
    return np.frombuffer(mmap.mmap(-1, nbytes), np.uint8)


def _alloc_plain(nbytes: int) -> np.ndarray:
    return np.empty(nbytes, np.uint8)


_BACKENDS = {"private": _alloc_private, "shared": _alloc_shared, "plain": _alloc_plain}
_mode: str | None = None


def _probe(name: str) -> float:
    """First-touch MB/s of one backend (one write per 4 KiB page)."""
    try:
        a = _BACKENDS[name](_PROBE_BYTES)
        t0 = time.perf_counter()
        a[::4096] = 1
        return (_PROBE_BYTES >> 20) / max(time.perf_counter() - t0, 1e-9)
    except (ValueError, OSError):  # pragma: no cover
        return 0.0


_HEALTHY_MBPS = 300.0  # plain np.empty above this -> host fault path is fine


def _calibrate() -> str:
    """Pick the first-touch backing for THIS host, once per process.

    Cascade, not a race: plain np.empty wins outright on healthy hosts (no
    mmap syscall per slab, no THP compaction stalls — measured 5-6 GB/s).
    Only when the host's anonymous-fault path is throttled (the dev box's
    degraded regime: 11-17 MB/s) do the mmap backings matter; shmem escapes
    that throttle there (~1-1.8 GB/s in BOTH regimes), while private+THP
    pays a multi-second hugepage-compaction stall on its first big
    allocation — last resort only."""
    forced = os.environ.get("VECGO_HOSTMEM", "")
    if forced in _BACKENDS:
        return forced
    plain = _probe("plain")
    if plain >= _HEALTHY_MBPS or _libc is None:
        return "plain"
    shared = _probe("shared")
    if shared > 2.0 * plain:
        return "shared"
    private = _probe("private")
    return max(
        (("plain", plain), ("shared", shared), ("private", private)),
        key=lambda kv: kv[1],
    )[0]


def huge_empty(shape, dtype=np.float32) -> np.ndarray:
    """np.empty with the process-calibrated fast first-touch backing.

    Contents are uninitialized (like np.empty). Small sizes skip straight
    to np.empty."""
    global _mode
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if nbytes < _HUGE_MIN_BYTES:
        return np.empty(shape, dtype)
    if _mode is None:
        _mode = _calibrate()
    try:
        flat = _BACKENDS[_mode](nbytes)
    except (ValueError, OSError):  # pragma: no cover - mmap exhaustion
        return np.empty(shape, dtype)
    return flat.view(dtype).reshape(shape)


def huge_empty_like(x: np.ndarray) -> np.ndarray:
    return huge_empty(x.shape, x.dtype)


_IOTA_CHUNK = 1 << 20
_iota_tpl = None


def fill_arange(out: np.ndarray, start: int) -> np.ndarray:
    """out[:] = arange(start, start + len(out)) with no temporary.

    np.arange allocates fresh pages for its result (8 MB per million int64
    rows — pure page-fault cost on the bulk path); this writes the sequence
    straight into the destination from a small reusable iota template."""
    global _iota_tpl
    n = out.shape[0]
    if _iota_tpl is None:
        _iota_tpl = np.arange(_IOTA_CHUNK, dtype=np.int64)
    for i in range(0, n, _IOTA_CHUNK):
        m = min(n - i, _IOTA_CHUNK)
        np.add(_iota_tpl[:m], start + i, out=out[i : i + m], casting="unsafe")
    return out


def huge_arange(start: int, n: int, dtype=np.int64) -> np.ndarray:
    """np.arange(start, start+n) into a fast-first-touch buffer."""
    return fill_arange(huge_empty(n, dtype), start)


def all_finite(x: np.ndarray) -> bool:
    """np.isfinite(x).all() without materializing a full-size bool array.

    min/max reductions propagate NaN and saturate at +/-Inf, so two
    allocation-free passes decide finiteness exactly: NaN poisons both
    reductions, +Inf surfaces in max, -Inf in min. Measured ~4x the chunked
    isfinite scan (reductions run at raw read bandwidth; the ufunc+bool
    path writes one byte per element)."""
    if x.size == 0:
        return True
    lo = np.min(x)
    hi = np.max(x)
    return bool(np.isfinite(lo)) and bool(np.isfinite(hi))
