"""LZ4 block compression for segment sections — native C++ via ctypes.

Reference analogue: LZ4/ZSTD block compression of DiskANN sections
(upstream vecgo's internal/segment/diskann/compression.go:15-65). No Python
lz4/zstd module is assumed, so the codec is a ~200-line C++ file
(lz4codec.cpp, standard LZ4 block format) compiled once with g++ into a
cached shared library. If the toolchain is unavailable, compression falls
back to deflate at pack time (pack_container handles that), and a pure-
Python decompressor below keeps every lz4-compressed segment READABLE
anywhere — availability of g++ never gates data access.

API: compress(bytes) -> bytes, decompress(bytes, raw_n) -> bytes,
available() -> bool.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

logger = logging.getLogger("vecgo_tpu_torch")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lz4codec.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Compile lz4codec.cpp into a cached .so (keyed by source hash), load it."""
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = os.environ.get(
        "VECGO_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "vecgo_tpu_native"),
    )
    so_path = os.path.join(cache_dir, f"libvglz4-{tag}.so")
    if not os.path.exists(so_path):
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=cache_dir) as td:
                tmp_so = os.path.join(td, "libvglz4.so")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp_so],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp_so, so_path)  # atomic publish
        except Exception as e:  # noqa: BLE001 — toolchain optional
            logger.warning("lz4 native build failed (%s); falling back", e)
            return None
    try:
        lib = ctypes.CDLL(so_path)
        lib.vg_lz4_compress_bound.argtypes = [ctypes.c_int]
        lib.vg_lz4_compress_bound.restype = ctypes.c_int
        lib.vg_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.vg_lz4_compress.restype = ctypes.c_int
        lib.vg_lz4_decompress_safe.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.vg_lz4_decompress_safe.restype = ctypes.c_int
        return lib
    except OSError as e:
        logger.warning("lz4 native load failed (%s); falling back", e)
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build_and_load()
                _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


def compress(data: bytes) -> bytes:
    """LZ4 block compress. Raises RuntimeError if the native codec is
    unavailable (pack_container then falls back to deflate)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native lz4 codec unavailable")
    n = len(data)
    cap = lib.vg_lz4_compress_bound(n)
    out = ctypes.create_string_buffer(cap)
    wrote = lib.vg_lz4_compress(data, n, out, cap)
    if wrote <= 0:
        raise RuntimeError("lz4 compression failed")
    return out.raw[:wrote]


def decompress(data: bytes, raw_n: int) -> bytes:
    """Decompress an LZ4 block of known raw size. Raises ValueError on any
    malformed input (never crashes — fuzz bar, engine/fuzz_test.go)."""
    if raw_n < 0 or raw_n > (1 << 33):
        raise ValueError("lz4: bad raw size")
    lib = _get()
    if lib is not None:
        out = ctypes.create_string_buffer(max(raw_n, 1))
        wrote = lib.vg_lz4_decompress_safe(data, len(data), out, raw_n)
        if wrote != raw_n:
            raise ValueError("lz4: malformed block")
        return out.raw[:raw_n]
    return _decompress_py(data, raw_n)


def _decompress_py(data: bytes, raw_n: int) -> bytes:
    """Pure-Python LZ4 block decoder (fallback reader; ~50x slower)."""
    src = memoryview(data)
    n = len(src)
    out = bytearray()
    ip = 0
    if n == 0:
        if raw_n != 0:
            raise ValueError("lz4: malformed block")
        return b""
    while True:
        if ip >= n:
            raise ValueError("lz4: truncated")
        token = src[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ValueError("lz4: truncated")
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n or len(out) + lit > raw_n:
            raise ValueError("lz4: malformed block")
        out += src[ip : ip + lit]
        ip += lit
        if ip == n:
            if len(out) != raw_n:
                raise ValueError("lz4: size mismatch")
            return bytes(out)
        if ip + 2 > n:
            raise ValueError("lz4: truncated")
        off = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if off == 0 or off > len(out):
            raise ValueError("lz4: bad offset")
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                if ip >= n:
                    raise ValueError("lz4: truncated")
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        if len(out) + mlen > raw_n:
            raise ValueError("lz4: malformed block")
        start = len(out) - off
        for i in range(mlen):
            out.append(out[start + i])
