"""Segment container format: named ndarray sections + JSON meta + CRC32.

Reference analogue: the DiskANN/Flat segment file layouts (diskann/format.go:18-50
512-B header with section offsets; flat/format.go) and CRC32C integrity
(internal/hash/crc32c.go, format.go:85-119). Our layout:

    magic "VGT1" | u32 flags | u64 header_len | header JSON | padding | sections

header JSON: {"meta": {...}, "sections": [{name, dtype, shape, offset, nbytes,
crc32}]}. Sections are 64-byte aligned raw little-endian ndarray bytes, each
integrity-checked with CRC32 (zlib, C-speed on host). Adversarial bytes must
never crash the reader (reference: engine/fuzz_test.go FuzzFlatSegmentOpen) —
all decode errors raise ErrCorrupt.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from vecgo_tpu_torch.errors import ErrCorrupt

MAGIC = b"VGT1"
_ALIGN = 64
_MAX_HEADER = 1 << 30


def pack_container(
    meta: dict, sections: Dict[str, np.ndarray], compress: Optional[str] = None
) -> bytes:
    """Serialize meta + sections to container bytes.

    compress="lz4" stores each section LZ4-block-compressed via the native
    codec (storage/lz4.py — the reference ships LZ4/ZSTD block compression,
    diskann/compression.go:15-65); "deflate" = zlib level 1. If the native
    codec can't build, "lz4" degrades to deflate at pack time (readability
    of existing lz4 segments is preserved by a pure-Python decoder).
    Checksums cover the stored (compressed) bytes.
    """
    entries = []
    # Compute layout in two passes: header size depends on offsets, offsets on
    # header size. Serialize entries with placeholder offsets first to get a
    # stable header length (offsets rendered fixed-width).
    names = sorted(sections)
    payloads = {}
    for name in names:
        a = np.ascontiguousarray(sections[name])
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        raw = a.tobytes()
        entry = {
            "name": name,
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "offset": 0,
        }
        eff = compress
        if eff == "lz4":
            from vecgo_tpu_torch.storage import lz4 as _lz4

            if not _lz4.available():
                eff = "deflate"  # degrade gracefully; logged by lz4.py
        elif eff == "zstd":
            from vecgo_tpu_torch.storage import zstd as _zstd

            if not _zstd.available():
                eff = "deflate"  # degrade gracefully; logged by zstd.py
        if eff == "lz4":
            from vecgo_tpu_torch.storage import lz4 as _lz4

            stored = _lz4.compress(raw)
            if len(stored) < len(raw):
                entry["compression"] = "lz4"
                entry["raw_nbytes"] = len(raw)
            else:
                stored = raw
        elif eff == "zstd":
            from vecgo_tpu_torch.storage import zstd as _zstd

            stored = _zstd.compress(raw)
            if len(stored) < len(raw):
                entry["compression"] = "zstd"
                entry["raw_nbytes"] = len(raw)
            else:
                stored = raw
        elif eff == "deflate":
            stored = zlib.compress(raw, 1)
            if len(stored) < len(raw):
                entry["compression"] = "deflate"
                entry["raw_nbytes"] = len(raw)
            else:
                stored = raw
        elif eff in (None, "", "none"):
            stored = raw
        else:
            raise ValueError(f"unknown compression {compress!r}")
        entry["nbytes"] = len(stored)
        entry["crc32"] = zlib.crc32(stored) & 0xFFFFFFFF
        payloads[name] = stored
        entries.append(entry)

    def render(entries):
        return json.dumps({"meta": meta, "sections": entries}).encode()

    header = render(entries)
    base = 16 + len(header)
    # Offsets change header length (digit count); iterate to fixed point.
    for _ in range(8):
        off = _align(base)
        for e in entries:
            e["offset"] = off
            off = _align(off + e["nbytes"])
        new_header = render(entries)
        if len(new_header) == len(header):
            header = new_header
            break
        header = new_header
        base = 16 + len(header)
    else:
        raise RuntimeError("container header failed to converge")

    out = io.BytesIO()
    out.write(MAGIC)
    out.write(struct.pack("<IQ", 0, len(header)))
    out.write(header)
    for name, e in zip(names, entries):
        pos = out.tell()
        out.write(b"\0" * (e["offset"] - pos))
        out.write(payloads[name])
    return out.getvalue()


def _align(x: int) -> int:
    return (x + _ALIGN - 1) // _ALIGN * _ALIGN


def parse_header(data) -> Tuple[dict, list]:
    if len(data) < 16 or bytes(data[:4]) != MAGIC:
        raise ErrCorrupt("bad magic")
    try:
        _, hlen = struct.unpack("<IQ", data[4:16])
    except struct.error as e:
        raise ErrCorrupt(f"bad fixed header: {e}")
    if hlen > _MAX_HEADER or 16 + hlen > len(data):
        raise ErrCorrupt("header length out of range")
    try:
        header = json.loads(bytes(data[16 : 16 + hlen]))
        meta = header["meta"]
        entries = header["sections"]
        assert isinstance(entries, list)
    except Exception as e:
        raise ErrCorrupt(f"bad header json: {e}")
    return meta, entries


def _decode_section(e: dict, raw, verify_checksum: bool, copy: bool) -> np.ndarray:
    """Decode one section payload (shared by unpack_container / LazyContainer)."""
    name = e.get("name")
    nbytes = len(raw)
    if verify_checksum and (zlib.crc32(raw) & 0xFFFFFFFF) != e["crc32"]:
        raise ErrCorrupt(f"section {name} checksum mismatch")
    if e.get("compression") == "deflate":
        raw = zlib.decompress(bytes(raw))
        nbytes = len(raw)
        if nbytes != int(e.get("raw_nbytes", -1)):
            raise ErrCorrupt(f"section {name} decompressed size mismatch")
    elif e.get("compression") == "lz4":
        from vecgo_tpu_torch.storage import lz4 as _lz4

        try:
            raw = _lz4.decompress(bytes(raw), int(e.get("raw_nbytes", -1)))
        except ValueError as ex:
            raise ErrCorrupt(f"section {name} lz4 decode failed: {ex}")
        nbytes = len(raw)
    elif e.get("compression") == "zstd":
        from vecgo_tpu_torch.storage import zstd as _zstd

        try:
            raw = _zstd.decompress(bytes(raw), int(e.get("raw_nbytes", -1)))
        except ValueError as ex:
            raise ErrCorrupt(f"section {name} zstd decode failed: {ex}")
        nbytes = len(raw)
    elif e.get("compression"):
        raise ErrCorrupt(f"section {name}: unknown compression")
    dtype = np.dtype(e["dtype"])
    shape = tuple(int(s) for s in e["shape"])
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
    if any(s < 0 for s in shape) or expect != nbytes:
        raise ErrCorrupt(f"section {name} shape/nbytes mismatch")
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    return arr.copy() if copy else arr


class LazyContainer:
    """Header-parsed handle over a stored blob: sections load ON DEMAND via
    ranged reads — opening a remote segment costs O(header + touched
    sections), not O(object) (reference: diskann lazy block reads
    segment.go:1151 through the (file, offset)-keyed cache types.go:22-43).
    """

    def __init__(self, store, name: str, verify_checksum: bool = True):
        self.store = store
        self.name = name
        self.verify = verify_checksum
        head = store.get_range(name, 0, 16)
        if len(head) < 16 or bytes(head[:4]) != MAGIC:
            raise ErrCorrupt("bad magic")
        try:
            _, hlen = struct.unpack("<IQ", bytes(head[4:16]))
        except struct.error as e:
            raise ErrCorrupt(f"bad fixed header: {e}")
        if hlen > _MAX_HEADER:
            raise ErrCorrupt("header length out of range")
        try:
            header = json.loads(store.get_range(name, 16, hlen))
            self.meta = header["meta"]
            entries = header["sections"]
            assert isinstance(entries, list)
            self.entries = {e["name"]: e for e in entries}
        except ErrCorrupt:
            raise
        except Exception as e:
            raise ErrCorrupt(f"bad header json: {e}")

    def has(self, name: str) -> bool:
        return name in self.entries

    def names(self):
        return list(self.entries)

    def load(self, name: str) -> np.ndarray:
        """One ranged read + decode of a single section."""
        try:
            e = self.entries[name]
            off, nbytes = int(e["offset"]), int(e["nbytes"])
            if off < 0 or nbytes < 0:
                raise ErrCorrupt(f"section {name} out of range")
            raw = self.store.get_range(self.name, off, nbytes)
            if len(raw) != nbytes:
                raise ErrCorrupt(f"section {name} truncated")
            return _decode_section(e, raw, self.verify, copy=False)
        except (ErrCorrupt, KeyError):
            raise
        except Exception as ex:
            raise ErrCorrupt(f"section decode failed: {ex}")

    def load_rows(self, name: str, row0: int, row1: int) -> np.ndarray:
        """Ranged read of leading-axis rows [row0, row1) of one section —
        O(rows) bytes from the store, not O(section) (the reference's block
        read unit, diskann/segment.go:1151). Only uncompressed sections can
        be sliced by offset; compressed ones fall back to a full section
        load + slice. Partial reads skip the section CRC (it covers the whole
        payload) — integrity there comes from the store tier, as with the
        reference's block reads."""
        try:
            e = self.entries[name]
        except KeyError:
            raise
        shape = tuple(int(s) for s in e["shape"])
        if not shape:
            raise ErrCorrupt(f"section {name} is scalar; load_rows needs rows")
        row0 = max(0, int(row0))
        row1 = min(shape[0], int(row1))
        if row1 <= row0:
            return np.zeros((0,) + shape[1:], np.dtype(e["dtype"]))
        if e.get("compression"):
            return self.load(name)[row0:row1]
        try:
            dtype = np.dtype(e["dtype"])
            rowbytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
            off = int(e["offset"]) + row0 * rowbytes
            nbytes = (row1 - row0) * rowbytes
            raw = self.store.get_range(self.name, off, nbytes)
            if len(raw) != nbytes:
                raise ErrCorrupt(f"section {name} rows truncated")
            return np.frombuffer(raw, dtype=dtype).reshape(
                (row1 - row0,) + shape[1:]
            )
        except ErrCorrupt:
            raise
        except Exception as ex:
            raise ErrCorrupt(f"section row read failed: {ex}")

    def load_many(self, names=None, exclude_prefixes: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
        out = {}
        for name in self.entries:
            if names is not None and name not in names:
                continue
            if any(name.startswith(p) for p in exclude_prefixes):
                continue
            out[name] = self.load(name)
        return out


def unpack_container(
    data,
    verify_checksum: bool = True,
    only: Optional[set] = None,
    copy: bool = True,
) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Parse container bytes -> (meta, {name: ndarray}). Never panics: raises
    ErrCorrupt on malformed input.

    `data` may be bytes or a buffer (np.memmap for zero-copy local opens);
    copy=False returns arrays aliasing the buffer (read-only)."""
    if isinstance(data, np.ndarray):
        data = memoryview(data)
    meta, entries = parse_header(data)
    sections = {}
    for e in entries:
        try:
            name = e["name"]
            if only is not None and name not in only:
                continue
            off, nbytes = int(e["offset"]), int(e["nbytes"])
            if off < 0 or nbytes < 0 or off + nbytes > len(data):
                raise ErrCorrupt(f"section {name} out of range")
            raw = data[off : off + nbytes]
            sections[name] = _decode_section(e, raw, verify_checksum, copy)
        except ErrCorrupt:
            raise
        except Exception as ex:
            raise ErrCorrupt(f"section decode failed: {ex}")
    return meta, sections
