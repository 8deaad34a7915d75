"""Block caches: LRU, sharded LRU, disk-backed tier + read-through store.

Reference: internal/cache (BlockCache iface types.go:22-43, lru.go:14,
64-shard sharded_lru.go:11-21, disk-backed disk.go:29-86) and
blobstore.CachingStore (caching_store.go:13-69); two-tier RAM->NVMe->S3 wiring
in cloud mode (engine.go:425-477, 4 MB blocks).

The host-side IO plane: segments opened through a CachingStore read object
blocks through RAM (and optionally local disk) so repeated opens / lazy reads
don't re-hit the object store. The device plane (HBM residency) is managed
separately by the segments themselves.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Optional, Tuple

from vecgo_tpu_torch.blobstore import BlobStore

DEFAULT_BLOCK_SIZE = 4 * 1024 * 1024  # reference: 4 MB cloud-mode blocks


class LRUCache:
    """Plain LRU keyed (name, block_index) (reference: cache/lru.go)."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._used = 0
        self._map: "collections.OrderedDict[Tuple, bytes]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[bytes]:
        with self._lock:
            val = self._map.get(key)
            if val is None:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key, value: bytes) -> None:
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._used -= len(old)
            self._map[key] = value
            self._used += len(value)
            while self._used > self.capacity and self._map:
                _, evicted = self._map.popitem(last=False)
                self._used -= len(evicted)

    def stats(self) -> dict:
        with self._lock:
            return {
                "used_bytes": self._used,
                "capacity_bytes": self.capacity,
                "entries": len(self._map),
                "hits": self.hits,
                "misses": self.misses,
            }


class ShardedLRUCache:
    """N-way sharded LRU — lock contention relief (reference: 64-shard
    sharded_lru.go, ~6x under contention)."""

    def __init__(self, capacity_bytes: int, shards: int = 64):
        self.shards = [LRUCache(max(capacity_bytes // shards, 1)) for _ in range(shards)]

    def _shard(self, key) -> LRUCache:
        h = hash(key)
        return self.shards[h % len(self.shards)]

    def get(self, key):
        return self._shard(key).get(key)

    def put(self, key, value):
        self._shard(key).put(key, value)

    def stats(self) -> dict:
        out = {"used_bytes": 0, "capacity_bytes": 0, "entries": 0, "hits": 0, "misses": 0}
        for s in self.shards:
            st = s.stats()
            for k in out:
                out[k] += st[k]
        return out


class DiskCache:
    """Disk-backed block cache with directory-scan recovery
    (reference: cache/disk.go:29-86). Keys map to content files under root."""

    def __init__(self, root: str, capacity_bytes: int):
        self.root = root
        self.capacity = capacity_bytes
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # Recover existing entries by directory scan.
        self._entries = {}
        for fn in os.listdir(root):
            p = os.path.join(root, fn)
            if os.path.isfile(p):
                self._entries[fn] = os.path.getsize(p)

    def _fname(self, key) -> str:
        return hashlib.sha1(repr(key).encode()).hexdigest()

    def get(self, key) -> Optional[bytes]:
        fn = self._fname(key)
        try:
            with open(os.path.join(self.root, fn), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def put(self, key, value: bytes) -> None:
        fn = self._fname(key)
        with self._lock:
            used = sum(self._entries.values())
            while used + len(value) > self.capacity and self._entries:
                victim, sz = next(iter(self._entries.items()))
                try:
                    os.unlink(os.path.join(self.root, victim))
                except OSError:
                    pass
                del self._entries[victim]
                used -= sz
            tmp = os.path.join(self.root, f".tmp-{fn}")
            with open(tmp, "wb") as f:
                f.write(value)
            os.replace(tmp, os.path.join(self.root, fn))
            self._entries[fn] = len(value)


class TieredCache:
    """RAM -> disk read path (reference two-tier RAM->NVMe, engine.go:425-477)."""

    def __init__(self, ram, disk: Optional[DiskCache] = None):
        self.ram = ram
        self.disk = disk

    def get(self, key):
        v = self.ram.get(key)
        if v is not None:
            return v
        if self.disk is not None:
            v = self.disk.get(key)
            if v is not None:
                self.ram.put(key, v)
        return v

    def put(self, key, value):
        self.ram.put(key, value)
        if self.disk is not None:
            self.disk.put(key, value)


class CachingStore(BlobStore):
    """Block-granular read-through BlobStore wrapper
    (reference: blobstore/caching_store.go:13-69).

    Mutable blobs are handled two ways so read replicas never see stale data:
    names matching `no_cache_prefixes` (CURRENT by default — rewritten on
    every commit) bypass the cache entirely; every other name carries a
    per-name generation in its cache key, bumped on put()/delete(), so
    superseded blocks simply age out of the LRU.
    """

    NO_CACHE_PREFIXES = ("CURRENT", "PKCURRENT")

    def __init__(
        self,
        inner: BlobStore,
        cache=None,
        block_size: int = DEFAULT_BLOCK_SIZE,
        no_cache_prefixes: Optional[Tuple[str, ...]] = None,
    ):
        self.inner = inner
        self.cache = cache or ShardedLRUCache(256 * 1024 * 1024)
        self.block_size = block_size
        self.no_cache_prefixes = (
            self.NO_CACHE_PREFIXES if no_cache_prefixes is None else no_cache_prefixes
        )
        self._gen: dict = {}
        self._gen_lock = threading.Lock()

    def _bypass(self, name: str) -> bool:
        return any(name.startswith(p) for p in self.no_cache_prefixes)

    def _generation(self, name: str) -> int:
        with self._gen_lock:
            return self._gen.get(name, 0)

    def _bump(self, name: str) -> None:
        with self._gen_lock:
            self._gen[name] = self._gen.get(name, 0) + 1

    def get(self, name: str) -> bytes:
        if self._bypass(name):
            return self.inner.get(name)
        gen = self._generation(name)
        size = self.inner.size(name)
        nblocks = (size + self.block_size - 1) // self.block_size
        parts = []
        missing = [
            bi for bi in range(nblocks) if self.cache.get((name, gen, bi)) is None
        ]
        if len(missing) == nblocks:
            # Whole object miss: one fetch, then populate blocks.
            data = self.inner.get(name)
            for bi in range(nblocks):
                self.cache.put(
                    (name, gen, bi),
                    data[bi * self.block_size : (bi + 1) * self.block_size],
                )
            return data
        for bi in range(nblocks):
            blk = self.cache.get((name, gen, bi))
            if blk is None:
                blk = self.inner.get_range(
                    name, bi * self.block_size, self.block_size
                )
                self.cache.put((name, gen, bi), blk)
            parts.append(blk)
        return b"".join(parts)

    def get_range(self, name: str, offset: int, length: int) -> bytes:
        """Block-granular ranged read: only the covering blocks are fetched
        from the inner store (O(blocks touched), never O(object) — the round-2
        version downloaded the whole blob per missing block)."""
        if self._bypass(name):
            return self.inner.get_range(name, offset, length)
        gen = self._generation(name)
        size = self.inner.size(name)
        end = min(offset + max(length, 0), size)
        if offset >= end:
            return b""
        bs = self.block_size
        b0, b1 = offset // bs, (end - 1) // bs
        parts = []
        for bi in range(b0, b1 + 1):
            blk = self.cache.get((name, gen, bi))
            if blk is None:
                blk = self.inner.get_range(name, bi * bs, bs)
                self.cache.put((name, gen, bi), blk)
            parts.append(blk)
        data = b"".join(parts)
        s = offset - b0 * bs
        return data[s : s + (end - offset)]

    def put(self, name: str, data: bytes) -> None:
        self.inner.put(name, data)
        if self._bypass(name):
            return
        self._bump(name)
        gen = self._generation(name)
        # Write-through block population at the new generation.
        nblocks = (len(data) + self.block_size - 1) // self.block_size
        for bi in range(nblocks):
            self.cache.put(
                (name, gen, bi),
                data[bi * self.block_size : (bi + 1) * self.block_size],
            )

    def delete(self, name: str) -> None:
        self.inner.delete(name)
        self._bump(name)

    def list(self, prefix: str = ""):
        return self.inner.list(prefix)

    def size(self, name: str) -> int:
        return self.inner.size(name)

    def mtime(self, name: str) -> float:
        return self.inner.mtime(name)

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        self.inner.put_if_not_exists(name, data)

    def cache_stats(self) -> dict:
        return self.cache.stats() if hasattr(self.cache, "stats") else {}
