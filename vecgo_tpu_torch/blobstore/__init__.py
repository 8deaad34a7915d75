"""Blob storage plane (reference: blobstore/store.go:33-67, local.go:41-108,
MemoryStore, caching_store.go).

The data plane for segments/manifests. Writer/reader separation and cloud tier
ride on this interface; the accelerator never touches it (host-only IO,
SURVEY.md §2.4).
"""

from __future__ import annotations

import abc
import os
import tempfile
import threading
from typing import Dict, Iterable, List, Optional

from vecgo_tpu_torch.errors import ErrNotFound, ErrConflict


class BlobStore(abc.ABC):
    """Open/Put/Delete/List contract (reference: blobstore.BlobStore)."""

    @abc.abstractmethod
    def put(self, name: str, data: bytes) -> None:
        """Atomic write (temp+rename semantics where applicable)."""

    @abc.abstractmethod
    def get(self, name: str) -> bytes: ...

    def get_range(self, name: str, offset: int, length: int) -> bytes:
        """Ranged read [offset, offset+length). Base fallback is O(object);
        stores with real ranged IO (LocalStore seek/read, S3 `Range:` header,
        CachingStore block cache) override with O(length) implementations
        (reference: blobstore.Blob random access, diskann readBlock:1151)."""
        return self.get(name)[offset : offset + length]

    @abc.abstractmethod
    def delete(self, name: str) -> None: ...

    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[str]: ...

    def exists(self, name: str) -> bool:
        try:
            self.size(name)
            return True
        except ErrNotFound:
            return False

    @abc.abstractmethod
    def size(self, name: str) -> int: ...

    def mtime(self, name: str) -> float:
        """Last-modified unix time; used to age-gate orphan GC. Stores that
        can't answer may raise ErrNotFound for unknown names only and should
        otherwise return a best-effort timestamp."""
        raise NotImplementedError

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        """CAS primitive for multi-writer manifest commits (reference:
        s3/express_store.go:94-126 PutIfNotExists, ddb_commit_store.go)."""
        if self.exists(name):
            raise ErrConflict(f"blob {name} already exists")
        self.put(name, data)


class LocalStore(BlobStore):
    """Filesystem store with atomic temp+rename writes (reference: local.go)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        p = os.path.normpath(os.path.join(self.root, name))
        if not p.startswith(os.path.normpath(self.root)):
            raise ValueError(f"blob name escapes root: {name}")
        return p

    def put(self, name: str, data: bytes) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, name: str) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ErrNotFound(name)

    def get_range(self, name: str, offset: int, length: int) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError:
            raise ErrNotFound(name)

    def get_view(self, name: str):
        """Zero-copy memory-mapped view (reference: internal/mmap — the
        reference's mmap'd segment reads). Returns a read-only np.memmap;
        container.unpack_container(view, copy=False) then aliases file pages,
        so opening a large local segment costs page faults, not a full read."""
        import numpy as np

        try:
            return np.memmap(self._path(name), dtype=np.uint8, mode="r")
        except FileNotFoundError:
            raise ErrNotFound(name)

    def delete(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for f in files:
                if f.startswith(".tmp-"):
                    continue
                name = f if rel == "." else os.path.join(rel, f).replace(os.sep, "/")
                if name.startswith(prefix):
                    out.append(name)
        return sorted(out)

    def size(self, name: str) -> int:
        try:
            return os.path.getsize(self._path(name))
        except FileNotFoundError:
            raise ErrNotFound(name)

    def mtime(self, name: str) -> float:
        try:
            return os.path.getmtime(self._path(name))
        except FileNotFoundError:
            raise ErrNotFound(name)

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            # O_EXCL gives a real CAS on the local filesystem.
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                raise ErrConflict(f"blob {name} already exists")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())


class MemoryStore(BlobStore):
    """In-memory store — the cloud fake used across tests (reference:
    blobstore.MemoryStore, engine cloud_test.go)."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._mtimes: Dict[str, float] = {}
        self._lock = threading.Lock()

    def put(self, name: str, data: bytes) -> None:
        import time

        with self._lock:
            self._blobs[name] = bytes(data)
            self._mtimes[name] = time.time()

    def get(self, name: str) -> bytes:
        with self._lock:
            try:
                return self._blobs[name]
            except KeyError:
                raise ErrNotFound(name)

    def delete(self, name: str) -> None:
        with self._lock:
            self._blobs.pop(name, None)
            self._mtimes.pop(name, None)

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(n for n in self._blobs if n.startswith(prefix))

    def size(self, name: str) -> int:
        with self._lock:
            try:
                return len(self._blobs[name])
            except KeyError:
                raise ErrNotFound(name)

    def mtime(self, name: str) -> float:
        with self._lock:
            try:
                return self._mtimes[name]
            except KeyError:
                raise ErrNotFound(name)

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        import time

        with self._lock:
            if name in self._blobs:
                raise ErrConflict(f"blob {name} already exists")
            self._blobs[name] = bytes(data)
            self._mtimes[name] = time.time()


class FaultyStore(BlobStore):
    """Fault-injection wrapper (reference: internal/fs/faulty.go FaultyFS).

    Rules: fail writes matching a name substring after N successful calls,
    and/or enforce a global write budget in bytes.
    """

    def __init__(self, inner: BlobStore, fail_pattern: str = "", fail_after: int = 0,
                 write_budget: Optional[int] = None):
        self.inner = inner
        self.fail_pattern = fail_pattern
        self.fail_after = fail_after
        self.write_budget = write_budget
        self._writes = 0

    def put(self, name: str, data: bytes) -> None:
        if self.fail_pattern and self.fail_pattern in name:
            if self._writes >= self.fail_after:
                raise IOError(f"injected fault writing {name}")
            self._writes += 1
        if self.write_budget is not None:
            if self.write_budget < len(data):
                raise IOError(f"injected fault: write budget exhausted at {name}")
            self.write_budget -= len(data)
        self.inner.put(name, data)

    def get(self, name: str) -> bytes:
        return self.inner.get(name)

    def delete(self, name: str) -> None:
        self.inner.delete(name)

    def list(self, prefix: str = "") -> List[str]:
        return self.inner.list(prefix)

    def size(self, name: str) -> int:
        return self.inner.size(name)

    def mtime(self, name: str) -> float:
        return self.inner.mtime(name)

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        if self.fail_pattern and self.fail_pattern in name and self._writes >= self.fail_after:
            raise IOError(f"injected fault writing {name}")
        self.inner.put_if_not_exists(name, data)
