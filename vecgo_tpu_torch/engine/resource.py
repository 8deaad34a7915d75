"""Resource controller: memory accounting, backpressure, IO rate limiting.

Reference: internal/resource (Controller controller.go:32, ErrBackpressure,
IO limiter io.go:10-50; wired with a 1 GB default in engine.go:446-450).
"""

from __future__ import annotations

import threading
import time

from vecgo_tpu_torch.errors import ErrBackpressure


class Controller:
    def __init__(self, memory_limit_bytes: int = 0, observer=None):
        self.memory_limit = memory_limit_bytes
        self._used = 0
        self._lock = threading.Lock()
        self._observer = observer

    @property
    def used(self) -> int:
        return self._used

    def acquire(self, nbytes: int) -> None:
        """Account memory; raises ErrBackpressure over the limit."""
        with self._lock:
            if self.memory_limit and self._used + nbytes > self.memory_limit:
                if self._observer is not None:
                    self._observer.on_backpressure()
                raise ErrBackpressure(
                    f"memory limit {self.memory_limit} exceeded "
                    f"(used {self._used} + {nbytes})"
                )
            self._used += nbytes

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._used = max(0, self._used - nbytes)

    def set_used(self, nbytes: int) -> None:
        with self._lock:
            self._used = nbytes


class DeviceBudget:
    """HBM residency manager: segments ask to keep device state resident;
    over-budget admissions evict the least-recently-used resident segment
    (its release_device() drops the HBM copies — host arrays remain, and
    searches fall back to streaming scans).

    The TPU analogue of the reference's block-cache economics
    (internal/cache, engine.go:425-477): HBM plays the RAM tier, host RAM
    plays the NVMe tier, the streaming scan plays the lazy block read
    (diskann/segment.go:1151 readBlock).
    """

    def __init__(self, budget_bytes: int = 0):
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._resident = {}  # key -> (nbytes, release_fn); insertion = LRU order
        self.evictions = 0

    @property
    def used(self) -> int:
        with self._lock:
            return sum(nb for nb, _ in self._resident.values())

    def admit(self, key, nbytes: int, release_fn) -> bool:
        """Try to make `key` resident; returns False if it can never fit
        (nbytes > budget) — the caller should stream instead."""
        if self.budget <= 0:
            return True  # unlimited
        with self._lock:
            if key in self._resident:
                self._resident[key] = self._resident.pop(key)  # LRU touch
                return True
            if nbytes > self.budget:
                return False
            used = sum(nb for nb, _ in self._resident.values())
            while used + nbytes > self.budget and self._resident:
                victim, (nb, rel) = next(iter(self._resident.items()))
                del self._resident[victim]
                used -= nb
                self.evictions += 1
                try:
                    rel()
                except Exception:
                    pass
            self._resident[key] = (nbytes, release_fn)
            return True

    def touch(self, key) -> None:
        with self._lock:
            if key in self._resident:
                self._resident[key] = self._resident.pop(key)

    def drop(self, key) -> None:
        with self._lock:
            self._resident.pop(key, None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.budget,
                "used_bytes": sum(nb for nb, _ in self._resident.values()),
                "resident": len(self._resident),
                "evictions": self.evictions,
            }


class RateLimiter:
    """Token-bucket byte/s limiter for flush/compaction writers
    (reference: resource/io.go)."""

    def __init__(self, bytes_per_s: float, burst: float = 0.0):
        self.rate = bytes_per_s
        self.burst = burst or bytes_per_s
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def throttle(self, nbytes: int) -> float:
        """Blocks until nbytes may proceed; returns seconds slept.

        Requests larger than the burst are allowed by letting the bucket go
        negative (debt), so a single oversized write throttles *subsequent*
        writes instead of deadlocking.
        """
        if self.rate <= 0:
            return 0.0
        slept = 0.0
        gate = min(float(nbytes), self.burst)
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.rate
                )
                self._last = now
                if self._tokens >= gate:
                    self._tokens -= nbytes  # may go negative (debt)
                    return slept
                need = (gate - self._tokens) / self.rate
            step = min(need, 0.1)
            time.sleep(step)
            slept += step
