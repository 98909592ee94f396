"""Heartbeat-based shard liveness for the serving tier (the port's own
copy of ``repro.serving.heartbeat``, pure Python and numpy).

The closed-queue engine takes a caller-set ``alive`` bool[S] mask; a live
service can't -- nobody is there to set it. :class:`HeartbeatMonitor`
derives the mask instead: each shard worker calls ``beat(shard)``
periodically, and a shard whose last beat is older than ``stale_after``
seconds is considered dead at the moment of each finalize. A sharded
index applies ``alive`` only at the finalize merge (per-shard beams are
independent), so a shard going stale MID-search yields exactly the
alive-restricted answer. A service or engine over an unsharded index
rejects a monitor (``engine.resolve_alive``).

The monitor is clock-injectable (tests drive a fake clock) and exposes
``suppress(shard)`` to simulate a straggler: beats from a suppressed
shard are dropped, so it goes stale on schedule rather than instantly --
the same observable behavior as a worker that silently hangs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np


class HeartbeatMonitor:
    """Tracks per-shard heartbeat timestamps; ``alive(now)`` is the
    derived liveness mask. Thread-safe: workers beat from their own
    threads while the device loop reads the mask."""

    def __init__(self, n_shards: int, stale_after: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if stale_after <= 0:
            raise ValueError("stale_after must be positive")
        self.n_shards = n_shards
        self.stale_after = float(stale_after)
        self.clock = clock
        self._lock = threading.Lock()
        now = clock()
        # every shard starts freshly beaten: a service that finalizes
        # before the first beat round should not mark the world dead
        self._last = np.full(n_shards, now, np.float64)  # guarded-by: _lock
        self._suppressed = np.zeros(n_shards, bool)      # guarded-by: _lock

    def _check(self, shard: int) -> None:
        if not (0 <= shard < self.n_shards):
            raise IndexError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")

    def beat(self, shard: int, now: Optional[float] = None) -> None:
        """Record a heartbeat. Beats from a suppressed shard are dropped
        (it goes stale exactly as a hung worker would)."""
        self._check(shard)
        with self._lock:
            if not self._suppressed[shard]:
                self._last[shard] = now if now is not None else self.clock()

    def beat_all(self, now: Optional[float] = None) -> None:
        for s in range(self.n_shards):
            self.beat(s, now)

    def suppress(self, shard: int) -> None:
        """Drop this shard's future beats (straggler injection)."""
        self._check(shard)
        with self._lock:
            self._suppressed[shard] = True

    def restore(self, shard: int, now: Optional[float] = None) -> None:
        """Lift a suppression and beat once, so the shard is instantly
        alive again (a recovered worker's first heartbeat)."""
        self._check(shard)
        with self._lock:
            self._suppressed[shard] = False
            self._last[shard] = now if now is not None else self.clock()

    def alive(self, now: Optional[float] = None) -> np.ndarray:
        """bool[S]: shards whose last beat is within ``stale_after``."""
        with self._lock:
            t = now if now is not None else self.clock()
            return (t - self._last) <= self.stale_after

    def snapshot(self, now: Optional[float] = None) -> dict:
        with self._lock:
            t = now if now is not None else self.clock()
            age = t - self._last
            suppressed = self._suppressed.tolist()
        return {"age_s": age.tolist(),
                "alive": (age <= self.stale_after).tolist(),
                "suppressed": suppressed,
                "stale_after": self.stale_after}
