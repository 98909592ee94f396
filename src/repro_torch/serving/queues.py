"""Bounded, thread-safe submission queue for the live serving tier (the
port's own copy of ``repro.serving.queues``, pure Python).

The queue sits between ``SearchService.submit`` (any number of client
threads) and the single device loop. Three policies live here, and only
here -- the service just calls ``pop_batch``:

* **deadline-ordered admission** -- ``pop_batch`` serves the most urgent
  request first (earliest absolute deadline; deadline-free requests rank
  after every deadlined one, FIFO among themselves);
* **selectivity-binned batching** -- requests are binned by their
  prefiltered selectivity (geometric bins: ``(1/2, 1]``, ``(1/4, 1/2]``,
  ...), and a batch is filled from the urgent request's bin outward.
  Lanes running together then carry similar-sigma subqueries, so they
  tend to take the same expansion branch (see
  ``SearchEngine._serve_fused``) -- the live-queue analogue of the closed
  drain's selectivity-sorted admission;
* **backpressure with watermark hysteresis** -- once depth reaches the
  high watermark the queue *gates*: ``policy="reject"`` makes ``put``
  raise :class:`QueueFull` immediately, ``policy="block"`` makes it wait.
  The gate stays closed until depth falls back to the low watermark, so
  a queue oscillating around the high mark doesn't flap admission.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Optional


class QueueFull(RuntimeError):
    """Submission rejected (or timed out) under backpressure."""


class ServiceClosed(RuntimeError):
    """Submission after ``close()``/``shutdown()``."""


def sigma_bin(sigma: float, n_bins: int) -> int:
    """Geometric selectivity bin: 0 = (1/2, 1], 1 = (1/4, 1/2], ...
    clamped to ``n_bins`` bins. Matches the selectivity regimes the
    adaptive heuristic switches on (low sigma = sparse S = different
    search behavior), so same-bin lanes batch cheaply."""
    s = min(max(float(sigma), 1e-9), 1.0)
    return min(n_bins - 1, max(0, int(math.floor(-math.log2(s) + 1e-12))))


@dataclasses.dataclass
class QueueItem:
    """One queued submission. ``deadline`` is absolute (same clock as the
    service; ``None`` = no deadline). ``meta`` is the service's opaque
    payload (future, prepped query row, packed semimask, ...)."""
    seq: int
    sigma: float
    deadline: Optional[float]
    t_enqueue: float
    meta: Any = None

    def sort_key(self, prefer_bin: Optional[int], n_bins: int):
        d = (0 if prefer_bin is None
             else abs(sigma_bin(self.sigma, n_bins) - prefer_bin))
        return (d, self.deadline if self.deadline is not None else math.inf,
                self.seq)


class SubmissionQueue:
    """Bounded thread-safe queue with EDF + selectivity-bin pop order and
    watermark-hysteresis backpressure. All methods are safe to call from
    any thread; ``pop_batch``/``expire`` are meant for the single device
    loop, ``put`` for submitters."""

    def __init__(self, maxsize: int = 256, policy: str = "reject",
                 high_watermark: Optional[int] = None,
                 low_watermark: Optional[int] = None, n_bins: int = 4):
        if policy not in ("reject", "block"):
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"valid: ('reject', 'block')")
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self.policy = policy
        self.high = high_watermark if high_watermark is not None else maxsize
        self.low = (low_watermark if low_watermark is not None
                    else max(1, self.high // 2))
        if not (1 <= self.low <= self.high <= maxsize):
            raise ValueError(f"need 1 <= low ({self.low}) <= high "
                             f"({self.high}) <= maxsize ({maxsize})")
        self.n_bins = n_bins
        self._items: list[QueueItem] = []               # guarded-by: _lock
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)   # putters wait here
        self._data = threading.Condition(self._lock)    # the loop waits here
        self._gated = False                             # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        self._seq = 0                                   # guarded-by: _lock
        self.n_rejected = 0                             # guarded-by: _lock

    # -- submitter side -----------------------------------------------------
    def put(self, sigma: float, deadline: Optional[float], meta: Any,
            timeout: Optional[float] = None,
            now: Optional[float] = None) -> QueueItem:
        """Enqueue one submission. Under backpressure (depth at the high
        watermark, not yet drained to the low one): ``reject`` raises
        :class:`QueueFull` immediately; ``block`` waits for the gate to
        reopen (``timeout`` seconds, then :class:`QueueFull`). Raises
        :class:`ServiceClosed` after ``close()`` -- including for blocked
        putters, which wake immediately."""
        with self._lock:
            if self._closed:
                raise ServiceClosed("queue is closed")
            t_end = None
            # re-evaluate the gate each time a blocked putter wakes: N
            # putters woken together would otherwise all append after
            # one ungate, pushing depth to low + N past the high
            # watermark (and potentially past maxsize)
            while True:
                if len(self._items) >= self.high:
                    self._gated = True
                if not self._gated:
                    break
                if self.policy == "reject":
                    self.n_rejected += 1
                    raise QueueFull(
                        f"queue gated at depth {len(self._items)} "
                        f"(high={self.high}; reopens at low={self.low})")
                if timeout is not None and t_end is None:
                    t_end = time.monotonic() + timeout
                remaining = (None if t_end is None
                             else t_end - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self.n_rejected += 1
                    raise QueueFull("blocked put timed out under "
                                    "backpressure")
                self._space.wait(remaining)
                if self._closed:
                    raise ServiceClosed("queue closed while blocked on "
                                        "backpressure")
            item = QueueItem(
                seq=self._seq, sigma=float(sigma), deadline=deadline,
                t_enqueue=now if now is not None else time.perf_counter(),
                meta=meta)
            self._seq += 1
            self._items.append(item)
            self._data.notify_all()
            return item

    # -- device-loop side ---------------------------------------------------
    def pop_batch(self, n: int,
                  prefer_sigma: Optional[float] = None) -> list[QueueItem]:
        """Pop up to ``n`` items: the earliest-deadline item anchors the
        batch's selectivity bin (unless ``prefer_sigma`` -- e.g. the
        running lanes' sigma -- anchors it instead), then the batch fills
        bin-distance-first, deadline-second, FIFO-third."""
        with self._lock:
            if n <= 0 or not self._items:
                return []
            if prefer_sigma is not None:
                prefer = sigma_bin(prefer_sigma, self.n_bins)
            else:
                urgent = min(self._items,
                             key=lambda it: it.sort_key(None, self.n_bins))
                prefer = sigma_bin(urgent.sigma, self.n_bins)
            order = sorted(self._items,
                           key=lambda it: it.sort_key(prefer, self.n_bins))
            taken = order[:n]
            picked = {id(it) for it in taken}
            self._items = [it for it in self._items
                           if id(it) not in picked]
            self._maybe_ungate()
            return taken

    def expire(self, now: float) -> list[QueueItem]:
        """Remove and return every item whose deadline already passed --
        they will never get device time; the service resolves them as
        ``timeout`` without occupying a lane."""
        with self._lock:
            dead = [it for it in self._items
                    if it.deadline is not None and it.deadline < now]
            if dead:
                gone = {id(it) for it in dead}
                self._items = [it for it in self._items
                               if id(it) not in gone]
                self._maybe_ungate()
            return dead

    def drain_remaining(self) -> list[QueueItem]:
        """Pop everything (shutdown path)."""
        with self._lock:
            items, self._items = self._items, []
            self._maybe_ungate()
            return items

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        """Park the device loop until an item arrives or the queue closes.
        Returns True iff items are present."""
        with self._lock:
            if not self._items and not self._closed:
                self._data.wait(timeout)
            return bool(self._items)

    # -- lifecycle / gauges -------------------------------------------------
    def close(self) -> None:
        """Refuse further ``put``s (blocked putters wake with
        :class:`ServiceClosed`); queued items stay poppable for drain."""
        with self._lock:
            self._closed = True
            self._space.notify_all()
            self._data.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def gauges(self) -> dict:
        with self._lock:
            return {"depth": len(self._items), "gated": self._gated,
                    "rejected": self.n_rejected, "closed": self._closed}

    def _maybe_ungate(self) -> None:
        # no lock-held annotation needed: navilint's interprocedural
        # NX201 proves every call site already holds self._lock
        if self._gated and len(self._items) <= self.low:
            self._gated = False
            self._space.notify_all()
