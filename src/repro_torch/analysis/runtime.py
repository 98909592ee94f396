"""Runtime verification: the invariants static analysis cannot see (port
of ``repro.analysis.runtime``).

Three guards, all context managers, all designed to wrap an existing
test or benchmark without changing what it measures. Each restores what
it patched on exit, also when the block raises, and none of them
swallows an error.

:class:`CompileCounter` counts what the port compiles while it is active.
Eager PyTorch has no tracing compiler whose events could be listened to,
so the port reports its own compile events through :func:`record_compile`,
one call per event, by kind:

* ``"nvcc"`` -- ``repro_torch.kernels._build.load`` ran ``nvcc`` on a
  CUDA source (a library already loaded in this process, or reused from
  ``_build_out/``, is no event);
* ``"program"`` -- a ``ProgramCache`` stored a new entry after a miss
  (recorded where the entry is made, not read off ``CacheStats``: cache
  stats can lie, a re-keyed entry still misses, the hook cannot).

A serving or ``db.execute`` steady state is supposed to build a fixed set
up front and *nothing* afterwards; a steady-state compile is the silent
regression NaviX's robustness argument forbids, and the counter turns it
into a test failure instead of a mystery latency spike. The hook imports
nothing of the port, so ``_build`` and ``plan_compile`` stay light.

:class:`LockOrderMonitor` (via :func:`instrument_locks`) swaps
``threading.Lock`` for a recording wrapper, keeps the per-thread stack
of held locks, and adds an edge ``A -> B`` whenever B is acquired while
A is held. Locks are keyed by *creation site* (file:line), lockdep
style, so every instance of ``SubmissionQueue._lock`` is one node. A
cycle in the graph is a deadlock that merely hasn't fired yet.

:class:`DonationGuard` (via :func:`guard_donation`) keeps the reference's
names, but PyTorch has no buffer donation: what it guards is
``LaneBatch``'s in-flight window. From ``step_async`` to ``step_wait``
the enqueued chunk replaces the lane state (``self.st``) and a
non-blocking copy writes the chunk's liveness into the pinned host
buffer; device calls issued in that window queue behind the chunk on the
stream, so nothing goes wrong today, but nothing checks that no caller
reaches for lane state there either. The guard patches ``LaneBatch``
class-wide so that inside the window the host mirrors (``Qh``, ``selh``,
``sigh``, ``efsh``) are frozen read-only and ``admit`` / ``finalize`` /
``evict`` raise :class:`DonationError`.

The reference's static passes (NX5xx-NX7xx) model JAX tracing and
donation and are not ported; navilint sweeps this package as it is.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

#: compile-event kinds the port reports through :func:`record_compile`
NVCC = "nvcc"
PROGRAM = "program"

_active_counters: set["CompileCounter"] = set()
_counters_lock = threading.Lock()


def record_compile(kind: str) -> None:
    """Report one compile event of ``kind`` to every active counter."""
    with _counters_lock:
        counters = tuple(_active_counters)
    for counter in counters:
        counter._record(kind)


class CompileCounter:
    """Counts the port's compile events while active.

    >>> with CompileCounter() as cc:
    ...     warmup()
    ...     cc.mark("steady")
    ...     serve_traffic()
    >>> cc.counts  # {"warmup": 3, "steady": 0}

    ``mark(phase)`` closes the current phase and opens a new one (marking
    a phase again resumes its count); the per-phase counts are the
    artifact the zero-recompile gate checks (steady phases must stay at
    exactly 0). ``kinds`` splits each phase's count by event kind.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phase = "warmup"
        self.counts: dict[str, int] = {"warmup": 0}
        self.kinds: dict[str, dict[str, int]] = {"warmup": {}}
        self.total = 0

    def _record(self, kind: str) -> None:
        with self._lock:
            self.counts[self._phase] = self.counts.get(self._phase, 0) + 1
            per = self.kinds.setdefault(self._phase, {})
            per[kind] = per.get(kind, 0) + 1
            self.total += 1

    def mark(self, phase: str) -> None:
        """Begin a new counting phase (e.g. the post-warmup steady state)."""
        with self._lock:
            self._phase = phase
            self.counts.setdefault(phase, 0)
            self.kinds.setdefault(phase, {})

    def count(self, kind: str, phase: Optional[str] = None) -> int:
        """Events of ``kind`` in ``phase`` (in every phase by default)."""
        with self._lock:
            phases = self.kinds.values() if phase is None else (
                self.kinds.get(phase, {}),)
            return sum(per.get(kind, 0) for per in phases)

    def __enter__(self) -> "CompileCounter":
        with _counters_lock:
            _active_counters.add(self)
        return self

    def __exit__(self, *exc) -> None:
        with _counters_lock:
            _active_counters.discard(self)


# -- lock-order monitoring ---------------------------------------------------


class _InstrumentedLock:
    """Drop-in ``threading.Lock`` that reports acquisitions to a monitor.

    Also duck-types the private hooks ``threading.Condition`` calls
    (``_release_save``/``_acquire_restore``/``_is_owned``) by falling
    back to plain release/acquire, so ``Condition(instrumented_lock)``
    and the default ``Condition()`` both keep working under
    instrumentation.
    """

    def __init__(self, monitor: "LockOrderMonitor", site: str):
        self._inner = monitor._real_lock()
        self._monitor = monitor
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._monitor._acquired(self._site)
        return got

    def release(self) -> None:
        self._inner.release()
        self._monitor._released(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition-compatibility fallbacks
    def _release_save(self):
        self.release()
        return None

    def _acquire_restore(self, state) -> None:
        self.acquire()

    def _is_owned(self) -> bool:
        # Lock (unlike RLock) has no owner notion; mirror Condition's
        # own fallback: if we can't acquire without blocking, somebody
        # (assumed: us) holds it.
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


class LockOrderMonitor:
    """Builds the lock-acquisition graph and detects ordering cycles.

    Nodes are lock *classes* (creation file:line), edges mean "held A
    while acquiring B". :meth:`cycles` runs a DFS over the edge set;
    any cycle is a latent deadlock even if this run never interleaved
    the two threads badly.
    """

    def __init__(self) -> None:
        self._real_lock = threading.Lock  # captured before patching
        self._graph_lock = self._real_lock()
        self._held = threading.local()
        #: directed edges with their acquisition counts
        self.edges: dict[tuple[str, str], int] = {}
        self.sites: set[str] = set()

    # -- wrapper callbacks ---------------------------------------------
    def _stack(self) -> list[str]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def _acquired(self, site: str) -> None:
        stack = self._stack()
        with self._graph_lock:
            self.sites.add(site)
            for held in stack:
                if held != site:
                    edge = (held, site)
                    self.edges[edge] = self.edges.get(edge, 0) + 1
        stack.append(site)

    def _released(self, site: str) -> None:
        stack = self._stack()
        # release order need not be LIFO; drop the innermost match
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                break

    # -- analysis -------------------------------------------------------
    def cycles(self) -> list[list[str]]:
        """All elementary cycles reachable in the acquisition graph."""
        with self._graph_lock:
            adj: dict[str, list[str]] = {}
            for (a, b) in self.edges:
                adj.setdefault(a, []).append(b)
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(node: str, path: list[str], on_path: set[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    # canonicalize rotation so each cycle reports once
                    body = cyc[:-1]
                    k = body.index(min(body))
                    key = tuple(body[k:] + body[:k])
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                elif nxt not in visited:
                    visited.add(nxt)
                    dfs(nxt, path + [nxt], on_path | {nxt})

        visited: set[str] = set()
        for start in sorted(adj):
            if start not in visited:
                visited.add(start)
                dfs(start, [start], {start})
        return out

    def report(self) -> dict:
        """JSON-able summary for bench artifacts."""
        return {
            "sites": len(self.sites),
            "edges": len(self.edges),
            "cycles": [" -> ".join(c) for c in self.cycles()],
        }


def _creation_site(depth: int = 2) -> str:
    import sys

    frame = sys._getframe(depth)
    # walk out of this module so the site names the caller's code
    while frame is not None and frame.f_globals.get(
            "__name__") == __name__:
        frame = frame.f_back
    if frame is None:  # pragma: no cover
        return "<unknown>"
    return f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"


@contextlib.contextmanager
def instrument_locks(monitor: Optional[LockOrderMonitor] = None
                     ) -> Iterator[LockOrderMonitor]:
    """Patch ``threading.Lock`` so locks created inside the block feed
    *monitor*'s acquisition graph. Locks created before (or after) the
    block are plain locks -- instrument the code under test by creating
    its objects inside the ``with``.

    ``threading.Condition()``'s default RLock is left unpatched on
    purpose: it keeps executor/queue internals out of the graph unless
    the caller passes an instrumented lock explicitly.
    """
    mon = monitor if monitor is not None else LockOrderMonitor()

    def make_lock() -> _InstrumentedLock:
        return _InstrumentedLock(mon, _creation_site())

    orig = threading.Lock
    threading.Lock = make_lock  # type: ignore[misc,assignment]
    try:
        yield mon
    finally:
        threading.Lock = orig  # type: ignore[misc]


# -- the in-flight window of LaneBatch -----------------------------------------


class DonationError(RuntimeError):
    """Lane state touched while a device chunk was in flight."""


class DonationGuard:
    """Counts in-flight windows and records any in-window violation.

    A *window* opens when ``step_async`` enqueues a chunk (which replaces
    ``st`` and writes the pinned liveness buffer as it runs) and closes at
    ``step_wait``. Inside the window the only legal host work is work
    that does not touch lane state -- queue expiry, future resolution,
    response building.
    """

    def __init__(self) -> None:
        self.windows = 0
        self.violations: list[str] = []

    def report(self) -> dict:
        """JSON-able summary for bench artifacts."""
        return {"windows": self.windows,
                "violations": list(self.violations)}

    def _violate(self, what: str) -> None:
        msg = (f"{what} while a device chunk is in flight: the chunk owns "
               f"the lane state until step_wait() (it replaces st and "
               f"writes the pinned liveness buffer) -- step_wait() first")
        self.violations.append(msg)
        raise DonationError(msg)


def _lane_mirrors(lanes) -> list:
    """The numpy host mirrors a LaneBatch owns (``selh`` is ``[B, W]``
    words, or ``[S, B, W]`` over a sharded index)."""
    return [lanes.Qh, lanes.selh, lanes.sigh, lanes.efsh]


@contextlib.contextmanager
def guard_donation(guard: Optional[DonationGuard] = None
                   ) -> Iterator[DonationGuard]:
    """Patch :class:`~repro_torch.serving.lanes.LaneBatch` so its in-flight
    window between ``step_async`` and ``step_wait`` is enforced at
    runtime: host mirrors go read-only (an ``admit`` writing ``Qh`` trips
    numpy's writeable check even before the explicit raise) and
    ``admit``/``finalize``/``evict`` raise :class:`DonationError`.

    The patch is class-wide, so every LaneBatch created before or
    during the block is guarded; state is restored on exit even when
    the block raises.
    """
    from repro_torch.serving.lanes import LaneBatch

    g = guard if guard is not None else DonationGuard()
    orig = {name: getattr(LaneBatch, name)
            for name in ("step_async", "step_wait", "admit",
                         "finalize", "evict")}
    frozen: dict[int, list] = {}      # id(lanes) -> [(arr, writeable)]

    def _freeze(self) -> None:
        saved = []
        for arr in _lane_mirrors(self):
            saved.append((arr, bool(arr.flags.writeable)))
            arr.flags.writeable = False
        frozen[id(self)] = saved

    def _thaw(self) -> None:
        for arr, writeable in frozen.pop(id(self), ()):
            arr.flags.writeable = writeable

    def step_async(self, n_steps):
        orig["step_async"](self, n_steps)
        g.windows += 1
        _freeze(self)

    def step_wait(self):
        _thaw(self)
        return orig["step_wait"](self)

    def _gated(name):
        def method(self, *args, **kwargs):
            if getattr(self, "_pending", False):
                g._violate(f"LaneBatch.{name}()")
            return orig[name](self, *args, **kwargs)
        return method

    LaneBatch.step_async = step_async
    LaneBatch.step_wait = step_wait
    for name in ("admit", "finalize", "evict"):
        setattr(LaneBatch, name, _gated(name))
    try:
        yield g
    finally:
        for name, fn in orig.items():
            setattr(LaneBatch, name, fn)
        for lanes_id in list(frozen):
            for arr, writeable in frozen.pop(lanes_id, ()):
                arr.flags.writeable = writeable
