"""The port's live serving tier: queue backpressure, heartbeat liveness,
lane eviction, ``SearchService`` deadlines and shutdown, ``NavixDB.serve``
and the ``repro_torch.launch.serve`` entry point (ports of the unsharded
cases of ``tests/test_serving_live.py``).

The deterministic tests drive ``SearchService._tick()`` by hand with an
injected fake clock -- no threads, no sleeps -- so deadline semantics are
exact: a deadline that passes in-queue or mid-flight produces
``Response.timeout`` with ALL ids ``-1``, unless the evicted lane's beam
already covers k valid candidates (``"partial"``). Every thread join,
future wait and shutdown here has its own timeout. Against the reference's
``SearchService`` on the same submissions: per rid ids equal, dists
allclose at rtol 1e-5 (the tolerance of ``tests/test_torch_search.py``).
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.api.db import NavixDB as JNavixDB
from repro.query import operators as jops
from repro.serving.service import SearchService as JSearchService
from repro.storage.columnar import GraphStore as JGraphStore
from repro_torch.api.db import NavixDB
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.query.operators import Filter, KnnSearch, NodeScan
from repro_torch.serving import (HeartbeatMonitor, LaneBatch, QueueFull,
                                 SearchService, ServiceClosed,
                                 SubmissionQueue, resolve_alive, sigma_bin)
from repro_torch.storage.columnar import GraphStore

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
WAIT_S = 60.0              # the longest any future, join or shutdown waits


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


def _db(idx, n):
    store = GraphStore()
    store.add_node_table("Chunk", n, {"cID": np.arange(n)})
    db = NavixDB(store, device="cpu")
    db.register_index("default", idx)
    return db


def _cut_plan(cut):
    return Filter(NodeScan("Chunk"), "cID", "<", value=cut)


def _drive(svc, futs, max_ticks=500):
    """Tick the service until every future resolves (manual driver)."""
    for _ in range(max_ticks):
        if all(f.done() for f in futs):
            return
        svc._tick()
    raise AssertionError("service did not resolve all futures")


def _single_ids(idx, q, k, efs, cut=None):
    mask = None if cut is None else np.arange(idx.graph.n) < cut
    return idx.search(q, k=k, efs=efs, semimask=mask).ids.numpy()


# -- SubmissionQueue ---------------------------------------------------------

def test_sigma_bins_are_geometric():
    assert sigma_bin(1.0, 4) == 0
    assert sigma_bin(0.6, 4) == 0
    assert sigma_bin(0.4, 4) == 1
    assert sigma_bin(0.2, 4) == 2
    assert sigma_bin(0.01, 4) == 3          # clamped to the last bin
    assert sigma_bin(0.0, 4) == 3


def test_queue_backpressure_reject_with_hysteresis():
    q = SubmissionQueue(maxsize=8, policy="reject",
                        high_watermark=3, low_watermark=1)
    for j in range(3):
        q.put(1.0, None, meta=j)
    with pytest.raises(QueueFull):
        q.put(1.0, None, meta=99)
    assert q.gauges()["gated"] and q.gauges()["rejected"] == 1
    # hysteresis: popping to depth 2 (> low) keeps the gate closed ...
    assert len(q.pop_batch(1)) == 1
    with pytest.raises(QueueFull):
        q.put(1.0, None, meta=99)
    # ... and reaching the low watermark reopens it
    assert len(q.pop_batch(1)) == 1
    q.put(1.0, None, meta=100)
    assert not q.gauges()["gated"]


def test_queue_rejects_bad_configuration():
    with pytest.raises(ValueError, match="policy"):
        SubmissionQueue(policy="drop")
    with pytest.raises(ValueError, match="maxsize"):
        SubmissionQueue(maxsize=0)
    with pytest.raises(ValueError, match="low"):
        SubmissionQueue(maxsize=4, high_watermark=2, low_watermark=3)


def test_queue_backpressure_block_unblocks_at_low_watermark():
    q = SubmissionQueue(maxsize=8, policy="block",
                        high_watermark=2, low_watermark=1)
    q.put(1.0, None, meta=0)
    q.put(1.0, None, meta=1)
    got = []
    t = threading.Thread(
        target=lambda: got.append(q.put(1.0, None, meta=2)))
    t.start()
    t.join(0.2)
    assert t.is_alive(), "put must block while gated"
    q.pop_batch(1)                           # depth 1 == low -> reopen
    t.join(5.0)
    assert not t.is_alive() and got[0].meta == 2
    q.pop_batch(1)                           # back below the gate
    q.put(1.0, None, meta=3)                 # depth 2 again
    # a blocked put with a timeout gives up as QueueFull
    with pytest.raises(QueueFull):
        q.put(1.0, None, meta=4, timeout=0.05)


def test_queue_block_woken_putters_recheck_depth():
    """N putters blocked on the gate must NOT all append when it reopens:
    each woken putter re-checks depth, so depth never exceeds the high
    watermark even under a thundering herd."""
    q = SubmissionQueue(maxsize=4, policy="block",
                        high_watermark=2, low_watermark=1)
    q.put(1.0, None, meta=0)
    q.put(1.0, None, meta=1)                 # depth == high -> gated
    n_blocked = 3
    started = []
    threads = [threading.Thread(
        target=lambda j=j: started.append(q.put(1.0, None, meta=10 + j)))
        for j in range(n_blocked)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(0.2)
    assert all(t.is_alive() for t in threads), "puts must block gated"
    q.pop_batch(1)                           # depth 1 == low -> reopen
    deadline = 5.0
    t0 = time.monotonic()
    while len(started) < 1 and time.monotonic() - t0 < deadline:
        time.sleep(0.01)
    time.sleep(0.1)                          # let the herd race the gate
    assert len(q) <= 2, ("woken putters must re-check depth; got depth "
                         f"{len(q)} > high=2")
    while len(started) < n_blocked and time.monotonic() - t0 < deadline:
        q.pop_batch(2)
        time.sleep(0.01)
    for t in threads:
        t.join(deadline)
    assert len(started) == n_blocked
    assert len(q) <= 2


def test_queue_close_wakes_blocked_putter_with_service_closed():
    q = SubmissionQueue(maxsize=4, policy="block", high_watermark=1)
    q.put(1.0, None, meta=0)
    err = []

    def blocked():
        try:
            q.put(1.0, None, meta=1)
        except ServiceClosed as e:
            err.append(e)

    t = threading.Thread(target=blocked)
    t.start()
    t.join(0.2)
    assert t.is_alive()
    q.close()
    t.join(5.0)
    assert not t.is_alive() and len(err) == 1
    with pytest.raises(ServiceClosed):
        q.put(1.0, None, meta=2)
    # queued items remain drainable after close
    assert [it.meta for it in q.drain_remaining()] == [0]


def test_queue_pop_is_deadline_ordered_and_bin_affine():
    q = SubmissionQueue(maxsize=16)
    q.put(1.0, 10.0, meta="a")               # bin 0, later deadline
    q.put(0.9, None, meta="b")               # bin 0, no deadline
    q.put(0.10, 5.0, meta="c")               # bin 3, EARLIEST deadline
    q.put(0.12, None, meta="d")              # bin 3
    # the urgent item (c) anchors the bin; d rides along before a/b
    assert [it.meta for it in q.pop_batch(2)] == ["c", "d"]
    assert [it.meta for it in q.pop_batch(4)] == ["a", "b"]
    # prefer_sigma overrides the anchor (running-lane affinity)
    q.put(1.0, 10.0, meta="a")
    q.put(0.1, 5.0, meta="c")
    assert [it.meta for it in q.pop_batch(1, prefer_sigma=1.0)] == ["a"]


def test_queue_expire_removes_past_deadline_items():
    q = SubmissionQueue(maxsize=8)
    q.put(1.0, 5.0, meta="dead")
    q.put(1.0, 50.0, meta="ok")
    q.put(1.0, None, meta="forever")
    dead = q.expire(now=10.0)
    assert [it.meta for it in dead] == ["dead"]
    assert len(q) == 2


def test_queue_wait_nonempty_returns_on_put_and_close():
    q = SubmissionQueue(maxsize=4)
    assert q.wait_nonempty(0.01) is False
    q.put(1.0, None, meta=0)
    assert q.wait_nonempty(0.01) is True
    q.drain_remaining()
    q.close()
    assert q.wait_nonempty(5.0) is False and q.closed


# -- liveness config ---------------------------------------------------------

def test_resolve_alive_validation():
    hb = HeartbeatMonitor(2, stale_after=1.0)
    with pytest.raises(ValueError, match="not both"):
        resolve_alive(2, np.ones(2, bool), hb)
    with pytest.raises(ValueError, match="unsharded"):
        resolve_alive(0, None, hb)
    with pytest.raises(ValueError, match="unsharded|alive"):
        resolve_alive(0, np.ones(2, bool), None)
    with pytest.raises(ValueError, match="shards"):
        resolve_alive(3, None, hb)
    with pytest.raises(ValueError, match="shape"):
        resolve_alive(2, np.ones(3, bool), None)
    np.testing.assert_array_equal(resolve_alive(2, None, hb), [True, True])
    np.testing.assert_array_equal(resolve_alive(0, None, None), [True])
    np.testing.assert_array_equal(
        resolve_alive(2, np.array([True, False]), None), [True, False])


def test_heartbeat_staleness_and_suppression():
    clk = FakeClock(100.0)
    hb = HeartbeatMonitor(2, stale_after=2.0, clock=clk)
    assert hb.alive().all()
    clk.t = 101.0
    hb.beat(0)
    clk.t = 103.0                            # shard 1's last beat: t=100
    np.testing.assert_array_equal(hb.alive(), [True, False])
    hb.beat(1)
    assert hb.alive().all()
    hb.suppress(1)                           # straggler: beats dropped
    clk.t = 105.0
    hb.beat(0)
    hb.beat(1)                               # dropped: shard 1 stays at 103
    clk.t = 106.0
    np.testing.assert_array_equal(hb.alive(), [True, False])
    snap = hb.snapshot()
    assert snap["alive"] == [True, False] and snap["suppressed"] == [False,
                                                                     True]
    hb.restore(1)
    assert hb.alive().all()
    with pytest.raises(IndexError):
        hb.beat(2)
    with pytest.raises(ValueError):
        HeartbeatMonitor(0)


# -- lane eviction (device op) -----------------------------------------------

def test_evict_lanes_parks_only_flagged_lanes(port_index, queries):
    lanes = LaneBatch(port_index, "adaptive_local", k_cap=6, efs_cap=24,
                      bsz=2)
    full = lanes.backend.full_row()
    q = port_index._prep_query(queries[:2]).numpy()
    lanes.admit([(("a",), q[0], full, 1.0, 24), (("b",), q[1], full, 1.0, 24)])
    lanes.step(2)
    lanes.evict([0])
    assert lanes.meta[0] is None and lanes.meta[1] is not None
    live = lanes.step(0)                     # run lane 1 to convergence
    assert not live.any(), "evicted lanes must report live=False"
    ids, dists = lanes.finalize(np.ones(1, bool))
    assert (ids[0] == -1).all(), "an evicted lane finalizes to all -1"
    np.testing.assert_array_equal(ids[1][:6],
                                  _single_ids(port_index, queries[1], 6, 24),
                                  err_msg="surviving lane must be intact")


# -- SearchService (manual driver, fake clock) -------------------------------

def test_service_serves_and_matches_single_query_oracle(port_index, queries):
    n = port_index.graph.n
    svc = SearchService(_db(port_index, n), k_cap=6, efs_cap=24,
                        max_batch=4, step_iters=4)
    futs, cuts = [], [n // 8, n // 3, n // 2, n, 2 * n // 3, n // 5]
    for j, cut in enumerate(cuts):
        futs.append(svc.submit(queries[j], plan=_cut_plan(cut), k=6))
    _drive(svc, futs)
    for j, (cut, f) in enumerate(zip(cuts, futs)):
        r = f.result(timeout=0)
        assert r.status == "ok" and not r.degraded
        np.testing.assert_array_equal(
            np.asarray(r.ids), _single_ids(port_index, queries[j], 6, 24, cut))
    assert len({f.result(timeout=0).rid for f in futs}) == len(futs)
    assert svc.shutdown(timeout=WAIT_S)


def test_service_queue_expiry_is_timeout_never_partial_ids(port_index,
                                                          queries):
    """A request whose deadline passes while still queued resolves to
    Response.timeout with ALL ids -1 -- no lane, no partial id list."""
    clk = FakeClock(0.0)
    svc = SearchService(_db(port_index, port_index.graph.n), k_cap=6,
                        efs_cap=24, max_batch=1, step_iters=2, clock=clk)
    # admission is deadline-ordered: the EARLIER deadline takes the only
    # lane, leaving f_dead queued past its own deadline
    f_first = svc.submit(queries[0], k=6, deadline_s=3.0)
    f_dead = svc.submit(queries[1], k=6, deadline_s=5.0)
    svc._tick()                                      # admits f_first only
    assert svc.lanes.occupied_count() == 1 and not f_dead.done()
    clk.t = 10.0                                     # f_dead expires queued
    svc._tick()
    r = f_dead.result(timeout=0)
    assert r.timeout and r.status == "timeout"
    assert (np.asarray(r.ids) == -1).all() and np.isinf(r.dists).all()
    assert r.exec_ms == 0.0, "an expired-in-queue request never ran"
    assert f_first.done(), "the overdue lane must be evicted too"
    assert svc.shutdown(timeout=WAIT_S)


def test_service_midflight_eviction_timeout_when_k_uncovered(port_index,
                                                             queries):
    """A lane evicted mid-flight whose selection holds fewer than k valid
    nodes can never cover k: it resolves to timeout (all -1), and its lane
    is reusable afterwards."""
    clk = FakeClock(0.0)
    svc = SearchService(_db(port_index, port_index.graph.n), k_cap=6,
                        efs_cap=24, max_batch=1, step_iters=1, clock=clk)
    f = svc.submit(queries[0], plan=_cut_plan(3), k=6,   # |S|=3 < k=6
                   deadline_s=5.0)
    svc._tick()                                      # admit + 1 chunk
    assert svc.lanes.occupied_count() == 1
    clk.t = 10.0
    svc._tick()                                      # overdue -> evict
    r = f.result(timeout=0)
    assert r.status == "timeout" and (np.asarray(r.ids) == -1).all()
    assert svc.lanes.occupied_count() == 0, "evicted lane must free up"
    f2 = svc.submit(queries[1], k=6)                 # lane is reusable
    _drive(svc, [f2])
    assert f2.result(timeout=0).status == "ok"
    np.testing.assert_array_equal(f2.result(timeout=0).ids,
                                  _single_ids(port_index, queries[1], 6, 24))
    assert svc.n_timeout == 1
    assert svc.shutdown(timeout=WAIT_S)


def test_service_midflight_eviction_salvages_partial(port_index, queries):
    """An evicted lane whose beam already covers k valid candidates comes
    back status='partial' with k real ids (best-effort answer)."""
    clk = FakeClock(0.0)
    svc = SearchService(_db(port_index, port_index.graph.n), k_cap=4,
                        efs_cap=16, max_batch=1, step_iters=1, clock=clk)
    f = svc.submit(queries[0], k=4, deadline_s=5.0)  # unfiltered
    for _ in range(4):                               # a few iterations in
        svc._tick()
    if f.done():                                     # converged already:
        assert f.result(timeout=0).status == "ok"    # nothing to evict
        assert svc.shutdown(timeout=WAIT_S)
        return
    clk.t = 10.0
    svc._tick()
    r = f.result(timeout=0)
    if r.status == "ok":                             # converged in the
        assert svc.shutdown(timeout=WAIT_S)          # in-flight chunk
        return                                       # before the check
    assert r.status == "partial" and not r.timeout
    assert (np.asarray(r.ids) >= 0).all() and len(r.ids) == 4
    assert svc.n_partial == 1
    assert svc.shutdown(timeout=WAIT_S)


def test_service_shutdown_drains_every_rid_exactly_once(port_index, queries):
    n = port_index.graph.n
    svc = SearchService(_db(port_index, n), k_cap=6, efs_cap=24,
                        max_batch=2, step_iters=3)
    futs = [svc.submit(queries[j % len(queries)],
                       plan=_cut_plan(n // (j + 2)), k=6)
            for j in range(9)]
    assert svc.shutdown(drain=True, timeout=WAIT_S)  # drains inline
    rids = [f.result(timeout=0).rid for f in futs]
    assert sorted(rids) == sorted(set(rids)) and len(rids) == 9
    assert all(f.result(timeout=0).status == "ok" for f in futs)
    assert svc.n_done == 9 and svc.n_submitted == 9
    with pytest.raises(ServiceClosed):
        svc.submit(queries[0], k=6)
    assert svc.shutdown(timeout=WAIT_S)              # idempotent


def test_service_shutdown_without_drain_cancels(port_index, queries):
    svc = SearchService(_db(port_index, port_index.graph.n), k_cap=6,
                        efs_cap=24, max_batch=1, step_iters=1)
    f_run = svc.submit(queries[0], k=6)
    f_queued = svc.submit(queries[1], k=6)
    svc._tick()                              # f_run takes the lane
    assert svc.lanes.step_pending
    assert svc.shutdown(drain=False, timeout=WAIT_S)
    assert f_run.cancelled() and f_queued.cancelled()
    assert svc.lanes.occupied_count() == 0 and not svc.lanes.step_pending


def test_service_shutdown_join_timeout_leaves_thread_owner(port_index,
                                                           queries):
    """If join() times out, the background thread still owns the lane
    state: shutdown must NOT tick inline, must keep the thread handle, and
    must report not-drained (False). A later shutdown call finishes once
    the thread has exited."""
    n = port_index.graph.n
    svc = SearchService(_db(port_index, n), k_cap=6, efs_cap=24,
                        max_batch=2, step_iters=3)
    futs = [svc.submit(queries[j % len(queries)],
                       plan=_cut_plan(n // (j + 2)), k=6)
            for j in range(5)]
    # stand-in for a device loop that outlives the join timeout: a thread
    # we gate explicitly, so the race window is deterministic
    release = threading.Event()
    stuck = threading.Thread(target=release.wait, args=(WAIT_S,))
    stuck.start()
    svc._thread = stuck
    assert svc.shutdown(drain=True, timeout=0.05) is False
    assert not svc.closed and svc._thread is stuck
    assert not any(f.done() for f in futs), \
        "shutdown must not drain inline while the thread is alive"
    release.set()
    assert svc.shutdown(drain=True, timeout=WAIT_S) is True
    assert svc.closed
    rids = [f.result(timeout=0).rid for f in futs]
    assert sorted(rids) == sorted(set(rids)) and len(rids) == 5


def test_service_sel_cache_is_lru_bounded(port_index, queries):
    """The prefilter memo is an LRU with a size cap: distinct selection
    subqueries beyond the cap evict the oldest entry, and an evicted Q_S
    is re-prefiltered (its next carrier pays wall time again)."""
    n = port_index.graph.n
    svc = SearchService(_db(port_index, n), k_cap=6, efs_cap=24,
                        max_batch=4, step_iters=4, sel_cache_size=2)
    cuts = [n // 2, n // 3, n // 4]          # 3 distinct Q_S, cap 2
    futs = [svc.submit(queries[j], plan=_cut_plan(c), k=6)
            for j, c in enumerate(cuts)]
    assert len(svc._sel_cache) == 2, "cache must stay at its cap"
    _drive(svc, futs)
    assert all(f.result(timeout=0).prefilter_ms > 0 for f in futs), \
        "each first carrier pays its prefilter"
    f_again = svc.submit(queries[0], plan=_cut_plan(cuts[0]), k=6)
    _drive(svc, [f_again])
    assert f_again.result(timeout=0).prefilter_ms > 0, \
        "an evicted Q_S must be re-prefiltered, not served stale"
    f_hit = svc.submit(queries[1], plan=_cut_plan(cuts[0]), k=6)
    _drive(svc, [f_hit])
    assert f_hit.result(timeout=0).prefilter_ms == 0.0
    n_ans = svc.n_done
    assert svc.shutdown(drain=True, timeout=WAIT_S)
    assert svc.n_done == n_ans, "shutdown answers nothing twice"
    with pytest.raises(ValueError, match="sel_cache_size"):
        SearchService(svc.db, sel_cache_size=0)


def test_service_backpressure_reject_via_submit(port_index, queries):
    svc = SearchService(_db(port_index, port_index.graph.n), k_cap=6,
                        efs_cap=24, max_batch=1, queue_size=4,
                        policy="reject", high_watermark=2, low_watermark=1)
    svc.submit(queries[0], k=6)
    svc.submit(queries[1], k=6)
    with pytest.raises(QueueFull):
        svc.submit(queries[2], k=6)
    assert svc.gauges()["queue"]["gated"]
    assert svc.shutdown(drain=True, timeout=WAIT_S)


def test_service_rejects_requests_exceeding_program_caps(port_index,
                                                         queries):
    db = _db(port_index, port_index.graph.n)
    svc = SearchService(db, k_cap=6, efs_cap=24)
    with pytest.raises(ValueError, match="caps"):
        svc.submit(queries[0], k=7)
    with pytest.raises(ValueError, match="heuristic"):
        svc.submit(queries[0],
                   plan=KnnSearch(child=None, table="Chunk", k=4,
                                  heuristic="onehop_a"))
    with pytest.raises(ValueError, match="no catalog index"):
        SearchService(db, index="missing")
    assert svc.shutdown(timeout=WAIT_S)


def test_service_rejects_shard_liveness_on_an_unsharded_index(port_index):
    db = _db(port_index, port_index.graph.n)
    with pytest.raises(ValueError, match="unsharded"):
        SearchService(db, heartbeats=HeartbeatMonitor(2))
    with pytest.raises(ValueError, match="unsharded|alive"):
        SearchService(db, alive=np.ones(2, bool))


def test_service_thread_driver_end_to_end(port_index, queries):
    """``db.serve()`` with the background thread: two client threads
    submit, every future resolves ``ok`` equal to the single-query search,
    and a draining shutdown returns."""
    n = port_index.graph.n
    svc = _db(port_index, n).serve(k_cap=6, efs_cap=24, max_batch=4,
                                   step_iters=4).start()
    futs = {}
    lock = threading.Lock()

    def client(lo):
        for j in range(lo, lo + 4):
            f = svc.submit(queries[j], plan=_cut_plan(n // (j + 1)), k=6)
            with lock:
                futs[j] = f

    threads = [threading.Thread(target=client, args=(lo,)) for lo in (0, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    out = {j: f.result(timeout=WAIT_S) for j, f in futs.items()}
    assert svc.shutdown(drain=True, timeout=WAIT_S)
    assert svc.closed and svc.n_done == 8
    assert len({r.rid for r in out.values()}) == 8
    for j, r in out.items():
        assert r.status == "ok"
        np.testing.assert_array_equal(
            r.ids, _single_ids(port_index, queries[j], 6, 24, n // (j + 1)))
    g = svc.gauges()
    assert g["in_flight"] == 0 and g["queue"]["depth"] == 0
    assert g["p50_ms"] >= 0 and g["p99_ms"] >= g["p50_ms"]
    assert g["chunks"]["n_chunks"] > 0


def test_serve_returns_a_service_on_the_dbs_device(port_index):
    db = _db(port_index, port_index.graph.n)
    svc = db.serve(k_cap=5, efs_cap=20, max_batch=3)
    assert isinstance(svc, SearchService)
    assert svc.entry.name == "default" and svc.lanes.bsz == 4
    assert svc.lanes.device.type == "cpu" and svc.efs_cap == 20
    assert svc.shutdown(timeout=WAIT_S)


def test_service_asubmit(port_index, queries):
    """The asyncio driver awaits a response produced by the thread loop."""
    import asyncio
    n = port_index.graph.n
    svc = _db(port_index, n).serve(k_cap=6, efs_cap=24, max_batch=2).start()

    async def go():
        return await asyncio.wait_for(
            svc.asubmit(queries[0], plan=_cut_plan(n // 2), k=6), WAIT_S)

    r = asyncio.run(go())
    assert svc.shutdown(drain=True, timeout=WAIT_S)
    assert r.status == "ok"
    np.testing.assert_array_equal(
        r.ids, _single_ids(port_index, queries[0], 6, 24, n // 2))


# -- against the reference's SearchService -----------------------------------

def test_service_matches_reference_per_request(index, port_index, queries):
    """The same submissions, deadlines and ticks on both packages'
    services (fake clock, manual driver): per request the same status,
    ids equal and dists allclose."""
    n = port_index.graph.n
    jstore = JGraphStore()
    jstore.add_node_table("Chunk", n, {"cID": np.arange(n)})
    jdb = JNavixDB(jstore)
    jdb.register_index("default", index)
    jclk, tclk = FakeClock(0.0), FakeClock(0.0)
    kw = dict(k_cap=6, efs_cap=24, max_batch=2, step_iters=3)
    jsvc = JSearchService(jdb, clock=jclk, **kw)
    tsvc = SearchService(_db(port_index, n), clock=tclk, **kw)
    cuts = [n // 3, 3, n, n // 5, n // 2, n // 7]
    deadlines = [None, 1.0, None, None, 1.0, None]
    futs = {"j": [], "t": []}
    for j, (cut, ddl) in enumerate(zip(cuts, deadlines)):
        futs["j"].append(jsvc.submit(queries[j], deadline_s=ddl, k=6,
                                     plan=jops.Filter(jops.NodeScan("Chunk"),
                                                      "cID", "<", value=cut)))
        futs["t"].append(tsvc.submit(queries[j], plan=_cut_plan(cut), k=6,
                                     deadline_s=ddl))
    for tick in range(200):
        if all(f.done() for f in futs["j"] + futs["t"]):
            break
        if tick == 2:
            jclk.t = tclk.t = 5.0            # the deadlined requests expire
        jsvc._tick()
        tsvc._tick()
    for fj, ft in zip(futs["j"], futs["t"]):
        rj, rt = fj.result(timeout=0), ft.result(timeout=0)
        assert rt.status == rj.status and rt.rid == rj.rid
        np.testing.assert_array_equal(rt.ids, np.asarray(rj.ids))
        np.testing.assert_allclose(rt.dists, np.asarray(rj.dists), rtol=1e-5)
        assert rt.sigma == pytest.approx(rj.sigma, rel=1e-6)
    assert {r.result(timeout=0).status for r in futs["t"]} >= {"ok"}
    assert jsvc.shutdown(timeout=WAIT_S) and tsvc.shutdown(timeout=WAIT_S)


# -- the command-line entry point -------------------------------------------

def test_launch_serve_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--n", "1500", "--requests", "16"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr
    assert "served 16 requests" in proc.stdout
    assert "on cpu" in proc.stdout and "p99_ms" in proc.stdout
