"""The port's runtime guards (``repro_torch.analysis.runtime``): the
counterparts of the reference's runtime-guard tests
(``tests/test_analysis.py``'s lock-order, zero-recompile and donation
cases, and ``tests/test_quantized_resident.py``'s zero steady-state
compiles across a bucket), on the port's entry points, on the CPU.

The lock monitor runs the reference's drills over the port's queue,
threaded service and a 2-shard straggler service on a CPU grid. The
compile counter counts the port's own events: ``ProgramCache`` entries
(``"program"``; each one equals a cache miss) and ``nvcc`` runs of
``kernels._build.load`` (``"nvcc"``, driven here by a stand-in compiler;
the card's test in ``tests/test_torch_cuda.py`` runs the real one). The
in-flight guard holds ``LaneBatch``'s window from ``step_async`` to
``step_wait``. Every guard restores what it patched, also when its block
raises, and lets the error through.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro.data.synthetic import gaussian_mixture
from repro_torch.analysis import runtime
from repro_torch.analysis.runtime import (CompileCounter, DonationError,
                                          LockOrderMonitor, guard_donation,
                                          instrument_locks, record_compile)
from repro_torch.api import NavixDB, ProgramCache, Q
from repro_torch.core.distributed import ShardedNavix, make_mesh
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.kernels import _build
from repro_torch.query.operators import Filter, NodeScan
from repro_torch.serving import HeartbeatMonitor, SearchService
from repro_torch.serving.lanes import LaneBatch
from repro_torch.storage.columnar import GraphStore

WAIT_S = 60.0


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


@pytest.fixture(scope="module")
def port_shards():
    """A 2-shard port ShardedNavix on a CPU grid over the reference's
    ``shard_env`` data, and its queries."""
    X, _, centers = gaussian_mixture(640, 16, 8, seed=0)
    rng = np.random.default_rng(7)
    base = centers[rng.integers(0, len(centers), size=8)]
    qs = (base + 0.25 * rng.normal(size=base.shape)).astype(np.float32)
    cfg = NavixConfig(m_u=8, ef_construction=48, metric="l2", seed=0)
    return ShardedNavix.build(X, cfg, make_mesh((1, 2), device="cpu")), qs


def _db(idx, n):
    store = GraphStore()
    store.add_node_table("Chunk", n, {"cID": np.arange(n)})
    db = NavixDB(store, device="cpu")
    db.register_index("default", idx)
    return db


# -- lock-order runtime guard ------------------------------------------------

def test_lock_order_detects_abba_cycle():
    with instrument_locks() as mon:
        a = threading.Lock()
        b = threading.Lock()

        def fwd():
            with a:
                with b:
                    pass

        def rev():
            with b:
                with a:
                    pass

        for fn in (fwd, rev):
            t = threading.Thread(target=fn)
            t.start()
            t.join(WAIT_S)
            assert not t.is_alive()
    cycles = mon.cycles()
    assert cycles, "A->B and B->A acquisitions must report a cycle"
    assert mon.report()["cycles"]
    assert any(site.startswith("test_torch_runtime.py:")
               for site in mon.sites)


def test_lock_order_nested_same_order_is_clean():
    with instrument_locks() as mon:
        outer = threading.Lock()
        inner = threading.Lock()
        for _ in range(3):
            with outer:
                with inner:
                    pass
    assert mon.edges and not mon.cycles()


def test_lock_order_clean_across_queue_herd():
    """The thundering-herd drill under the monitor: blocked putters
    waking through the backpressure gate must not create lock-order
    cycles (Condition wait/notify runs through the instrumented lock)."""
    from repro_torch.serving import SubmissionQueue
    with instrument_locks() as mon:
        q = SubmissionQueue(maxsize=4, policy="block",
                            high_watermark=2, low_watermark=1)
        q.put(1.0, None, meta=0)
        q.put(1.0, None, meta=1)                 # depth == high -> gated
        started = []
        threads = [threading.Thread(
            target=lambda j=j: started.append(q.put(1.0, None, meta=j)))
            for j in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        deadline = time.monotonic() + 5.0
        while len(started) < 3 and time.monotonic() < deadline:
            q.pop_batch(2)
            time.sleep(0.01)
        for t in threads:
            t.join(5.0)
            assert not t.is_alive()
        assert len(started) == 3
    assert mon.sites, "the queue's locks were not instrumented"
    assert mon.cycles() == [], mon.report()


def test_lock_order_clean_across_threaded_shutdown(port_index, queries):
    """Threaded service lifecycle (start -> submit -> drain shutdown)
    under the monitor: the submit path (submit/lat locks), the device
    loop, and the queue's close/wake path must stay acyclic."""
    n = port_index.graph.n
    with instrument_locks() as mon:
        db = _db(port_index, n)
        with db.serve(k_cap=6, efs_cap=24, max_batch=4,
                      step_iters=4) as svc:
            futs = [svc.submit(
                queries[j],
                plan=Filter(NodeScan("Chunk"), "cID", "<",
                            value=n // (j + 1)), k=6)
                for j in range(6)]
            out = [f.result(timeout=WAIT_S) for f in futs]
        assert all(r.status == "ok" for r in out)
        assert svc.gauges()["done"] == 6
    assert any(s.startswith("service.py:") for s in mon.sites)
    assert mon.cycles() == [], mon.report()


def test_lock_order_clean_across_straggler_heartbeat(port_shards):
    """The sharded straggler drill at S = 2 on a CPU grid (a suppressed
    heartbeat flips responses to degraded) under the monitor --
    heartbeat, queue and service locks interleave across beats, ticks
    and finalize."""
    sn, qs = port_shards
    n = sn.n_total

    class Clk:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clk()
    with instrument_locks() as mon:
        hb = HeartbeatMonitor(2, stale_after=2.0, clock=clk)
        db = _db(sn, n)
        svc = SearchService(db, k_cap=6, efs_cap=24, max_batch=4,
                            step_iters=4, heartbeats=hb)

        def drive(futs):
            for _ in range(500):
                if all(f.done() for f in futs):
                    return [f.result(timeout=0) for f in futs]
                svc._tick()
            raise AssertionError("service did not converge")

        plan = Filter(NodeScan("Chunk"), "cID", "<", value=n // 2)
        drive([svc.submit(qs[j], plan=plan, k=6) for j in range(4)])
        hb.suppress(1)
        clk.t = 10.0
        hb.beat(0)
        resps = drive([svc.submit(qs[j], plan=plan, k=6)
                       for j in range(4)])
        assert all(r.degraded for r in resps), \
            "stale heartbeat must degrade responses"
        svc.shutdown(drain=True)
    assert any(s.startswith("heartbeat.py:") for s in mon.sites)
    assert mon.cycles() == [], mon.report()


def test_lock_order_monitor_standalone_api():
    mon = LockOrderMonitor()
    mon._acquired("a.py:1")
    mon._acquired("b.py:2")
    mon._released("b.py:2")
    mon._released("a.py:1")
    mon._acquired("b.py:2")
    mon._acquired("a.py:1")
    assert mon.cycles() == [["a.py:1", "b.py:2", "a.py:1"]]
    assert mon.report() == {"sites": 2, "edges": 2,
                            "cycles": ["a.py:1 -> b.py:2 -> a.py:1"]}


def test_instrumented_lock_serves_a_condition():
    with instrument_locks() as mon:
        lock = threading.Lock()
        cond = threading.Condition(lock)
        box = []

        def waiter():
            with cond:
                cond.wait_for(lambda: box, timeout=WAIT_S)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.02)
        with cond:
            box.append(1)
            cond.notify_all()
        t.join(WAIT_S)
        assert not t.is_alive()
        assert not lock.locked()
    assert mon.sites and mon.cycles() == []


def test_guards_restore_what_they_patched_when_the_block_raises():
    real_lock = threading.Lock
    originals = {name: getattr(LaneBatch, name) for name in
                 ("step_async", "step_wait", "admit", "finalize", "evict")}
    with pytest.raises(KeyError):
        with instrument_locks():
            assert threading.Lock is not real_lock
            raise KeyError("through")
    assert threading.Lock is real_lock
    with pytest.raises(KeyError):
        with guard_donation():
            assert LaneBatch.admit is not originals["admit"]
            raise KeyError("through")
    assert {name: getattr(LaneBatch, name) for name in originals} \
        == originals
    with pytest.raises(KeyError):
        with CompileCounter() as cc:
            raise KeyError("through")
    record_compile(runtime.PROGRAM)                # cc is no longer active
    assert cc.total == 0 and cc not in runtime._active_counters


# -- zero-recompile runtime guard --------------------------------------------

def test_compile_counter_counts_then_cache_hits_zero(port_index, queries):
    idx = dataclasses.replace(port_index, program_cache=ProgramCache())
    cache = idx.program_cache
    with CompileCounter() as cc:
        idx.search_many(queries[:7], k=5, efs=20)
        assert cc.counts["warmup"] >= 1
        assert cc.count("program") == cache.stats.misses == 1
        cc.mark("steady")
        idx.search_many(queries[:7], k=5, efs=20)
        idx.search_many(queries[:5], k=5, efs=20)     # same bucket (8)
    assert cc.counts["steady"] == 0, cc.counts
    assert cache.stats.hits == 2
    assert cc.total == sum(cc.counts.values())
    assert cc.kinds == {"warmup": {"program": 1}, "steady": {}}
    # a phase marked again resumes its count
    with cc:
        idx.search_many(queries[:12], k=5, efs=20)    # bucket 16: an entry
        cc.mark("warmup")
        record_compile(runtime.NVCC)
    assert cc.counts == {"warmup": 2, "steady": 1}
    assert cc.count("nvcc") == 1 and cc.count("program", "steady") == 1


def test_db_execute_bucket_reuse_compiles_nothing(port_index):
    """The ProgramCache bucketing claim at the port's compile hook: after
    a warm execute at bucket 8, a different batch size in the same bucket
    and a different predicate make ZERO new entries."""
    n = port_index.graph.n
    db = _db(port_index, n)
    rng = np.random.default_rng(3)
    qs = rng.normal(size=(8, port_index.graph.dim)).astype(np.float32)

    plan = Q.match("Chunk").where("cID", "<", n // 2).knn(k=5, efs=20)
    with CompileCounter() as cc:
        db.execute(plan, query=qs[:7])               # bucket 8 (cold)
        cc.mark("steady")
        db.execute(plan, query=qs[:5])               # same bucket
        db.execute(Q.match("Chunk").where("cID", "<", n // 3)
                   .knn(k=5, efs=20), query=qs[:8])  # new predicate
    assert cc.counts["steady"] == 0, cc.counts
    assert cc.count("program", "warmup") == db.programs.stats.misses == 1


def test_zero_steady_state_compiles_across_bucket(port_index, queries):
    """After warming one batch bucket, quantized searches at other batch
    sizes in the bucket compile NOTHING."""
    idx = dataclasses.replace(port_index, program_cache=ProgramCache(),
                              _qview=None, quantized=None)
    with CompileCounter() as cc:
        idx.search_quantized_many(queries[:8], k=6, efs=24)    # warm
        cc.mark("steady")
        idx.search_quantized_many(queries[:5], k=6, efs=24)
        idx.search_quantized_many(queries[:7], k=6, efs=24)
        idx.search_quantized_many(queries[:8], k=6, efs=24)
    assert cc.counts.get("steady", 0) == 0, cc.counts
    assert cc.count("program", "warmup") == 1


_FAKE_NVCC = """\
import sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"not a real library")
"""


def test_nvcc_runs_count_once_and_reuse_counts_zero(tmp_path, monkeypatch):
    """``_build.load`` reports each nvcc run and nothing else: a library
    loaded in this process, or found in the build directory, is no
    event. A stand-in compiler writes the library; ctypes is stubbed."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n{_FAKE_NVCC}")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    with CompileCounter() as cc:
        _build.load("cuda_error")
        assert cc.count("nvcc") == 1
        cc.mark("steady")
        _build.load("cuda_error")                    # loaded in-process
        _build._loaded.clear()
        _build.load("cuda_error")                    # reused from disk
    assert cc.counts == {"warmup": 1, "steady": 0}
    assert cc.kinds["warmup"] == {"nvcc": 1}


# -- the in-flight guard --------------------------------------------------------

def _lane_batch(idx, queries, bsz=2):
    lanes = LaneBatch(idx, "adaptive_local", k_cap=6, efs_cap=24, bsz=bsz)
    full = lanes.backend.full_row()
    q = idx._prep_query(np.stack(queries[:bsz])).numpy()
    lanes.admit([((j,), q[j], full, 1.0, 24) for j in range(bsz)])
    return lanes


def test_donation_guard_blocks_lane_state_access_in_flight(port_index,
                                                           queries):
    """Inside a step_async/step_wait window the chunk owns the lane
    state: evict/finalize/admit raise, host mirrors are frozen. After
    step_wait everything is legal again."""
    with guard_donation() as g:
        lanes = _lane_batch(port_index, queries)
        lanes.step_async(2)
        with pytest.raises(DonationError):
            lanes.evict([0])
        with pytest.raises(DonationError):
            lanes.finalize(np.ones(1, bool))
        with pytest.raises(DonationError):
            lanes.admit([])
        for name in ("Qh", "selh", "sigh", "efsh"):
            with pytest.raises(ValueError):
                getattr(lanes, name)[0] = 0            # frozen mirror
        lanes.step_wait()
        lanes.finalize(np.ones(1, bool))
        lanes.evict([0, 1])
        lanes.Qh[0] = 0.0                              # thawed
    assert g.windows == 1
    assert len(g.violations) == 3
    assert g.report()["windows"] == 1
    # class-wide patch restored on exit
    assert LaneBatch.step_async.__qualname__.startswith("LaneBatch.")


def test_donation_guard_freezes_the_sharded_sel_mirror(port_shards):
    """A sharded LaneBatch's ``selh`` is a numpy [S, B, W] array: it
    freezes in the window like the flat one."""
    sn, qs = port_shards
    with guard_donation() as g:
        lanes = _lane_batch(sn, qs)
        assert lanes.selh.ndim == 3
        lanes.step_async(1)
        with pytest.raises(ValueError):
            lanes.selh[:, 0] = 0
        lanes.step_wait()
        lanes.selh[:, 0] = lanes.selh[:, 0]
    assert g.windows == 1 and g.violations == []


def test_donation_guard_is_transparent_to_a_clean_stepping_loop(
        port_index, queries):
    """The synchronous step() spelling and the admit->step->finalize
    cycle run unchanged under the guard (windows counted, nothing
    raised) and give the unguarded answer -- the guard must not perturb
    what it measures."""
    plain = _lane_batch(port_index, queries)
    plain.step(2)
    plain.step(0)
    want = plain.finalize(np.ones(1, bool))
    with guard_donation() as g:
        lanes = _lane_batch(port_index, queries)
        lanes.step(2)
        lanes.step(0)
        ids, dists = lanes.finalize(np.ones(1, bool))
        assert ids.shape[0] == 2
    assert g.windows == 2 and g.violations == []
    assert np.array_equal(ids, want[0]) and np.array_equal(dists, want[1])


def test_regression_nondrain_shutdown_waits_for_inflight_chunk(
        port_index, queries):
    """``shutdown(drain=False)`` joins the loop thread right after a tick
    dispatched a chunk, so it lands with that chunk in flight; it must
    step_wait before evicting the occupied lanes. The whole lifecycle
    runs clean under the guard."""
    n = port_index.graph.n
    db = _db(port_index, n)
    with guard_donation() as g:
        svc = db.serve(k_cap=6, efs_cap=24, max_batch=4,
                       step_iters=1).start()
        futs = [svc.submit(queries[j], k=6) for j in range(6)]
        time.sleep(0.02)             # let the loop dispatch chunks
        assert svc.shutdown(drain=False, timeout=WAIT_S)
        for f in futs:
            assert f.done()
    assert g.violations == []
