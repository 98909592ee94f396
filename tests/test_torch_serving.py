"""The port's closed-queue serving tier (``SearchEngine``, ``LaneBatch``)
against itself and against the JAX package's.

Inside the port, as the reference holds itself (``tests/test_serving.py``,
``tests/test_overlap.py``): every rid answered exactly once; continuous ==
grouped == the single-query search, bit for bit; work issued while a chunk
is in flight == the synchronous order. Against the reference, on the same
index (``conftest.index``, carried across with ``graph_from_numpy``), store,
plans and queries: per rid ids equal, dists allclose at rtol 1e-5 (XLA and
torch may sum in another order; the tolerance of
``tests/test_torch_search.py``), sigma equal, f32 and int8.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.query import operators as jops
from repro.serving.engine import SearchEngine as JSearchEngine
from repro.storage.columnar import GraphStore as JGraphStore
from repro_torch.core import bitset
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.query.operators import Filter, KnnSearch, NodeScan
from repro_torch.serving import greedy_generate
from repro_torch.serving.engine import SearchEngine
from repro_torch.serving.lanes import LaneBatch, make_backend
from repro_torch.storage.columnar import GraphStore

K, EFS = 6, 24


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


def _store(n, package=GraphStore):
    store = package()
    store.add_node_table("Chunk", n, {"cID": np.arange(n)})
    return store


def _engine(idx, **kw):
    return SearchEngine(index=idx, store=_store(idx.graph.n), **kw)


def _cut(cut):
    return Filter(NodeScan("Chunk"), "cID", "<", value=cut)


def _knn(cut, k=K, efs=0):
    return KnnSearch(child=_cut(cut), k=k, efs=efs)


def _single(idx, q, k, efs, cut):
    res = idx.search(q, k=k, efs=efs, semimask=np.arange(idx.graph.n) < cut)
    return res.ids.numpy(), res.dists.numpy()


# -- ports of tests/test_serving.py (the unsharded cases) ---------------------


def test_continuous_scheduler_mixed_plans_exactly_once(port_index, queries):
    """Mixed-plan fusing under refill: more requests than lanes, every
    plan distinct, every rid answered exactly once -- and each response
    is bitwise the single-query search over that request's own S."""
    n = port_index.graph.n
    eng = _engine(port_index, efs=30, max_batch=4, scheduler="continuous",
                  step_iters=3, refill_threshold=1)
    cutoffs = [n // 10, n // 5, n // 3, n // 2, 2 * n // 3, n,
               n // 8, n // 4, 3 * n // 4, n // 2, n // 6, n]
    rids = {}
    for j, cut in enumerate(cutoffs):
        rid = eng.submit(queries[j % len(queries)], plan=_cut(cut), k=6)
        rids[rid] = (j, cut)
    responses = eng.drain()
    assert sorted(r.rid for r in responses) == sorted(rids), \
        "every rid must be answered exactly once"
    for r in responses:
        j, cut = rids[r.rid]
        assert r.sigma == pytest.approx(cut / n, abs=1e-6), \
            "Response.sigma must be the request's OWN selectivity"
        ids, dists = _single(port_index, queries[j % len(queries)], 6, 30,
                             cut)
        np.testing.assert_array_equal(r.ids, ids,
                                      err_msg=f"rid {r.rid} (cut={cut})")
        np.testing.assert_array_equal(r.dists, dists)
    assert eng.latency_summary()["n"] == len(cutoffs)


def test_refill_admits_while_other_lanes_still_live(port_index, queries):
    """Continuous scheduling, not batch-convergence scheduling: with more
    requests than lanes and refill_threshold=1, a converged lane is
    flushed and refilled from the queue while OTHER lanes still run."""
    n = port_index.graph.n
    eng = _engine(port_index, efs=30, max_batch=4, scheduler="continuous",
                  step_iters=1, refill_threshold=1)
    hooks = []
    eng.step_hook = lambda info: hooks.append(dict(info))
    cutoffs = [n // 20, n, n // 10, n // 2, n // 3, n, n // 4,
               n // 5, 3 * n // 4, n // 8, n, n // 6]
    rids = {eng.submit(queries[j % len(queries)], plan=_cut(cut), k=6)
            for j, cut in enumerate(cutoffs)}
    responses = eng.drain()
    assert sorted(r.rid for r in responses) == sorted(rids)
    staggered = [j for j in range(1, len(hooks))
                 if hooks[j]["pending"] < hooks[j - 1]["pending"]
                 and hooks[j - 1]["live"] > 0]
    assert staggered, (
        "every refill waited for whole-batch convergence (live==0); "
        f"hooks={[(h['pending'], h['live'], h['done']) for h in hooks]}")


def test_continuous_matches_grouped_reference(port_index, queries):
    """Same mixed workload through both schedulers: identical answers."""
    n = port_index.graph.n
    plans = [_cut(c) for c in (n // 4, n // 2, n, n // 3)]
    results = {}
    for sched in ("continuous", "grouped"):
        eng = _engine(port_index, efs=24, max_batch=8, scheduler=sched)
        rids = [eng.submit(queries[j], plan=plans[j % len(plans)], k=5)
                for j in range(8)]
        by = {r.rid: r for r in eng.drain()}
        results[sched] = [by[rid] for rid in rids]
    for a, b in zip(results["continuous"], results["grouped"]):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        assert a.sigma == pytest.approx(b.sigma)


def test_per_lane_k_capped_to_batch_max(port_index, queries):
    """Requests with different k fuse into one batch; each response is
    sliced to its own k."""
    n = port_index.graph.n
    eng = _engine(port_index, efs=40, max_batch=8, scheduler="continuous")
    ra = eng.submit(queries[0], plan=_cut(n // 2), k=3)
    rb = eng.submit(queries[1], plan=_cut(n // 3), k=9)
    by = {r.rid: r for r in eng.drain()}
    assert by[ra].ids.shape == (3,)
    assert by[rb].ids.shape == (9,)
    mask_b = np.arange(n) < n // 3
    assert mask_b[by[rb].ids[by[rb].ids >= 0]].all()


def test_unknown_scheduler_rejected(port_index, queries):
    eng = _engine(port_index, scheduler="nope")
    eng.submit(queries[0], k=3)
    with pytest.raises(ValueError, match="scheduler"):
        eng.drain()


@pytest.mark.parametrize("sched", ["continuous", "grouped"])
def test_alive_on_unsharded_index_rejected(port_index, queries, sched):
    """A quorum mask on an unsharded index is a misconfiguration; both
    schedulers surface it (the contract of NavixDB.execute(alive=...))."""
    eng = _engine(port_index, scheduler=sched, efs=20)
    eng.alive = np.array([True, False])
    eng.submit(queries[0], k=3)
    with pytest.raises(ValueError, match="unsharded|alive"):
        eng.drain()


def test_batched_requests(port_index, queries):
    n = port_index.graph.n
    eng = _engine(port_index, efs=60)
    rids = [eng.submit(q, plan=_cut(n // 2), k=5) for q in queries]
    rids += [eng.submit(queries[0], plan=None, k=5)]
    responses = eng.drain()
    assert len(responses) == len(rids)
    by_rid = {r.rid: r for r in responses}
    for rid in rids[:-1]:
        r = by_rid[rid]
        assert (r.ids[r.ids >= 0] < n // 2).all()
        assert r.sigma == pytest.approx(0.5, abs=0.01)
    summary = eng.latency_summary()
    assert summary["n"] == len(rids)
    assert summary["p99_ms"] >= summary["p50_ms"]


def test_what_waits_for_later_items_raises(port_index):
    """LM generation waits for ROADMAP Queue 1 item 17. Sharded serving
    has landed (``tests/test_torch_serving_sharded.py``); what is neither
    a NavixIndex nor a ShardedNavix is refused by name."""
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        make_backend(object(), None)
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        LaneBatch(object(), "adaptive_local", K, EFS, 2)
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        SearchEngine(index=SimpleNamespace(device=torch.device("cpu")),
                     store=_store(10))
    with pytest.raises(NotImplementedError, match="item 17"):
        greedy_generate(None, None, np.zeros((1, 4), np.int32), 2)


def test_engine_runs_on_its_index_device(port_index):
    eng = _engine(port_index)
    assert eng.db.device.type == "cpu"
    assert eng.db.index("default") is port_index


# -- ports of tests/test_overlap.py -------------------------------------------


def test_pack_np_bitwise_matches_pack():
    """The serving tier packs semimasks on the host; the numpy pack must
    stay bit-identical to the tensor pack for every width class."""
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 64, 100, 640):
        for shape in ((n,), (3, n), (2, 3, n)):
            mask = rng.random(shape) < 0.4
            np.testing.assert_array_equal(
                bitset.pack_np(mask).view(np.int32),
                bitset.pack(torch.from_numpy(mask)).numpy(),
                err_msg=f"n={n} shape={shape}")


def _admit_entries(idx, queries, cuts, efs_each):
    n = idx.graph.n
    prepped = idx._prep_query(np.stack([np.asarray(q, np.float32)
                                        for q in queries])).numpy()
    return [(("req", j), prepped[j], bitset.pack_np(np.arange(n) < cut),
             cut / n, efs_each[j]) for j, cut in enumerate(cuts)]


def test_work_issued_midflight_equals_synchronous_order(port_index, queries):
    """finalize / evict / admit issued BETWEEN step_async and step_wait
    queue behind the in-flight chunk -- results are bitwise the
    synchronous (step -> finalize -> evict -> admit) order."""
    n = port_index.graph.n
    cuts = [n // 5, n // 2, n, n // 3]
    entries = _admit_entries(port_index, queries[:4], cuts, [EFS] * 4)
    alive = np.ones(1, bool)

    a = LaneBatch(port_index, "adaptive_local", K, EFS, bsz=4)
    b = LaneBatch(port_index, "adaptive_local", K, EFS, bsz=4)
    a.admit(list(entries))
    b.admit(list(entries))

    a.step_async(3)
    assert a.step_pending
    ids_a, d_a = a.finalize(alive)
    a.evict([2])
    fresh = _admit_entries(port_index, queries[4:5], [n // 4], [EFS])
    assert a.admit(list(fresh)) == [2]
    live_a = a.step_wait()

    live_b = b.step(3)
    ids_b, d_b = b.finalize(alive)
    b.evict([2])
    assert b.admit(list(fresh)) == [2]

    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(d_a, d_b)
    np.testing.assert_array_equal(live_a, live_b)

    a.step(0)
    b.step(0)
    fin_a = a.finalize(alive)
    fin_b = b.finalize(alive)
    np.testing.assert_array_equal(fin_a[0], fin_b[0])
    np.testing.assert_array_equal(fin_a[1], fin_b[1])
    # the evicted-then-readmitted lane answered the NEW request
    ids, _ = _single(port_index, queries[4], K, EFS, n // 4)
    np.testing.assert_array_equal(fin_a[0][2][:K], ids)


def test_step_async_state_machine(port_index, queries):
    lanes = LaneBatch(port_index, "adaptive_local", K, EFS, bsz=2)
    with pytest.raises(RuntimeError, match="no device chunk"):
        lanes.step_wait()
    lanes.admit(_admit_entries(port_index, queries[:1],
                               [port_index.graph.n // 2], [EFS]))
    lanes.step_async(2)
    with pytest.raises(RuntimeError, match="in flight"):
        lanes.step_async(2)
    assert lanes.step_pending
    lanes.step_wait()
    assert not lanes.step_pending
    with pytest.raises(RuntimeError, match="no device chunk"):
        lanes.step_wait()
    t = lanes.timing()
    assert t["n_chunks"] == 1
    assert all(k in t for k in ("host_gap_ms", "dispatch_ms",
                                "host_overlap_ms", "device_wait_ms"))
    lanes.reset_timing()
    assert lanes.timing()["n_chunks"] == 0


def test_lane_batch_places_semimask_words_unchanged(port_index, queries):
    """Host uint32 rows become the port's int32 words with the same bits,
    and admission rejects more entries than free lanes."""
    n = port_index.graph.n
    lanes = LaneBatch(port_index, "adaptive_local", K, EFS, bsz=2)
    np.testing.assert_array_equal(lanes.backend.full_row(),
                                  bitset.pack_np(np.ones(n, bool)))
    entries = _admit_entries(port_index, queries[:3], [n // 3, n, n // 2],
                             [EFS] * 3)
    with pytest.raises(ValueError, match="free lanes"):
        lanes.admit(entries)
    lanes = LaneBatch(port_index, "adaptive_local", K, EFS, bsz=2)
    assert lanes.admit(entries[:2]) == [0, 1]
    np.testing.assert_array_equal(lanes.selj.numpy().view(np.uint32),
                                  lanes.selh)
    assert lanes.selh.dtype == np.uint32 and lanes.selj.dtype == torch.int32
    lanes.Qh[:] = 0                      # the device copy owns its memory
    assert lanes.Qj.abs().sum() > 0


def test_ragged_efs_explicit_vs_unset_policy(port_index, queries):
    """Only a plan that NAMES its efs gets the ragged (masked-tail) beam:
    explicit-efs responses equal the single-query search at that efs,
    unset-efs responses equal the search at the batch cap."""
    n = port_index.graph.n
    eng = _engine(port_index, efs=0, max_batch=8, scheduler="continuous",
                  step_iters=4)
    explicit = [(n // 2, 12), (n // 3, 30), (n, 16)]
    plans = [_knn(c, k=K, efs=e) for c, e in explicit]
    plans.append(_knn(n // 4, k=K, efs=0))
    rids = [eng.submit(queries[j], plan=p, k=K) for j, p in enumerate(plans)]
    by = {r.rid: r for r in eng.drain()}
    efs_cap = max(30, 2 * K)
    for j, (cut, efs) in enumerate(explicit):
        ids, dists = _single(port_index, queries[j], K, efs, cut)
        np.testing.assert_array_equal(by[rids[j]].ids, ids,
                                      err_msg=f"explicit efs={efs}")
        np.testing.assert_array_equal(by[rids[j]].dists, dists)
    ids, _ = _single(port_index, queries[3], K, efs_cap, n // 4)
    np.testing.assert_array_equal(by[rids[3]].ids, ids,
                                  err_msg="unset efs must run at the cap")


def test_chunk_timing_lands_in_latency_summary(port_index, queries):
    n = port_index.graph.n
    eng = _engine(port_index, efs=EFS, max_batch=4, scheduler="continuous",
                  step_iters=2)
    for j in range(6):
        eng.submit(queries[j], plan=_knn(n // (j + 2)), k=K)
    eng.drain()
    ch = eng.latency_summary()["chunks"]
    assert ch["n_chunks"] > 0
    for key in ("host_gap_ms", "dispatch_ms", "host_overlap_ms",
                "device_wait_ms"):
        assert ch[key] >= 0.0
    # a second drain REUSES the LaneBatch (one cache entry) and keeps
    # accumulating engine-level chunk totals
    assert len(eng._lane_cache) == 1
    first_chunks = ch["n_chunks"]
    for j in range(6):
        eng.submit(queries[j], plan=_knn(n // (j + 2)), k=K)
    eng.drain()
    assert len(eng._lane_cache) == 1, "same program shape must reuse"
    assert eng.latency_summary()["chunks"]["n_chunks"] > first_chunks


def test_latency_summary_splits_queue_and_service(port_index, queries):
    n = port_index.graph.n
    eng = _engine(port_index, efs=EFS)
    for j in range(5):
        eng.submit(queries[j], plan=_cut(n // (j + 1)), k=5)
    eng.drain()
    s = eng.latency_summary()
    assert s["n"] == 5
    for key in ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "queue_p50_ms",
                "queue_p99_ms", "service_p50_ms", "service_p95_ms",
                "service_p99_ms"):
        assert key in s and np.isfinite(s[key]) and s[key] >= 0.0, key
    assert s["p99_ms"] >= s["p50_ms"]
    assert len(eng.queue_waits_ms) == len(eng.service_ms) == 5
    np.testing.assert_allclose(
        np.asarray(eng.queue_waits_ms) + np.asarray(eng.service_ms),
        np.asarray(eng.latencies_ms))


# -- the port's engine against the reference's ---------------------------------


@pytest.fixture(scope="module")
def int8_pair(index, port_index):
    return index.quantize_resident(), port_index.quantize_resident()


#: one mixed workload: (cut as a fraction of n, k, efs; 0 = unset)
WORKLOAD = [(0.25, 6, 12), (0.5, 6, 24), (1.0, 4, 0), (0.33, 6, 18),
            (0.2, 5, 24), (0.66, 6, 15), (0.125, 6, 0), (1.0, 6, 20),
            (0.4, 3, 10)]


@pytest.mark.parametrize("resident", ["f32", "int8"])
@pytest.mark.parametrize("sched", ["continuous", "grouped"])
def test_engine_matches_reference_per_rid(index, port_index, int8_pair,
                                          queries, sched, resident):
    jidx, tidx = ((index, port_index) if resident == "f32" else int8_pair)
    n = port_index.graph.n
    kw = dict(efs=EFS, max_batch=4, scheduler=sched, step_iters=3,
              refill_threshold=1)
    jeng = JSearchEngine(index=jidx, store=_store(n, JGraphStore), **kw)
    teng = SearchEngine(index=tidx, store=_store(n), **kw)
    for j, (frac, k, efs) in enumerate(WORKLOAD):
        cut = int(frac * n)
        q = queries[j % len(queries)]
        jeng.submit(q, plan=jops.KnnSearch(
            child=jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=cut),
            k=k, efs=efs), k=k)
        teng.submit(q, plan=_knn(cut, k=k, efs=efs), k=k)
    ref = {r.rid: r for r in jeng.drain()}
    port = {r.rid: r for r in teng.drain()}
    assert sorted(port) == sorted(ref) == list(range(len(WORKLOAD)))
    for rid, r in ref.items():
        p = port[rid]
        np.testing.assert_array_equal(p.ids, np.asarray(r.ids),
                                      err_msg=f"rid {rid}")
        np.testing.assert_allclose(p.dists, np.asarray(r.dists), rtol=1e-5)
        assert p.sigma == pytest.approx(r.sigma, rel=1e-6)
        assert p.status == r.status == "ok" and not p.degraded


def test_int8_continuous_equals_grouped(int8_pair, queries):
    """On the int8 entry the serving-side exact re-rank of a full-width
    ragged beam equals ``execute``'s re-rank of the narrow one, per rid,
    bit for bit."""
    tidx = int8_pair[1]
    n = tidx.graph.n
    results = {}
    for sched in ("continuous", "grouped"):
        eng = _engine(tidx, efs=EFS, max_batch=4, scheduler=sched,
                      step_iters=3, refill_threshold=1)
        rids = [eng.submit(queries[j % len(queries)], k=k,
                           plan=_knn(int(frac * n), k=k, efs=efs or EFS))
                for j, (frac, k, efs) in enumerate(WORKLOAD)]
        by = {r.rid: r for r in eng.drain()}
        assert sorted(by) == sorted(rids)
        results[sched] = [by[rid] for rid in rids]
    for a, b in zip(results["continuous"], results["grouped"]):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        assert a.sigma == b.sigma
