"""A sharded index through the port's front door and serving tier
(``NavixDB.register_index`` / ``execute(alive=...)``,
``ProgramCache.search_sharded``, ``_ShardLanes`` under both schedulers,
``SearchService`` with heartbeat liveness).

At S = 1 against the JAX package's: the reference builds its
``ShardedNavix`` on a (1, 1) mesh and its shard graph is carried to the
port with ``graph_from_numpy``; both get the same stores, plans and
queries, and hold ids and every ``SearchStats`` field equal, dists
allclose at rtol 1e-5 (the tolerance of ``tests/test_torch_search.py``),
sigmas and ``programs.info()`` equal. At S in {2, 4} (the reference needs
forced host devices there) against the port's own one-shot
``ShardedNavix.search_many``, bit for bit.
"""

import jax
import numpy as np
import pytest

from repro.api import NavixDB as JNavixDB
from repro.api import Q as JQ
from repro.core import distributed as jdist
from repro.core.navix import NavixConfig as JNavixConfig
from repro.data.synthetic import gaussian_mixture
from repro.serving.engine import SearchEngine as JSearchEngine
from repro.storage.columnar import GraphStore as JGraphStore
from repro_torch.api import NavixDB, Q
from repro_torch.core.distributed import ShardedNavix, make_mesh
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig
from repro_torch.query.operators import Filter, NodeScan
from repro_torch.serving import (HeartbeatMonitor, LaneBatch, SearchEngine,
                                 SearchService)
from repro_torch.serving.lanes import _ShardLanes, make_backend
from repro_torch.storage.columnar import GraphStore

N = 637
CFG = dict(m_u=8, ef_construction=48, metric="l2", seed=0)
K, EFS = 6, 30
STAT_FIELDS = ("iters", "t_dc", "s_dc", "upper_dc", "picks")
WAIT_S = 60.0


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def env():
    """(X, queries, jax sn at S = 1, factory): ``factory(S, data=1)`` ->
    the port's ShardedNavix on a (data, S) cpu grid (S = 1: the
    reference's graph carried across; data > 1 wraps the data = 1
    graphs)."""
    X, _, centers = gaussian_mixture(640, 16, 8, seed=0)
    X = X[:N]
    rng = np.random.default_rng(7)
    base = centers[rng.integers(0, len(centers), size=8)]
    qs = (base + 0.25 * rng.normal(size=base.shape)).astype(np.float32)
    jsn = jdist.ShardedNavix.build(X, JNavixConfig(**CFG),
                                   jax.make_mesh((1, 1), ("data", "model")))
    built = {}

    def factory(s, data=1):
        if (s, data) in built:
            return built[(s, data)]
        if data > 1:
            base_sn = factory(s)
            sn = ShardedNavix(mesh=make_mesh((data, s), device="cpu"),
                              graphs=base_sn.graphs, n_local=base_sn.n_local,
                              n_total=N, config=base_sn.config)
        elif s == 1:
            g = graph_from_numpy({f: np.asarray(getattr(jsn.graphs, f))[0]
                                  for f in FIELDS}, device="cpu")
            sn = ShardedNavix(mesh=make_mesh((1, 1), device="cpu"),
                              graphs=[g], n_local=N, n_total=N,
                              config=NavixConfig(**CFG))
        else:
            sn = ShardedNavix.build(X, NavixConfig(**CFG),
                                    make_mesh((1, s), device="cpu"))
        built[(s, data)] = sn
        return sn

    return X, qs, jsn, factory


def _stores(n=N):
    t, j = GraphStore(), JGraphStore()
    for store in (t, j):
        store.add_node_table("Chunk", n, {"cID": np.arange(n)})
    return t, j


def _cut(cut):
    return Filter(NodeScan("Chunk"), "cID", "<", value=cut)


def _assert_rs(port, ref):
    np.testing.assert_array_equal(port.ids, np.asarray(ref.ids))
    np.testing.assert_allclose(port.dists, np.asarray(ref.dists), rtol=1e-5)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(port.stats, f),
                                      np.asarray(getattr(ref.stats, f)),
                                      err_msg=f"stats.{f}")
    assert port.sigma == pytest.approx(ref.sigma, rel=1e-6)
    if ref.sigmas is None:
        assert port.sigmas is None
    else:
        np.testing.assert_array_equal(port.sigmas, np.asarray(ref.sigmas))


def _knn_op(q):
    """The KnnSearch operator of the builder ``q``'s package."""
    from repro.query import operators as jops
    from repro_torch.query import operators as tops
    return (tops if q is Q else jops).KnnSearch


def _dbs(env):
    X, qs, jsn, factory = env
    tstore, jstore = _stores()
    tdb, jdb = NavixDB(tstore, device="cpu"), JNavixDB(jstore)
    tdb.register_index("shards", factory(1))
    jdb.register_index("shards", jsn)
    return tdb, jdb


# -- the front door ------------------------------------------------------------


def test_execute_matches_reference_at_one_shard(env):
    """``execute`` of a filtered batch with ``alive``, a single query, a
    mixed-plan ``masks=`` batch and a chunked batch: ids, stats and sigmas
    equal the reference's; then ``programs.info()`` equals too."""
    X, qs, jsn, factory = env
    tdb, jdb = _dbs(env)
    masks = [None, np.arange(N) < N // 3, np.arange(N) % 3 == 0,
             np.arange(N) >= N // 2, None]
    calls = [
        dict(plan=lambda q: q.match("Chunk").where("cID", "<", N // 2)
             .knn(k=K, efs=EFS), query=qs[:5], alive=np.ones(1, bool)),
        dict(plan=lambda q: q.match("Chunk").where("cID", ">=", N // 4)
             .knn(k=K, efs=EFS), query=qs[2]),
        dict(plan=lambda q: _knn_op(q)(table="Chunk", k=K, efs=EFS),
             query=qs[:5], masks=masks),
        dict(plan=lambda q: q.match("Chunk").where("cID", "<", N // 2)
             .knn(k=K, efs=EFS), query=qs[:7], max_batch=4),
        dict(plan=lambda q: q.match("Chunk").where("cID", "<", N // 2)
             .knn(k=K, efs=EFS), query=qs[:4]),
    ]
    for call in calls:
        kw = {k: v for k, v in call.items() if k != "plan"}
        port = tdb.execute(call["plan"](Q), **kw)
        ref = jdb.execute(call["plan"](JQ), **kw)
        _assert_rs(port, ref)
    assert tdb.programs.info() == jdb.programs.info()
    assert {k.sharded for k in tdb.programs._programs} == {1}


@pytest.mark.parametrize("case", ["alive_shape", "vmap_engine", "quantize"])
def test_execute_errors_match_reference(env, case):
    X, qs, jsn, factory = env
    tdb, jdb = _dbs(env)
    msgs = []
    for db, q in ((tdb, Q), (jdb, JQ)):
        with pytest.raises(ValueError) as e:
            if case == "alive_shape":
                db.execute(q.match("Chunk").knn(k=K), query=qs[:2],
                           alive=np.ones(3, bool))
            elif case == "vmap_engine":
                db.execute(q.match("Chunk").knn(k=K), query=qs[:2],
                           engine="vmap")
            else:
                db.quantize_index("shards")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_register_sharded_index(env):
    """A ShardedNavix registers with ``n_total`` rows (binding a table of
    that size or making one) and joins the catalog's program cache; an
    object the port cannot hold raises."""
    X, qs, jsn, factory = env
    sn = factory(2)
    db = NavixDB(device="cpu")
    entry = db.register_index("sharded", sn)
    assert entry.table == "sharded" and db.store.node("sharded").n == N
    assert sn.program_cache is db.programs and db.index("sharded") is sn
    tstore, _ = _stores()
    db2 = NavixDB(tstore, device="cpu")
    assert db2.register_index("s", factory(4)).table == "Chunk"
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        db2.register_index("other", object())
    sn.program_cache = None


def test_search_sharded_cache_and_lane_shard_buckets(env):
    """Through the cache, buckets round up to a multiple of the grid's
    data axis (3 here): B = 4 -> 6, B = 5 -> 9 (8 rounded), hits at a
    bucket already made; every result equals the unregistered (1, 2)
    grid's search bit for bit."""
    X, qs, jsn, factory = env
    sn = factory(2)
    sn3 = factory(2, data=3)
    tstore, _ = _stores()
    db = NavixDB(tstore, device="cpu")
    db.register_index("s3", sn3)
    for b in (4, 5, 4, 3):
        rs = db.execute(Q.match("Chunk").where("cID", "<", N // 2)
                        .knn(k=K, efs=EFS), query=qs[:b])
        want = sn.search_many(qs[:b], semimask=np.arange(N) < N // 2, k=K,
                              efs=EFS)
        np.testing.assert_array_equal(rs.ids, want.ids.numpy())
        np.testing.assert_array_equal(rs.dists, want.dists.numpy())
        for f in STAT_FIELDS:
            np.testing.assert_array_equal(getattr(rs.stats, f),
                                          getattr(want.stats, f).numpy())
    keys = list(db.programs._programs)
    assert sorted(k.batch_shape for k in keys) == [6, 9]
    assert {(k.sharded, k.lane_shards) for k in keys} == {(2, 3)}
    assert db.programs.info() == {"hits": 2, "misses": 2, "compiles": 2,
                                  "programs": 2}
    # the grid's devices are part of the key
    assert all(k.knobs[-1] == ("cpu",) * 6 for k in keys)


# -- the serving tier ------------------------------------------------------------


def _engine(sn, **kw):
    store, _ = _stores()
    return SearchEngine(index=sn, store=store, **kw)


@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_continuous_equals_grouped_and_one_shot(env, grid):
    """More distinct-plan requests than lanes: every rid answered exactly
    once by both schedulers, equal per rid, and equal to the one-shot
    sharded search of the request's own S, bit for bit."""
    X, qs, jsn, factory = env
    sn = factory(*grid)
    cuts = [N // 10, N // 5, N // 3, N // 2, 2 * N // 3, N, N // 8, N // 4,
            N, N // 6]
    out = {}
    for sched in ("continuous", "grouped"):
        eng = _engine(sn, efs=EFS, max_batch=4, scheduler=sched,
                      step_iters=3, refill_threshold=1)
        rids = [eng.submit(qs[j % len(qs)], plan=_cut(c), k=K)
                for j, c in enumerate(cuts)]
        by = {r.rid: r for r in eng.drain()}
        assert sorted(by) == sorted(rids), "every rid exactly once"
        out[sched] = [by[r] for r in rids]
    for j, (a, b) in enumerate(zip(out["continuous"], out["grouped"])):
        assert not a.degraded and not b.degraded
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"request {j}")
        np.testing.assert_array_equal(a.dists, b.dists)
        assert a.sigma == pytest.approx(b.sigma)
        want = sn.search_many(qs[j % len(qs)], semimask=np.arange(N) < cuts[j],
                              k=K, efs=EFS)
        np.testing.assert_array_equal(a.ids, want.ids[0].numpy())
        np.testing.assert_array_equal(a.dists, want.dists[0].numpy())


@pytest.mark.parametrize("sched", ["continuous", "grouped"])
def test_engine_matches_reference_per_rid_at_one_shard(env, sched):
    X, qs, jsn, factory = env
    tstore, jstore = _stores()
    teng = SearchEngine(index=factory(1), store=tstore, efs=EFS,
                        max_batch=4, scheduler=sched, step_iters=3,
                        refill_threshold=1, alive=np.ones(1, bool))
    jeng = JSearchEngine(index=jsn, store=jstore, efs=EFS, max_batch=4,
                         scheduler=sched, step_iters=3, refill_threshold=1,
                         alive=np.ones(1, bool))
    from repro.query import operators as jops
    cuts = [N // 3, N, N // 5, N // 2, 3 * N // 4, N // 7]
    for j, c in enumerate(cuts):
        teng.submit(qs[j], plan=_cut(c), k=K)
        jeng.submit(qs[j], plan=jops.Filter(jops.NodeScan("Chunk"), "cID",
                                            "<", value=c), k=K)
    tby = {r.rid: r for r in teng.drain()}
    jby = {r.rid: r for r in jeng.drain()}
    assert sorted(tby) == sorted(jby) == list(range(len(cuts)))
    for rid, r in jby.items():
        np.testing.assert_array_equal(tby[rid].ids, np.asarray(r.ids))
        np.testing.assert_allclose(tby[rid].dists, np.asarray(r.dists),
                                   rtol=1e-5)
        assert tby[rid].sigma == pytest.approx(r.sigma, rel=1e-6)
        assert tby[rid].degraded == r.degraded


@pytest.mark.parametrize("n_shards", [2, 4])
def test_straggler_flip_mid_drain_flags_degraded(env, n_shards):
    """The alive mask flips after the first device step (a liveness probe
    would do this from step_hook): every response finalized afterwards is
    degraded, holds no id of the dead shard, and equals the one-shot
    search restricted to the alive shards."""
    X, qs, jsn, factory = env
    sn = factory(n_shards)
    eng = _engine(sn, efs=EFS, max_batch=4, scheduler="continuous",
                  step_iters=2, refill_threshold=1)
    alive = np.ones(n_shards, bool)
    alive[-1] = False
    hooks = []

    def probe(info):
        hooks.append(dict(info))
        eng.alive = alive

    eng.step_hook = probe
    cuts = [N // 6, N // 3, N // 2, N, N // 4, 2 * N // 3]
    rids = {eng.submit(qs[j], plan=_cut(c), k=K): (j, c)
            for j, c in enumerate(cuts)}
    responses = eng.drain()
    assert sorted(r.rid for r in responses) == sorted(rids) and hooks
    dead_lo = (n_shards - 1) * sn.n_local
    for r in responses:
        assert r.degraded, "finalized after the flip"
        assert not (r.ids >= dead_lo).any(), "a dead shard's id leaked"
        j, c = rids[r.rid]
        want = sn.search_many(qs[j], semimask=np.arange(N) < c, k=K, efs=EFS,
                              alive=alive)
        np.testing.assert_array_equal(r.ids, want.ids[0].numpy())
        np.testing.assert_array_equal(r.dists, want.dists[0].numpy())


def test_grouped_scheduler_reads_shard_liveness(env):
    """The grouped scheduler takes its liveness from ``resolve_alive`` too:
    a static mask or a heartbeat monitor with a stale shard gives degraded
    responses equal to the alive-restricted search; both set raises."""
    X, qs, jsn, factory = env
    sn = factory(2)
    clk = FakeClock(0.0)
    hb = HeartbeatMonitor(2, stale_after=1.0, clock=clk)
    hb.suppress(1)
    clk.t = 5.0
    hb.beat(0)
    alive = np.array([True, False])
    for kw in (dict(alive=alive), dict(heartbeats=hb)):
        eng = _engine(sn, efs=EFS, max_batch=4, scheduler="grouped", **kw)
        rids = {eng.submit(qs[j], plan=_cut(N // 2), k=K): j
                for j in range(3)}
        for r in eng.drain():
            assert r.degraded
            want = sn.search_many(qs[rids[r.rid]],
                                  semimask=np.arange(N) < N // 2, k=K,
                                  efs=EFS, alive=alive)
            np.testing.assert_array_equal(r.ids, want.ids[0].numpy())
    eng = _engine(sn, scheduler="grouped", alive=alive, heartbeats=hb)
    eng.submit(qs[0], k=K)
    with pytest.raises(ValueError, match="not both"):
        eng.drain()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_service_heartbeats_degrade_and_drop_dead_shard(env, n_shards):
    """A live service with a heartbeat monitor: the last shard goes stale
    mid-drain. Responses finalized after the flip are degraded, hold none
    of its ids and equal the alive-restricted search; every rid is
    answered once."""
    X, qs, jsn, factory = env
    sn = factory(n_shards)
    clk = FakeClock(0.0)
    hb = HeartbeatMonitor(n_shards, stale_after=1.0, clock=clk)
    store, _ = _stores()
    db = NavixDB(store, device="cpu")
    db.register_index("s", sn)
    svc = SearchService(db, k_cap=K, efs_cap=EFS, max_batch=4, step_iters=2,
                        heartbeats=hb, clock=clk)
    cuts = [N // 6, N // 3, N // 2, N, N // 4, 2 * N // 3, N // 5, N]
    futs = [svc.submit(qs[j], plan=_cut(c), k=K) for j, c in enumerate(cuts)]
    svc._tick()
    hb.suppress(n_shards - 1)
    clk.t = 2.0
    hb.beat_all()
    flipped = [f.done() for f in futs]
    for _ in range(500):
        if all(f.done() for f in futs):
            break
        svc._tick()
    got = [f.result(timeout=0) for f in futs]
    assert len({r.rid for r in got}) == len(futs)
    alive = np.ones(n_shards, bool)
    alive[-1] = False
    dead_lo = (n_shards - 1) * sn.n_local
    n_degraded = 0
    for j, (r, before) in enumerate(zip(got, flipped)):
        assert r.status == "ok"
        if before:
            continue
        n_degraded += 1
        assert r.degraded and not (np.asarray(r.ids) >= dead_lo).any()
        want = sn.search_many(qs[j], semimask=np.arange(N) < cuts[j], k=K,
                              efs=EFS, alive=alive)
        np.testing.assert_array_equal(np.asarray(r.ids), want.ids[0].numpy())
    assert n_degraded > 0
    assert svc.shutdown(timeout=WAIT_S)


def test_service_liveness_config_on_a_sharded_entry(env):
    X, qs, jsn, factory = env
    store, _ = _stores()
    db = NavixDB(store, device="cpu")
    db.register_index("s", factory(2))
    with pytest.raises(ValueError, match="shape"):
        SearchService(db, alive=np.ones(3, bool))
    with pytest.raises(ValueError, match="not both"):
        SearchService(db, alive=np.ones(2, bool),
                      heartbeats=HeartbeatMonitor(2))
    with pytest.raises(ValueError, match="tracks"):
        SearchService(db, heartbeats=HeartbeatMonitor(3))
    svc = SearchService(db, k_cap=K, efs_cap=EFS, max_batch=2,
                        alive=np.array([False, True]))
    fut = svc.submit(qs[0], k=K)
    while not fut.done():
        svc._tick()
    r = fut.result(timeout=0)
    assert r.degraded and (np.asarray(r.ids)[np.asarray(r.ids) >= 0]
                           >= factory(2).n_local).all()
    assert svc.shutdown(timeout=WAIT_S)


def test_make_backend_routes_a_sharded_index(env):
    """``make_backend`` gives a ShardedNavix ``_ShardLanes``: f32-resident,
    lane buffers rounded to the data axis, the full row the index's own
    packed words; a LaneBatch steps it to the one-shot answer."""
    X, qs, jsn, factory = env
    sn3 = factory(2, data=3)
    params = sn3._params(K, EFS, "adaptive_local")
    be = make_backend(sn3, params)
    assert isinstance(be, _ShardLanes)
    assert be.exact is None and be.n_shards == 2 and be.lane_multiple == 3
    np.testing.assert_array_equal(
        be.full_row(), sn3.shard_semimask_np(np.ones(N, bool)))
    lanes = LaneBatch(sn3, "adaptive_local", K, EFS, 4)
    assert lanes.bsz == 6 and lanes.n_shards == 2
    assert lanes.selh.shape == (2, 6, sn3.n_words_local)
    rows = [sn3.shard_semimask_np(np.arange(N) < c) for c in (N // 2, N)]
    used = lanes.admit([(j, sn3._prep_query(qs[j]).numpy(), rows[j % 2],
                         1.0, EFS) for j in range(5)])
    assert used == [0, 1, 2, 3, 4]
    while lanes.step(0)[used].any():
        pass
    ids, dists = lanes.finalize(np.ones(2, bool))
    for j in used:
        want = factory(2).search_many(
            qs[j], semimask=np.arange(N) < (N // 2, N)[j % 2], k=K, efs=EFS)
        np.testing.assert_array_equal(ids[j, :K], want.ids[0].numpy())
        np.testing.assert_array_equal(dists[j, :K], want.dists[0].numpy())
    lanes.evict([1])
    ids, _ = lanes.finalize(np.ones(2, bool))
    assert (ids[1] == -1).all() and lanes.free_count() == 2
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        make_backend(object(), params)
