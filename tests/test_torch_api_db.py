"""The port's NavixDB, Q builder and program cache against the JAX
package's, on the same store, index and call sequence.

Both generators build the small Wiki store from one seed
(``make_wiki_like(n_person=60, n_resource=150, d=16)``). The reference
``NavixDB.create_index`` builds the index (cos); its arrays are carried to
the port with ``graph_from_numpy`` and registered in a port ``NavixDB`` on
the CPU. Every test runs the same calls on both databases and holds:

* ids and every ``SearchStats`` field equal, dists allclose at rtol 1e-5
  (the tolerance of ``tests/test_torch_search.py``: XLA and torch may sum
  in another order; cos distances near 0 also within d f32 epsilons, see
  ``COS_ATOL``), projected columns and selectivities equal;
* ``programs.info()`` equal after the same call sequence (hits, misses,
  entries).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import NavixDB as JNavixDB
from repro.api import Q as JQ
from repro.core.navix import NavixConfig as JNavixConfig
from repro.data import synthetic as jsyn
from repro.query import operators as jops
from repro_torch.api import (IndexEntry, NavixDB, ProgramCache, ProgramKey, Q,
                             ResultSet, StageTimings)
from repro_torch.api import plan_compile
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.search import SearchParams
from repro_torch.data import synthetic as tsyn
from repro_torch.query import operators as tops

WIKI = dict(n_person=60, n_resource=150, d=16, seed=2)
CFG = dict(m_u=8, ef_construction=48, metric="cos")
#: cos distances are 1 - q.x: their rounding sits at the scale of 1.0, not at
#: the distance's, and a d-term f32 dot summed in another order may differ
#: by up to d epsilons there (a row's distance to itself is 0 in one package
#: and an ulp or two in the other)
COS_ATOL = WIKI["d"] * float(np.finfo(np.float32).eps)


def _port_handle(jidx):
    """A port NavixIndex on the CPU over the reference index's arrays."""
    g = graph_from_numpy({f: np.asarray(getattr(jidx.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**jidx.config._asdict()),
                                 device="cpu")


def _db_pair(jdata, tdata, jidx, name="chunk_emb"):
    """A reference and a port NavixDB over the two stores, each with the
    same index registered under ``name``."""
    jdb, tdb = JNavixDB(jdata.store), NavixDB(tdata.store, device="cpu")
    jdb.register_index(name, jidx, table="Chunk")
    tdb.register_index(name, _port_handle(jidx), table="Chunk")
    return jdb, tdb


@pytest.fixture(scope="module")
def wikidb():
    jdata = jsyn.make_wiki_like(**WIKI)
    tdata = tsyn.make_wiki_like(**WIKI)
    jdb = JNavixDB(jdata.store)
    jidx, stats = jdb.create_index("chunk_emb", "Chunk", column="embedding",
                                   vectors=jdata.embeddings,
                                   config=JNavixConfig(**CFG))
    assert stats.n == jdata.n_chunks
    tdata.store.add_vector_column("Chunk", "embedding", tdata.embeddings)
    tdb = NavixDB(tdata.store, device="cpu")
    tidx = _port_handle(jidx)
    tdb.register_index("chunk_emb", tidx, table="Chunk", column="embedding")
    return jdb, tdb, jidx, tidx, jdata, tdata


def _port_plan(node):
    if not dataclasses.is_dataclass(node):
        return node
    cls = getattr(tops, type(node).__name__)
    return cls(**{f.name: _port_plan(getattr(node, f.name))
                  for f in dataclasses.fields(node)})


def _tree(node):
    if not dataclasses.is_dataclass(node):
        return node
    return (type(node).__name__,
            tuple((f.name, _tree(getattr(node, f.name)))
                  for f in dataclasses.fields(node)))


def _assert_same(port: ResultSet, ref, jdb, tdb):
    assert isinstance(port.ids, np.ndarray)
    np.testing.assert_array_equal(port.ids, np.asarray(ref.ids))
    assert port.table == ref.table
    assert port.sigma == pytest.approx(ref.sigma, rel=1e-6)
    if ref.dists is None:
        assert port.dists is None and port.stats is None
    else:
        np.testing.assert_allclose(port.dists, np.asarray(ref.dists),
                                   rtol=1e-5, atol=COS_ATOL)
        for f in ref.stats._fields:
            got = getattr(port.stats, f)
            assert isinstance(got, np.ndarray), f
            np.testing.assert_array_equal(got,
                                          np.asarray(getattr(ref.stats, f)),
                                          err_msg=f"stats.{f}")
    assert port.columns.keys() == ref.columns.keys()
    for c, col in ref.columns.items():
        np.testing.assert_array_equal(port.columns[c], col, err_msg=c)
    if ref.sigmas is None:
        assert port.sigmas is None
    else:
        np.testing.assert_array_equal(port.sigmas, np.asarray(ref.sigmas))
    if ref.mask is None:
        assert port.mask is None
    else:
        np.testing.assert_array_equal(port.mask, ref.mask)
    assert tdb.programs.info() == jdb.programs.info()


def _both(wikidb, fn):
    """Run ``fn(db, q_builder, ops_module)`` on both databases."""
    jdb, tdb, *_ = wikidb
    return fn(tdb, Q, tops), fn(jdb, JQ, jops)


# -- plan algebra ----------------------------------------------------------

BUILDERS = {
    "filter_hop_knn_project_limit": lambda q: (
        q.match("Person").where("birth_date", "range", lo=0, hi=100)
         .hop("PersonChunk", "fwd").knn(k=7, efs=30).project("cID")
         .limit(5)),
    "two_hop_knn": lambda q: (
        q.match("Person").where("birth_date", "<", 9000)
         .hop("WikiLink").hop("ResourceChunk").knn(k=3, index="chunk_emb",
                                                   heuristic="onehop_a")),
    "union_intersect_negate": lambda q: (
        q.match("Chunk").where("cID", "<", 10)
         .union(q.match("Chunk").where("is_person", "==", True))
         .intersect(q.match("Chunk").where("cID", "isin", (1, 2, 3)))
         .negate().project("cID", "is_person")),
    "bound_vector": lambda q: (
        q.match("Chunk").knn(np.ones(16, np.float32), k=4, efs=8)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_plan_equals_reference_field_for_field(name):
    port, ref = BUILDERS[name](Q), BUILDERS[name](JQ)
    assert _tree(port.plan()) == _tree(ref.plan())
    assert port.plan() == _port_plan(ref.plan())
    assert hash(port.plan()) == hash(_port_plan(ref.plan()))
    if ref.bound_query is None:
        assert port.bound_query is None
    else:
        np.testing.assert_array_equal(port.bound_query, ref.bound_query)
        assert port.bound_query.dtype == np.float32


def test_builder_equals_hand_built_plan():
    built = (Q.match("Person")
              .where("birth_date", "range", lo=0, hi=100)
              .hop("PersonChunk", "fwd")
              .knn(k=7, efs=30)
              .project("cID")
              .limit(5)
              .plan())
    hand = tops.Limit(
        tops.Project(
            tops.KnnSearch(
                child=tops.HopJoin(
                    tops.Filter(tops.NodeScan("Person"), "birth_date",
                                "range", lo=0, hi=100),
                    "PersonChunk", "fwd"),
                k=7, efs=30, heuristic="adaptive_local"),
            ("cID",)),
        5)
    assert built == hand
    assert hash(built) == hash(hand)      # plans are group/cache keys


@pytest.mark.parametrize("name", list(BUILDERS))
def test_explain_text_equal(wikidb, name):
    port, ref = _both(wikidb, lambda db, q, _: db.explain(BUILDERS[name](q)))
    assert port == ref
    assert "NodeScan" in port


# -- end-to-end execution ---------------------------------------------------


def test_knn_plan_recall_vs_oracle(wikidb):
    jdb, tdb, jidx, tidx, jdata, _ = wikidb
    queries = jsyn.make_queries(jdata, 8, "uncorrelated", seed=9)
    port, ref = _both(wikidb, lambda db, _, ops: db.execute(
        ops.KnnSearch(child=ops.Filter(ops.NodeScan("Chunk"), "cID", "<",
                                       value=jdata.n_chunks // 2),
                      k=10, efs=80), query=queries))
    _assert_same(port, ref, jdb, tdb)
    assert port.ids.shape == (8, 10)
    assert port.mask[port.ids[port.ids >= 0]].all()   # no leakage outside S
    _, true_ids = tidx.brute_force(queries, k=10, semimask=port.mask)
    assert tidx.recall(port.ids, true_ids) >= 0.9
    assert port.sigma == pytest.approx(0.5, abs=0.01)
    assert isinstance(port.timings, StageTimings)
    assert port.timings.search_ms > 0.0
    t = port.timings.as_dict()
    assert t["total_ms"] == pytest.approx(sum(
        v for k, v in t.items() if k != "total_ms"))


def test_project_limit_and_rows(wikidb):
    jdb, tdb, *_, jdata, _ = wikidb

    def run(db, q, _):
        return db.execute(q.match("Chunk")
                          .knn(jdata.embeddings[0], k=8, efs=40,
                               heuristic="onehop_a")
                          .project("cID", "is_person").limit(3))

    port, ref = _both(wikidb, run)
    _assert_same(port, ref, jdb, tdb)
    assert port.ids.shape == (3,)
    valid = port.ids >= 0
    np.testing.assert_array_equal(port.columns["cID"][valid],
                                  port.ids[valid])
    assert port.ids[0] == 0        # nearest neighbor of chunk 0 is itself
    rows, ref_rows = list(port.rows()), list(ref.rows())
    assert [r.pop("dist") for r in rows] == pytest.approx(
        [r.pop("dist") for r in ref_rows], rel=1e-5, abs=COS_ATOL)
    assert rows == ref_rows
    assert rows[0]["id"] == 0 and set(rows[0]) == {"id", "cID", "is_person"}


def test_rows_rejects_batch_results(wikidb):
    jdb, tdb, *_, jdata, _ = wikidb
    port, ref = _both(wikidb, lambda db, q, _: db.execute(
        q.match("Chunk").knn(k=3), query=jdata.embeddings[:2]))
    _assert_same(port, ref, jdb, tdb)
    with pytest.raises(ValueError, match="single-query"):
        list(port.rows())


def test_pure_selection_plan(wikidb):
    jdb, tdb, *_, jdata, _ = wikidb
    port, ref = _both(wikidb, lambda db, q, _: db.execute(
        q.match("Chunk").where("is_person", "==", True).project("cID")
         .limit(10)))
    _assert_same(port, ref, jdb, tdb)
    assert len(port) == 10 and port.dists is None
    assert jdata.chunk_is_person[port.ids].all()
    np.testing.assert_array_equal(port.columns["cID"], port.ids)
    port, ref = _both(wikidb, lambda db, q, _: db.execute(q.match("Person")))
    _assert_same(port, ref, jdb, tdb)
    np.testing.assert_array_equal(port.ids, np.arange(WIKI["n_person"]))


@pytest.mark.parametrize("plan", ["person_chunk", "two_hop", "negated"])
def test_correlated_plans_match_reference(wikidb, plan):
    jdb, tdb, *_, jdata, _ = wikidb
    mode = "person" if plan == "person_chunk" else "nonperson"
    queries = jsyn.make_queries(jdata, 6, mode, seed=4)

    def run(db, q, _):
        sel = q.match("Person").where("birth_date", "range", lo=0, hi=20000)
        if plan == "two_hop":
            sel = sel.hop("WikiLink", "fwd").hop("ResourceChunk", "fwd")
        else:
            sel = sel.hop("PersonChunk", "fwd")
        if plan == "negated":
            sel = sel.negate()
        return db.execute(sel.knn(k=5, efs=40), query=queries)

    port, ref = _both(wikidb, run)
    _assert_same(port, ref, jdb, tdb)


@pytest.mark.parametrize("heuristic", ["onehop_s", "onehop_a", "directed",
                                       "blind", "adaptive_g",
                                       "adaptive_global", "adaptive_l",
                                       "adaptive_local", "navix",
                                       "Adaptive-Local"])
def test_knn_heuristic_names_match_reference(wikidb, heuristic):
    """``KnnSearch.heuristic`` takes the reference's names (aliases share
    one cache entry, as they share one heuristic)."""
    jdb, tdb, *_, jdata, _ = wikidb
    queries = jsyn.make_queries(jdata, 3, "nonperson", seed=50)
    port, ref = _both(wikidb, lambda db, q, _: db.execute(
        q.match("Person").where("birth_date", "<", 12000).hop("PersonChunk")
         .knn(k=6, efs=24, heuristic=heuristic), query=queries))
    _assert_same(port, ref, jdb, tdb)


def test_execute_rejects_unknown_engine(wikidb):
    *_, jdata, _ = wikidb

    def run(db, q, _):
        with pytest.raises(ValueError, match="engine") as e:
            db.execute(q.match("Chunk").knn(k=3), query=jdata.embeddings[:4],
                       engine="bacthed")
        return str(e.value)

    port, ref = _both(wikidb, run)
    assert port == ref


def test_unbound_template_needs_query(wikidb):
    def run(db, q, _):
        with pytest.raises(ValueError, match="query vector") as e:
            db.execute(q.match("Chunk").knn(k=5))
        return str(e.value)

    port, ref = _both(wikidb, run)
    assert port == ref


@pytest.mark.parametrize("case", ["masks_with_selection", "masks_count",
                                  "no_index_on_table", "alive_unsharded"])
def test_execute_errors_match_reference(wikidb, case):
    *_, jdata, _ = wikidb
    qs = jdata.embeddings[:3]

    def run(db, q, _):
        with pytest.raises(ValueError) as e:
            if case == "masks_with_selection":
                db.execute(q.match("Chunk").where("cID", "<", 5).knn(k=3),
                           query=qs, masks=[None] * 3)
            elif case == "masks_count":
                db.execute(q.match("Chunk").knn(k=3), query=qs,
                           masks=[None] * 2)
            elif case == "no_index_on_table":
                db.execute(q.match("Person").knn(k=3), query=qs)
            else:
                db.execute(q.match("Chunk").knn(k=3), query=qs,
                           alive=np.ones(2, bool))
        return str(e.value)

    port, ref = _both(wikidb, run)
    assert port == ref


# -- program cache -----------------------------------------------------------


def test_program_cache_zero_new_entries_on_same_shape(wikidb):
    jdb, tdb, *_, jdata, _ = wikidb

    def run(db, q, _):
        plan = (q.match("Chunk").where("cID", "<", 400)
                 .knn(jdata.embeddings[0], k=5, efs=40))
        db.execute(plan)                       # may make an entry
        before, hits0 = db.programs.stats.misses, db.programs.stats.hits
        out = [db.execute(plan, query=jdata.embeddings[123]),
               db.execute(plan, query=jdata.embeddings[77])]
        assert db.programs.stats.misses == before
        assert db.programs.stats.hits == hits0 + 2
        return out

    port, ref = _both(wikidb, run)
    for p, r in zip(port, ref):
        _assert_same(p, r, jdb, tdb)


def test_program_cache_bucketing_17_19_23(wikidb):
    """B = 17, 19 and 23 pad to one bucket (32): one entry, and padding
    changes no real lane (against an unregistered handle's unpadded
    batch)."""
    jdb, tdb, jidx, tidx, jdata, _ = wikidb
    plan = lambda q: q.match("Chunk").where("cID", "<", 500).knn(k=5, efs=40)

    def run(db, q, _):
        entries = len(db.programs)
        out = [db.execute(plan(q), query=jdata.embeddings[:b])
               for b in (17, 19, 23)]
        assert len(db.programs) == entries + 1
        return out

    port, ref = _both(wikidb, run)
    for p, r in zip(port, ref):
        _assert_same(p, r, jdb, tdb)
    mask = port[0].mask
    plain = NavixIndex(graph=tidx.graph, config=tidx.config)
    for rs in port:
        b = rs.ids.shape[0]
        direct = plain.search_many(jdata.embeddings[:b], k=5, efs=40,
                                   semimask=mask)
        np.testing.assert_array_equal(rs.ids, direct.ids.numpy())
        np.testing.assert_array_equal(rs.dists, direct.dists.numpy())
        for f in direct.stats._fields:
            np.testing.assert_array_equal(getattr(rs.stats, f),
                                          getattr(direct.stats, f).numpy())


def test_compat_layer_shares_cache(wikidb):
    jdb, tdb, jidx, tidx, jdata, _ = wikidb
    mask = np.zeros(jdata.n_chunks, bool)
    mask[:500] = True
    out = {}
    for name, db, idx in (("port", tdb, tidx), ("ref", jdb, jidx)):
        idx.search(jdata.embeddings[3], k=5, efs=40, semimask=mask)
        hits0, misses0 = db.programs.stats.hits, db.programs.stats.misses
        r = idx.search(jdata.embeddings[9], k=5, efs=40, semimask=mask)
        assert db.programs.stats.hits == hits0 + 1
        assert db.programs.stats.misses == misses0
        out[name] = r
    np.testing.assert_array_equal(out["port"].ids.numpy(),
                                  np.asarray(out["ref"].ids))
    assert tdb.programs.info() == jdb.programs.info()
    ids = out["port"].ids.numpy()
    assert mask[ids[ids >= 0]].all()


@pytest.mark.parametrize("engine", ["batched", "vmap"])
def test_compat_search_many_through_the_cache(wikidb, engine):
    jdb, tdb, jidx, tidx, jdata, _ = wikidb
    masks = list(np.random.default_rng(5).random((5, jdata.n_chunks)) < 0.4)
    port = tidx.search_many(jdata.embeddings[10:15], k=6, efs=30,
                            semimask=masks, engine=engine)
    ref = jidx.search_many(jdata.embeddings[10:15], k=6, efs=30,
                           semimask=masks, engine=engine)
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    for f in ref.stats._fields:
        np.testing.assert_array_equal(getattr(port.stats, f).numpy(),
                                      np.asarray(getattr(ref.stats, f)))
    assert tdb.programs.info() == jdb.programs.info()


def test_execute_vmap_engine_matches_reference_and_batched(wikidb):
    jdb, tdb, *_, jdata, _ = wikidb
    queries = jsyn.make_queries(jdata, 4, "uncorrelated", seed=12)

    def run(db, q, _):
        plan = q.match("Chunk").where("cID", ">=", 200).knn(k=6, efs=30)
        return (db.execute(plan, query=queries, engine="vmap"),
                db.execute(plan, query=queries))

    (pv, pb), (rv, rb) = _both(wikidb, run)
    _assert_same(pv, rv, jdb, tdb)
    _assert_same(pb, rb, jdb, tdb)
    np.testing.assert_array_equal(pv.ids, pb.ids)
    np.testing.assert_array_equal(pv.dists, pb.dists)
    for f in pv.stats._fields:
        np.testing.assert_array_equal(getattr(pv.stats, f),
                                      getattr(pb.stats, f))


def test_mixed_plan_batch_masks(wikidb):
    """``masks=``: each lane searches its own selected set in one batch,
    lane for lane equal to its own plan's execute."""
    jdb, tdb, *_, jdata, _ = wikidb
    sels = [lambda q: q.match("Chunk").where("cID", "<", 300),
            lambda q: (q.match("Person").where("birth_date", "<", 20000)
                       .hop("PersonChunk")),
            lambda q: q.match("Chunk"),
            lambda q: q.match("Chunk").where("is_person", "==", False)]
    masks = [tdb.prefilter(s(Q).plan()).mask for s in sels]
    masks[2] = None                                  # unfiltered lanes
    queries = jsyn.make_queries(jdata, 8, "person", seed=21)
    lane_masks = [masks[i % 4] for i in range(8)]
    port, ref = _both(wikidb, lambda db, _, ops: db.execute(
        ops.KnnSearch(table="Chunk", k=5, efs=40), query=queries,
        masks=lane_masks))
    _assert_same(port, ref, jdb, tdb)
    assert port.sigmas.shape == (8,) and port.sigmas.dtype == np.float32
    assert port.sigmas[2] == 1.0
    assert port.sigma == pytest.approx(float(port.sigmas.mean()))
    own, own_ref = _both(wikidb, lambda db, q, _: [
        db.execute(s(q).knn(k=5, efs=40), query=queries) for s in sels])
    for p, r in zip(own, own_ref):
        _assert_same(p, r, jdb, tdb)
    for i in range(8):
        mine = own[i % 4]
        np.testing.assert_array_equal(port.ids[i], mine.ids[i])
        np.testing.assert_array_equal(port.dists[i], mine.dists[i])
        for f in mine.stats._fields:
            np.testing.assert_array_equal(getattr(port.stats, f)[i],
                                          getattr(mine.stats, f)[i])


@pytest.mark.parametrize("max_batch", [3, 4])
@pytest.mark.parametrize("lanes", ["shared", "per_lane"])
def test_max_batch_chunks_match_reference(wikidb, max_batch, lanes):
    jdb, tdb, *_, jdata, _ = wikidb
    queries = jsyn.make_queries(jdata, 10, "uncorrelated", seed=30)
    masks = (None if lanes == "shared" else
             list(np.random.default_rng(31).random((10, jdata.n_chunks))
                  < 0.5))

    def run(db, q, ops, chunk):
        plan = (q.match("Chunk").where("cID", "<", 600).knn(k=4, efs=24)
                if masks is None else ops.KnnSearch(table="Chunk", k=4,
                                                    efs=24))
        return db.execute(plan, query=queries, max_batch=chunk, masks=masks)

    port, ref = _both(wikidb, lambda db, q, ops: run(db, q, ops, max_batch))
    _assert_same(port, ref, jdb, tdb)
    whole, whole_ref = _both(wikidb, lambda db, q, ops: run(db, q, ops, 0))
    _assert_same(whole, whole_ref, jdb, tdb)
    np.testing.assert_array_equal(port.ids, whole.ids)
    np.testing.assert_array_equal(port.dists, whole.dists)


def test_quantize_index_matches_reference(wikidb):
    """An int8 entry: the beam at k = efs on the codes, then the host
    exact re-rank (``rerank_ms``); single query and batch."""
    _, _, jidx, _, jdata, tdata = wikidb
    jdb, tdb = _db_pair(jdata, tdata, jidx, name="chunk_q")
    jq, tq = jdb.quantize_index("chunk_q"), tdb.quantize_index("chunk_q")
    assert tq.is_quantized and tq.program_cache is tdb.programs
    assert tdb.index("chunk_q") is tq and tdb.catalog["chunk_q"].index is tq
    queries = jsyn.make_queries(jdata, 6, "uncorrelated", seed=40)
    for query in (queries, queries[2]):
        out = []
        for db, q in ((tdb, Q), (jdb, JQ)):
            out.append(db.execute(q.match("Chunk").where("cID", "<", 500)
                                  .knn(k=5, efs=30).project("cID"),
                                  query=query))
        _assert_same(*out, jdb, tdb)
        assert out[0].timings.rerank_ms > 0.0
    direct = tq.search_quantized_many(queries, k=5, efs=30,
                                      semimask=out[0].mask)
    direct_ref = jq.search_quantized_many(queries, k=5, efs=30,
                                          semimask=out[0].mask)
    np.testing.assert_array_equal(direct.ids.numpy(),
                                  np.asarray(direct_ref.ids))
    jdb.execute(JQ.match("Chunk").where("cID", "<", 500).knn(k=5, efs=30),
                query=queries)
    np.testing.assert_array_equal(
        tdb.execute(Q.match("Chunk").where("cID", "<", 500)
                    .knn(k=5, efs=30), query=queries).ids,
        direct.ids.numpy())
    assert tdb.programs.info() == jdb.programs.info()
    assert {k.resident for k in tdb.programs._programs} == {"int8"}


def test_program_key_hashes_every_search_param():
    """Each ``SearchParams`` field, the batch shape, the engine, the mask
    form and the residency reach the key: varying any one makes a new
    entry."""
    g = graph_from_numpy({
        "lower": np.zeros((8, 4), np.int32), "lower_deg": np.zeros(8,
                                                                    np.int32),
        "upper": np.zeros((2, 2), np.int32), "upper_deg": np.zeros(2,
                                                                   np.int32),
        "upper_ids": np.zeros(2, np.int32), "entry_pos": np.int32(0),
        "vectors": np.zeros((8, 3), np.float32)}, device="cpu")
    cache = ProgramCache()
    base = SearchParams()
    variants = {"k": 7, "efs": 33, "heuristic": 1, "metric": "cos",
                "ub": 0.25, "lf": 2.0, "two_hop_cap": 5, "max_iters": 9}
    assert set(variants) == set(SearchParams._fields)
    keys = {cache._key(g, base, None)}
    for f, v in variants.items():
        keys.add(cache._key(g, base._replace(**{f: v}), None))
    keys.add(cache._key(g, base, 8))
    keys.add(cache._key(g, base, 8, engine="vmap"))
    keys.add(cache._key(g, base, 8, engine="batched", per_lane_sel=True))
    assert len(keys) == len(variants) + 4
    assert all(isinstance(k, ProgramKey) for k in keys)
    assert ProgramKey._fields == (
        "n", "dim", "k", "efs", "heuristic", "metric", "batch_shape",
        "knobs", "engine", "per_lane_sel", "sharded", "lane_shards",
        "resident")


def test_cache_entry_points_name_their_engine(wikidb):
    """``search_batch`` is the vmap arm, ``search_many`` the batched one:
    two entries at one plan shape, equal lanes, sliced to the true B."""
    _, _, _, tidx, jdata, _ = wikidb
    cache = ProgramCache()
    g = tidx.graph
    Q = tidx._prep_query(jdata.embeddings[40:45])
    sel = tidx.pack_semimask(np.arange(jdata.n_chunks) % 3 == 0)
    params = tidx._params(5, 30, "adaptive_local")
    vmap = cache.search_batch(g, Q, sel, params, tidx.sigma(sel))
    batched = cache.search_many(g, Q, sel, params, tidx.sigma(sel))
    assert {k.engine for k in cache._programs} == {"vmap", "batched"}
    assert {k.batch_shape for k in cache._programs} == {8}
    assert vmap.ids.shape == batched.ids.shape == (5, 5)
    assert torch.equal(vmap.ids, batched.ids)
    assert torch.equal(vmap.dists, batched.dists)
    for f in vmap.stats._fields:
        assert getattr(vmap.stats, f).shape[0] == 5, f
        assert torch.equal(getattr(vmap.stats, f),
                           getattr(batched.stats, f)), f


@pytest.mark.parametrize("b,bucket", [(1, 1), (2, 2), (3, 4), (17, 32),
                                      (32, 32), (33, 64)])
def test_bucket_is_the_next_power_of_two(b, bucket):
    assert plan_compile._bucket(b) == bucket


def test_cache_info_counts(wikidb):
    _, tdb, *_ = wikidb
    info = tdb.programs.info()
    assert set(info) == {"hits", "misses", "compiles", "programs"}
    assert info["compiles"] == info["misses"] == info["programs"]
    assert len(tdb.programs) == info["programs"]


# -- the catalog and what the port does not have yet ------------------------


def test_create_index_builds_on_the_database_device(wikidb):
    *_, tdata = wikidb
    db = NavixDB(tsyn.make_wiki_like(n_person=8, n_resource=20, d=8,
                                     seed=3).store, device="cpu")
    vecs = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    idx, stats = db.create_index("emb", "Extra", vectors=vecs,
                                 config=NavixConfig(m_u=8,
                                                    ef_construction=64))
    assert idx.device.type == "cpu" and stats.n == 40
    assert db.store.node("Extra").column("embedding").shape == (40, 8)
    assert idx.program_cache is db.programs
    assert isinstance(db.catalog["emb"], IndexEntry)
    with pytest.raises(ValueError, match="already exists"):
        db.create_index("emb", "Extra", vectors=vecs)
    rs = db.execute(Q.match("Extra").knn(vecs[5], k=3, efs=40))
    assert rs.ids[0] == 5 and rs.dists[0] == 0.0


def test_register_index_binds_a_table_by_row_count(wikidb):
    _, _, jidx, _, jdata, tdata = wikidb
    db = NavixDB(device="cpu")
    entry = db.register_index("bare", _port_handle(jidx))
    assert entry.table == "bare" and db.store.node("bare").n == jdata.n_chunks
    db2 = NavixDB(tdata.store, device="cpu")
    assert db2.register_index("e", _port_handle(jidx)).table == "Chunk"


def test_register_rejects_what_the_port_cannot_hold(wikidb):
    _, tdb, jidx, *_ = wikidb
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        tdb.register_index("sharded", object())
    with pytest.raises(TypeError, match="NavixIndex and ShardedNavix"):
        tdb.register_index("jax_index", jidx)
    with pytest.raises(ValueError, match="already exists"):
        tdb.register_index("chunk_emb", _port_handle(jidx))


def test_serve_waits_for_the_serving_slice(wikidb):
    """The serving slice has landed: ``serve()`` returns a live service on
    the database's device. (The sharded arm of the cache has landed too:
    ``tests/test_torch_serving_sharded.py``.)"""
    from repro_torch.serving import SearchService
    _, tdb, *_ = wikidb
    svc = tdb.serve(k_cap=4, efs_cap=8, max_batch=2)
    assert isinstance(svc, SearchService)
    assert svc.entry.name == "chunk_emb" and svc.lanes.device.type == "cpu"
    assert svc.shutdown(timeout=60)


def test_navix_db_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavixDB()
    assert NavixDB(device="cpu").device.type == "cpu"
