"""The port's graph store, plan operators and Wiki-like workloads against
the JAX package's.

Both generators build the small Wiki store from one seed
(``make_wiki_like(n_person=60, n_resource=150, d=16)``); every array of
the two stores must be equal. Each selection plan is evaluated by both
packages over its own store: the bool masks must be equal, and so must
their packed words (the port's ``bitset.pack_np`` against the
reference's). ``correlation_ratio`` agrees within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import bitset as jbitset
from repro.data import synthetic as jsyn
from repro.query import operators as jops
from repro_torch.core import bitset
from repro_torch.data import synthetic as tsyn
from repro_torch.query import operators as tops
from repro_torch.storage import columnar

WIKI = dict(n_person=60, n_resource=150, d=16, seed=0)


@pytest.fixture(scope="module")
def wikis():
    return jsyn.make_wiki_like(**WIKI), tsyn.make_wiki_like(**WIKI)


def _port_plan(node):
    """The port's copy of a reference plan tree, field for field."""
    if not dataclasses.is_dataclass(node):
        return node
    cls = getattr(tops, type(node).__name__)
    return cls(**{f.name: _port_plan(getattr(node, f.name))
                  for f in dataclasses.fields(node)})


def _tree(node):
    """(type name, fields) of a plan tree, comparable across packages."""
    if not dataclasses.is_dataclass(node):
        return node
    return (type(node).__name__,
            tuple((f.name, _tree(getattr(node, f.name)))
                  for f in dataclasses.fields(node)))


def _assert_same_mask(ref_plan, wikis):
    jw, tw = wikis
    ref = jops.evaluate(ref_plan, jw.store)
    port = tops.evaluate(_port_plan(ref_plan), tw.store)
    assert port.table == ref.table
    np.testing.assert_array_equal(port.mask, ref.mask)
    np.testing.assert_array_equal(bitset.pack_np(port.mask),
                                  jbitset.pack_np(ref.mask))
    assert port.selectivity == ref.selectivity
    return port.mask


def test_generators_build_equal_stores(wikis):
    jw, tw = wikis
    for f in ("embeddings", "chunk_is_person", "person_centers",
              "resource_centers"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f),
                                      err_msg=f)
    assert tw.n_chunks == jw.n_chunks and tw.seed == jw.seed
    assert isinstance(tw.store, columnar.GraphStore)
    assert tw.store.nodes.keys() == jw.store.nodes.keys()
    for name, jt in jw.store.nodes.items():
        tt = tw.store.node(name)
        assert (tt.name, tt.n) == (jt.name, jt.n)
        assert tt.columns.keys() == jt.columns.keys()
        for c, col in jt.columns.items():
            np.testing.assert_array_equal(tt.column(c), col, err_msg=c)
            assert tt.column(c).dtype == col.dtype, c
    assert tw.store.rels.keys() == jw.store.rels.keys()
    for name, jr in jw.store.rels.items():
        tr = tw.store.rel(name)
        assert (tr.src_table, tr.dst_table, tr.n_edges) == \
            (jr.src_table, jr.dst_table, jr.n_edges)
        for side in ("fwd", "bwd"):
            a, b = getattr(tr, side), getattr(jr, side)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_array_equal(a.targets, b.targets)
            np.testing.assert_array_equal(a.degrees(), b.degrees())
            assert a.n_src == b.n_src


def test_csr_keeps_edge_order_and_node_rows_pad_to_row_zero():
    src = np.array([2, 0, 2, 1, 0])
    dst = np.array([7, 5, 3, 9, 1])
    csr = columnar.csr_from_edges(src, dst, 4)
    np.testing.assert_array_equal(csr.offsets, [0, 2, 3, 5, 5])
    np.testing.assert_array_equal(csr.neighbors(0), [5, 1])   # edge order
    np.testing.assert_array_equal(csr.neighbors(2), [7, 3])
    assert csr.neighbors(3).size == 0
    t = columnar.NodeTable("T", 3, {"a": np.array([10, 11, 12])})
    np.testing.assert_array_equal(t.rows(np.array([2, -1, 0]))["a"],
                                  [12, 10, 10])
    with pytest.raises(ValueError, match="rows"):
        t.add_column("b", np.zeros(4))
    store = columnar.GraphStore()
    store.add_node_table("A", 2)
    with pytest.raises(ValueError, match="out of range"):
        store.add_rel_table("R", "A", "A", np.array([0]), np.array([2]))
    with pytest.raises(ValueError, match=r"\[n, d\]"):
        store.add_vector_column("A", "v", np.zeros(2))


FILTERS = [
    ("Chunk", "cID", "<", dict(value=300)),
    ("Chunk", "cID", "<=", dict(value=300)),
    ("Chunk", "cID", ">", dict(value=500)),
    ("Chunk", "cID", ">=", dict(value=500)),
    ("Chunk", "cID", "==", dict(value=17)),
    ("Chunk", "cID", "range", dict(lo=100, hi=450)),
    ("Chunk", "cID", "isin", dict(value=[3, 5, 700, 10_000])),
    ("Chunk", "is_person", "==", dict(value=True)),
    ("Person", "birth_date", "range", dict(lo=0, hi=18250)),
    ("Person", "birth_date", "<", dict(value=3650)),
    ("Resource", "rID", "isin", dict(value=np.arange(0, 150, 7))),
]


@pytest.mark.parametrize("table,column,op,kw", FILTERS,
                         ids=[f"{t}.{c}{o}" for t, c, o, _ in FILTERS])
def test_filter_masks_equal(wikis, table, column, op, kw):
    mask = _assert_same_mask(
        jops.Filter(jops.NodeScan(table), column, op, **kw), wikis)
    assert 0 < mask.sum() < mask.size


def test_unknown_filter_op_raises_in_both(wikis):
    jw, tw = wikis
    plan = jops.Filter(jops.NodeScan("Chunk"), "cID", "!=", value=3)
    with pytest.raises(ValueError, match="unknown filter op") as ref:
        jops.evaluate(plan, jw.store)
    with pytest.raises(ValueError, match="unknown filter op") as port:
        tops.evaluate(_port_plan(plan), tw.store)
    assert str(port.value) == str(ref.value)


HOPS = {
    "person_chunk_fwd": jops.HopJoin(
        jops.Filter(jops.NodeScan("Person"), "pID", "<", value=10),
        "PersonChunk", "fwd"),
    "person_chunk_bwd": jops.HopJoin(
        jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=200),
        "PersonChunk", "bwd"),
    "resource_chunk_bwd": jops.HopJoin(
        jops.Filter(jops.NodeScan("Chunk"), "cID", ">=", value=600),
        "ResourceChunk", "bwd"),
    "wikilink_fwd": jops.HopJoin(
        jops.Filter(jops.NodeScan("Person"), "birth_date", "range", lo=0,
                    hi=9000), "WikiLink", "fwd"),
    "empty_selection": jops.HopJoin(
        jops.Filter(jops.NodeScan("Person"), "pID", "<", value=0),
        "PersonChunk", "fwd"),
}


@pytest.mark.parametrize("name", list(HOPS))
def test_hop_join_masks_equal(wikis, name):
    _assert_same_mask(HOPS[name], wikis)


def test_hop_join_matches_csr_oracle(wikis):
    _, tw = wikis
    res = tops.evaluate(_port_plan(HOPS["person_chunk_fwd"]), tw.store)
    rel = tw.store.rel("PersonChunk")
    expect = np.zeros(tw.n_chunks, bool)
    for p in range(10):
        expect[rel.fwd.neighbors(p)] = True
    np.testing.assert_array_equal(res.mask, expect)


#: name -> (generator function, its arguments for a WikiLike)
WORKLOADS = {
    "uncorrelated_0.3": ("uncorrelated_plan", lambda w: (0.3, w.n_chunks)),
    "person_chunk_0.5": ("person_chunk_plan", lambda w: (w.store, 0.5)),
    "person_chunk_1.0": ("person_chunk_plan", lambda w: (w.store, 1.0)),
    "person_chunk_lo": ("person_chunk_plan", lambda w: (w.store, 0.2, 9000)),
    "two_hop_0.5": ("two_hop_plan", lambda w: (w.store, 0.5)),
    "two_hop_0.1": ("two_hop_plan", lambda w: (w.store, 0.1)),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_plans_equal(wikis, name):
    jw, tw = wikis
    fn, args = WORKLOADS[name]
    ref_plan = getattr(jsyn, fn)(*args(jw))
    assert _tree(getattr(tsyn, fn)(*args(tw))) == _tree(ref_plan)
    assert _assert_same_mask(ref_plan, wikis).any()


BOOLEANS = {
    "and": jops.And(jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=400),
                    jops.Filter(jops.NodeScan("Chunk"), "cID", ">=",
                                value=100)),
    "or": jops.Or(HOPS["person_chunk_fwd"],
                  jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=50)),
    "not": jops.Not(jops.Filter(jops.NodeScan("Chunk"), "is_person", "==",
                                value=True)),
    "nested": jops.Not(jops.Or(
        jops.And(HOPS["person_chunk_fwd"],
                 jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=400)),
        jsyn.two_hop_plan(None, 0.3))),
}


@pytest.mark.parametrize("name", list(BOOLEANS))
def test_boolean_combinator_masks_equal(wikis, name):
    _assert_same_mask(BOOLEANS[name], wikis)


def test_boolean_combinator_counts(wikis):
    _, tw = wikis
    a = tops.Filter(tops.NodeScan("Chunk"), "cID", "<", value=200)
    b = tops.Filter(tops.NodeScan("Chunk"), "cID", ">=", value=100)
    assert tops.evaluate(tops.And(a, b), tw.store).mask.sum() == 100
    assert tops.evaluate(tops.Or(a, b), tw.store).mask.all()
    assert tops.evaluate(tops.Not(tops.Or(a, b)), tw.store).mask.sum() == 0


SPLITS = {
    "knn_project_limit": jops.Limit(jops.Project(
        jops.KnnSearch(child=jops.Filter(jops.NodeScan("Chunk"), "cID", "<",
                                         value=10), k=5),
        ("cID", "year")), 3),
    "stacked_rows": jops.Limit(jops.Project(jops.Limit(jops.Project(
        jops.KnnSearch(table="Chunk", k=9, efs=40, heuristic="onehop_a"),
        ("is_person",)), 7), ("cID", "is_person")), 4),
    "selection_only": jops.Project(
        jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=10), ("cID",)),
    "bare_scan": jops.NodeScan("Person"),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_pipeline_and_output_table_equal(wikis, name):
    jw, tw = wikis
    plan = SPLITS[name]
    ref = jops.split_pipeline(plan)
    port = tops.split_pipeline(_port_plan(plan))
    assert _tree(port) == _tree(ref)
    assert tops.output_table(_port_plan(plan), tw.store) == \
        jops.output_table(plan, jw.store)
    assert tops.is_selection(_port_plan(plan)) == jops.is_selection(plan)


BAD_PLANS = {
    "row_op_below_knn": jops.KnnSearch(
        child=jops.Project(jops.NodeScan("Chunk"), ("cID",))),
    "knn_below_knn": jops.KnnSearch(child=jops.KnnSearch(table="Chunk")),
    "not_a_plan": "MATCH (c:Chunk)",
}


@pytest.mark.parametrize("name", list(BAD_PLANS))
def test_split_pipeline_rejects_what_the_reference_rejects(name):
    plan = BAD_PLANS[name]
    with pytest.raises(TypeError) as ref:
        jops.split_pipeline(plan)
    with pytest.raises(TypeError) as port:
        tops.split_pipeline(_port_plan(plan))
    assert str(port.value) == str(ref.value)


def test_output_table_errors_equal(wikis):
    jw, tw = wikis
    mixed = jops.And(jops.NodeScan("Chunk"), jops.NodeScan("Person"))
    bare = jops.KnnSearch()
    for plan, err in ((mixed, ValueError), (bare, ValueError)):
        with pytest.raises(err) as ref:
            jops.output_table(plan, jw.store)
        with pytest.raises(err) as port:
            tops.output_table(_port_plan(plan), tw.store)
        assert str(port.value) == str(ref.value)


def test_evaluate_rejects_row_plans():
    with pytest.raises(TypeError, match="NavixDB"):
        tops.evaluate(tops.KnnSearch(child=tops.NodeScan("Chunk")), None)
    with pytest.raises(TypeError, match="NavixDB"):
        tops.evaluate(tops.Limit(tops.NodeScan("Chunk"), 3), None)


def test_plans_are_hashable_values():
    a = tops.Filter(tops.NodeScan("Chunk"), "cID", "<", value=10)
    b = tops.Filter(tops.NodeScan("Chunk"), "cID", "<", value=10)
    assert a == b and hash(a) == hash(b)
    assert len({a, b, tops.Not(a)}) == 2


@pytest.mark.parametrize("mode", ["uncorrelated", "person", "nonperson"])
def test_make_queries_equal(wikis, mode):
    jw, tw = wikis
    np.testing.assert_array_equal(tsyn.make_queries(tw, 12, mode, seed=5),
                                  jsyn.make_queries(jw, 12, mode, seed=5))


def test_make_queries_rejects_unknown_mode(wikis):
    _, tw = wikis
    with pytest.raises(ValueError):
        tsyn.make_queries(tw, 4, "sideways")


@pytest.mark.parametrize("case", ["uncorrelated", "person", "nonperson",
                                  "empty"])
def test_correlation_ratio_equal(wikis, case):
    jw, tw = wikis
    if case == "uncorrelated":
        ref_plan = jsyn.uncorrelated_plan(0.3, jw.n_chunks)
        mode = "uncorrelated"
    elif case == "empty":
        ref_plan = jops.Filter(jops.NodeScan("Chunk"), "cID", "<", value=0)
        mode = "uncorrelated"
    else:
        ref_plan = jsyn.person_chunk_plan(jw.store, 1.0)
        mode = case
    mask = jops.evaluate(ref_plan, jw.store).mask
    q = jsyn.make_queries(jw, 16, mode, seed=6)
    ref = jsyn.correlation_ratio(jw.embeddings, q, mask, k=50)
    port = tsyn.correlation_ratio(tw.embeddings, q, mask, k=50, device="cpu")
    if case == "empty":
        assert np.isnan(ref) and np.isnan(port)
        return
    assert abs(port - ref) <= 1e-6, (port, ref)
    if case == "person":
        assert port > 1.5          # positive correlation (paper Table 5)
    elif case == "nonperson":
        assert port < 0.5          # negative correlation


def test_correlation_ratio_defaults_to_the_card(wikis, monkeypatch):
    import torch

    _, tw = wikis
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.correlation_ratio(tw.embeddings, tw.embeddings[:2],
                               tw.chunk_is_person, k=5)
