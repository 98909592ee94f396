"""The port's ragged ``efs_lanes`` and resumable stepping API
(``parked_state`` / ``engine_refill`` / ``engine_steps`` / ``engine_evict``
/ ``engine_finalize``) against the JAX package's, and against the port's
own one-shot engines.

The JAX index (``conftest.index``: 2500 x 32) is carried across with
``graph_from_numpy``; both packages get the same queries, packed semimasks
and per-lane efs. Against the reference: ids and every ``SearchStats``
field equal, dists allclose at rtol 1e-5 (XLA and torch may sum in another
order; the tolerance of ``tests/test_torch_search.py``). Inside the port,
bit for bit: a ragged lane at efs e equals ``search`` at e, and any
chunking of ``engine_steps`` with refills and evictions between chunks
equals ``search_many``.
"""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.core import search_batch as jsb
from repro_torch.core import bitset
from repro_torch.core import search as tsearch
from repro_torch.core import search_batch as tsb
from repro_torch.core.graph import FIELDS, graph_from_numpy
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.navix import NavixConfig, NavixIndex
from repro_torch.core.search import SearchParams

K, EFS = 10, 40
CPU = torch.device("cpu")
HEURISTICS = ["onehop_s", "directed", "blind", "adaptive_g",
              "adaptive_local", "onehop_a"]
#: per-request selection cut (fraction of n: node ids below it) and efs
CUTS = (0.1, 0.5, 1.0, 0.3, 0.05, 0.8, 0.2, 1.0, 0.4, 0.6, 0.15, 0.9)
EFS_LANES = (12, 40, 20, 33, 10, 40, 25, 16, 40, 11, 30, 18)


@pytest.fixture(scope="module")
def port_index(index):
    g = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                          for f in FIELDS}, device="cpu")
    return NavixIndex.from_graph(g, NavixConfig(**index.config._asdict()),
                                 device="cpu")


def _words(n, cuts):
    """uint32[len(cuts), W]: lane j selects the node ids below cuts[j]*n."""
    return jbitset.pack_np(np.stack([np.arange(n) < int(c * n)
                                     for c in cuts]))


def _h(name):
    return int(Heuristic.from_name(name))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_ref(port_ids, port_d, port_stats, ref_ids, ref_d, ref_stats):
    np.testing.assert_array_equal(_np(port_ids), _np(ref_ids))
    for f in ref_stats:
        np.testing.assert_array_equal(_np(port_stats[f]), _np(ref_stats[f]),
                                      err_msg=f"stats.{f}")
    np.testing.assert_allclose(_np(port_d), _np(ref_d), rtol=1e-5)


def _stats(res):
    return {f: getattr(res.stats, f) for f in res.stats._fields}


# -- ragged efs_lanes through the one-shot engine ------------------------------


@pytest.mark.parametrize("lanes", ["shared", "per_lane"])
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_ragged_search_many_matches_reference(index, port_index, queries,
                                              heuristic, lanes):
    n = index.graph.n
    words = (_words(n, [0.3])[0] if lanes == "shared"
             else _words(n, CUTS))
    efs = np.asarray(EFS_LANES, np.int32)
    h = _h(heuristic)
    ref = jsb.search_many(index.graph, jnp.asarray(queries),
                          jnp.asarray(words), index._params(K, EFS, h),
                          efs_lanes=jnp.asarray(efs))
    port = tsb.search_many(port_index.graph, torch.from_numpy(queries),
                           bitset.from_words(words, CPU),
                           SearchParams(k=K, efs=EFS, heuristic=h),
                           efs_lanes=torch.from_numpy(efs))
    _assert_ref(port.ids, port.dists, _stats(port), ref.ids, ref.dists,
                _stats(ref))


@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_ragged_lane_equals_search_at_its_efs(port_index, queries,
                                              heuristic):
    """A lane at efs e in a cap-wide batch is bit for bit the single-query
    search at efs e (ids, dists and every stat)."""
    g = port_index.graph
    sel = bitset.from_words(_words(g.n, CUTS), CPU)
    h = _h(heuristic)
    many = tsb.search_many(g, torch.from_numpy(queries), sel,
                           SearchParams(k=K, efs=EFS, heuristic=h),
                           efs_lanes=torch.tensor(EFS_LANES,
                                                  dtype=torch.int32))
    for i, e in enumerate(EFS_LANES):
        one = tsearch.search(g, torch.from_numpy(queries[i]), sel[i],
                             SearchParams(k=K, efs=e, heuristic=h))
        assert torch.equal(one.ids, many.ids[i]), f"lane {i} (efs {e}) ids"
        assert torch.equal(one.dists, many.dists[i]), f"lane {i} dists"
        for f in one.stats._fields:
            assert torch.equal(getattr(one.stats, f),
                               getattr(many.stats, f)[i]), f"lane {i} {f}"


@pytest.mark.parametrize("heuristic", ["adaptive_local", "blind"])
def test_uniform_efs_lanes_change_nothing(port_index, queries, heuristic):
    g = port_index.graph
    sel = bitset.from_words(_words(g.n, CUTS), CPU)
    params = SearchParams(k=K, efs=EFS, heuristic=_h(heuristic))
    Q = torch.from_numpy(queries)
    plain = tsb.search_many(g, Q, sel, params)
    uniform = tsb.search_many(g, Q, sel, params, efs_lanes=torch.full(
        (len(Q),), EFS, dtype=torch.int32))
    assert torch.equal(plain.ids, uniform.ids)
    assert torch.equal(plain.dists, uniform.dists)
    for f in plain.stats._fields:
        assert torch.equal(getattr(plain.stats, f),
                           getattr(uniform.stats, f)), f


def test_r_max_takes_a_scalar_or_per_lane_efs():
    st = tsb.parked_state(8, 2, SearchParams(k=2, efs=3), CPU)
    st = st._replace(d=torch.tensor([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]]),
                     ids=torch.tensor([[0, 1, 2], [3, 4, -1]],
                                      dtype=torch.int32),
                     sel=torch.tensor([[True, True, True],
                                       [True, True, False]]))
    assert tsb._r_max(st, 3).tolist() == [3.0, float("inf")]
    assert tsb._r_max(st, torch.tensor([3, 2],
                                       dtype=torch.int32)).tolist() == [3.0,
                                                                         2.0]


def test_search_many_rejects_efs_lanes_off_the_graphs_device(port_index,
                                                             queries):
    g = port_index.graph
    with pytest.raises(ValueError, match="efs_lanes"):
        tsb.search_many(g, torch.from_numpy(queries[:2]),
                        bitset.full_mask(g.n, CPU), SearchParams(k=K, efs=EFS),
                        efs_lanes=torch.full((2,), EFS, dtype=torch.int32,
                                             device="meta"))


# -- the stepping API ----------------------------------------------------------


class _Port:
    """The port's stepping API over numpy host buffers."""

    def __init__(self, g):
        self.g = g

    def parked(self, bsz, params):
        return (tsb.parked_state(self.g.n, bsz, params, CPU),
                torch.zeros(bsz, dtype=torch.int32))

    def refill(self, Qh, selh, st, udc, mask, params):
        return tsb.engine_refill(self.g, torch.from_numpy(Qh.copy()),
                                 bitset.from_words(selh, CPU), st, udc,
                                 torch.from_numpy(mask.copy()), params)

    def steps(self, Qh, selh, st, params, n_steps, efsh):
        st, live = tsb.engine_steps(
            self.g, torch.from_numpy(Qh.copy()), bitset.from_words(selh, CPU),
            st, params, n_steps, efs_lanes=torch.from_numpy(efsh.copy()))
        return st, live.numpy()

    def evict(self, st, udc, mask):
        return tsb.engine_evict(st, udc, torch.from_numpy(mask.copy()))

    def finalize(self, st, udc, params):
        return tsb.engine_finalize(st, udc, params)


class _Ref:
    """The reference's stepping API over the same host buffers."""

    def __init__(self, g):
        self.g = g

    def parked(self, bsz, params):
        return (jsb.parked_state(self.g.n, bsz, params),
                jnp.zeros((bsz,), jnp.int32))

    def refill(self, Qh, selh, st, udc, mask, params):
        return jsb.engine_refill(self.g, jnp.asarray(Qh), jnp.asarray(selh),
                                 st, udc, jnp.asarray(mask), params)

    def steps(self, Qh, selh, st, params, n_steps, efsh):
        st, live = jsb.engine_steps(self.g, jnp.asarray(Qh),
                                    jnp.asarray(selh), st, params, n_steps,
                                    efs_lanes=jnp.asarray(efsh))
        return st, np.asarray(live)

    def evict(self, st, udc, mask):
        return jsb.engine_evict(st, udc, jnp.asarray(mask))

    def finalize(self, st, udc, params):
        return jsb.engine_finalize(st, udc, params)


def _drive(api, params, Q, words, efs, n_steps, bsz=4):
    """Serve every request through a ``bsz``-lane batch: refill free lanes,
    step a chunk, finalize converged lanes; right after the first refill
    the last lane is evicted (unstepped), and after the first chunk one
    running lane is evicted mid-flight; both requests go back to the
    queue. Returns {request: (ids[efs], dists[efs], stats)} and the number
    of chunks."""
    n_req, d = Q.shape
    st, udc = api.parked(bsz, params)
    Qh = np.zeros((bsz, d), np.float32)
    selh = np.zeros((bsz, words.shape[1]), np.uint32)
    efsh = np.full(bsz, params.efs, np.int32)
    lane = [None] * bsz
    pending = deque(range(n_req))
    out, chunks = {}, 0

    def evict(i):
        nonlocal st, udc
        mask = np.zeros(bsz, bool)
        mask[i] = True
        st, udc = api.evict(st, udc, mask)
        pending.appendleft(lane[i])
        lane[i] = None

    while pending or any(r is not None for r in lane):
        refill = np.zeros(bsz, bool)
        for i in range(bsz):
            if lane[i] is None and pending:
                j = pending.popleft()
                lane[i], Qh[i], selh[i], efsh[i] = j, Q[j], words[j], efs[j]
                refill[i] = True
        if refill.any():
            st, udc = api.refill(Qh, selh, st, udc, refill, params)
        if chunks == 0:
            evict(bsz - 1)
        st, live = api.steps(Qh, selh, st, params, n_steps, efsh)
        chunks += 1
        done = [i for i in range(bsz) if lane[i] is not None and not live[i]]
        if done:
            fin = api.finalize(st, udc, params)
            for i in done:
                out[lane[i]] = (_np(fin.ids)[i], _np(fin.dists)[i],
                                {f: _np(getattr(fin.stats, f))[i]
                                 for f in fin.stats._fields})
                lane[i] = None
        running = [i for i in range(bsz) if lane[i] is not None]
        if chunks == 1 and running:
            evict(running[0])
    return out, chunks


@pytest.mark.parametrize("heuristic", ["adaptive_local", "directed",
                                       "adaptive_g"])
@pytest.mark.parametrize("n_steps", [1, 3, 32, 0])
def test_stepping_equals_search_many_bitwise(port_index, queries, n_steps,
                                             heuristic):
    """Any chunking of engine_steps, with refills and evictions between
    chunks, serves each request bit for bit as the one-shot ragged
    search_many (ids, dists, every stat)."""
    g = port_index.graph
    words = _words(g.n, CUTS)
    efs = np.asarray(EFS_LANES, np.int32)
    params = SearchParams(k=K, efs=EFS, heuristic=_h(heuristic))
    many = tsb.search_many(g, torch.from_numpy(queries),
                           bitset.from_words(words, CPU), params,
                           efs_lanes=torch.from_numpy(efs))
    out, chunks = _drive(_Port(g), params, queries, words, efs, n_steps)
    assert sorted(out) == list(range(len(queries)))
    if n_steps == 1:
        assert chunks > 10, "single-iteration chunks must take many calls"
    for j, (ids, dists, stats) in out.items():
        np.testing.assert_array_equal(ids[:K], many.ids[j].numpy(),
                                      err_msg=f"request {j}")
        np.testing.assert_array_equal(dists[:K], many.dists[j].numpy())
        assert (ids[efs[j]:] == -1).all(), "the ragged tail must stay empty"
        for f in many.stats._fields:
            np.testing.assert_array_equal(
                stats[f], getattr(many.stats, f)[j].numpy(),
                err_msg=f"request {j} stats.{f}")


@pytest.mark.parametrize("n_steps", [3, 0])
def test_stepping_matches_reference_sequence(index, port_index, queries,
                                             n_steps):
    """The same engine_* call sequence (refill, evict, steps, finalize) in
    both packages: per request ids and stats equal, dists allclose, and
    the same number of chunks."""
    words = _words(index.graph.n, CUTS)
    efs = np.asarray(EFS_LANES, np.int32)
    h = _h("adaptive_local")
    ref, ref_chunks = _drive(_Ref(index.graph), index._params(K, EFS, h),
                             queries, words, efs, n_steps)
    port, port_chunks = _drive(_Port(port_index.graph),
                               SearchParams(k=K, efs=EFS, heuristic=h),
                               queries, words, efs, n_steps)
    assert port_chunks == ref_chunks
    assert sorted(port) == sorted(ref)
    for j in ref:
        _assert_ref(port[j][0], port[j][1], port[j][2], ref[j][0], ref[j][1],
                    ref[j][2])


def _clone(st):
    return tsb._BatchState(*(t.clone() for t in st))


def _assert_same_state(a, b):
    for f, x, y in zip(tsb._BatchState._fields, a, b):
        assert torch.equal(x, y), f"state field {f} changed"


def test_steps_on_a_converged_batch_change_no_bit(port_index, queries):
    g = port_index.graph
    params = SearchParams(k=K, efs=EFS)
    sel = bitset.from_words(_words(g.n, CUTS[:4]), CPU)
    Q = torch.from_numpy(queries[:4])
    efs = torch.tensor(EFS_LANES[:4], dtype=torch.int32)
    st = tsb.parked_state(g.n, 4, params, CPU)
    udc = torch.zeros(4, dtype=torch.int32)
    # a parked batch: stepping it is a no-op
    before = _clone(st)
    st, live = tsb.engine_steps(g, Q, sel, st, params, 5, efs_lanes=efs)
    assert not live.any()
    _assert_same_state(st, before)
    # refill lanes 0-2, run them to convergence; lane 3 stays parked
    st, udc = tsb.engine_refill(g, Q, sel, st, udc,
                                torch.tensor([True, True, True, False]), params)
    st, live = tsb.engine_steps(g, Q, sel, st, params, 0, efs_lanes=efs)
    assert not live.any()
    before = _clone(st)
    for n_steps in (1, 7, 0):
        st, live = tsb.engine_steps(g, Q, sel, st, params, n_steps,
                                    efs_lanes=efs)
        assert not live.any()
        _assert_same_state(st, before)


def test_refill_and_evict_touch_only_their_lanes(port_index, queries):
    g = port_index.graph
    params = SearchParams(k=K, efs=EFS)
    sel = bitset.from_words(_words(g.n, CUTS[:3]), CPU)
    Q = torch.from_numpy(queries[:3])
    st = tsb.parked_state(g.n, 3, params, CPU)
    udc = torch.zeros(3, dtype=torch.int32)
    st, udc = tsb.engine_refill(g, Q, sel, st, udc,
                                torch.tensor([True, True, False]), params)
    assert (udc[:2] > 0).all() and udc[2] == 0
    st, _ = tsb.engine_steps(g, Q, sel, st, params, 4)
    before = _clone(st)
    st, udc = tsb.engine_evict(st, udc, torch.tensor([False, True, False]))
    for f, new, old in zip(tsb._BatchState._fields, st, before):
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2]), f
    assert (st.ids[1] == -1).all() and st.exp[1].all() and not st.sel[1].any()
    assert torch.isinf(st.d[1]).all() and st.it[1] == 0 and udc[1] == 0
    # an evicted row keeps only the dump column; finalize gives all -1
    assert st.visited[1, :-1].sum() == 0 and st.visited[1, -1]
    fin = tsb.engine_finalize(st, udc, params)
    assert (fin.ids[1] == -1).all() and torch.isinf(fin.dists[1]).all()
    # a refill of lane 1 alone leaves lanes 0 and 2 bit for bit
    before = _clone(st)
    st, udc = tsb.engine_refill(g, Q, sel, st, udc,
                                torch.tensor([False, True, False]), params)
    for f, new, old in zip(tsb._BatchState._fields, st, before):
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2]), f
    assert st.visited[1, :-1].sum() == 1 and st.ids[1, 0] >= 0


def test_parked_state_matches_reference(index, port_index):
    params = SearchParams(k=K, efs=EFS)
    ref = jsb.parked_state(index.graph.n, 4, index._params(K, EFS, 0))
    port = tsb.parked_state(port_index.graph.n, 4, params, CPU)
    for f in ("d", "ids", "exp", "sel", "it", "t_dc", "s_dc", "picks"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert port.visited.shape == (4, port_index.graph.n + 1)
    assert port.visited[:, :-1].sum() == 0 and port.visited[:, -1].all()
    assert tsb.engine_refill is tsb.refill_lanes
    assert tsb.engine_steps is tsb.step_lanes
    assert tsb.engine_evict is tsb.evict_lanes
    assert tsb.engine_finalize is tsb.finalize_lanes
