"""The port's sharding (``repro_torch.core.distributed``) against the JAX
package's, on a ``"cpu"`` device grid.

Both packages get the same data (``gaussian_mixture(640, 16, 8)`` cut to
637 rows, so S in {2, 4} pads the last shard), queries and masks. The
shard graphs are built once per S in a module fixture, the reference's
with ``repro.core.build.build`` on each padded slice. Against the
reference oracle ``repro.core.distributed.per_shard_reference`` (the
unsharded batched engine per shard, merged by numpy ``lexsort``), called
with a stand-in holding the JAX shard graphs (one JAX device serves every
S): ids and every ``SearchStats`` field equal, dists allclose at rtol 1e-5
(XLA and torch may sum in another order; the tolerance of
``tests/test_torch_search.py``). At S = 1 also against the reference's own
``ShardedNavix.search_many`` on a ``(1, 1)`` mesh. Inside the port, bit
for bit: ``search_many`` against the port's own ``per_shard_reference``, a
data = 2 grid against data = 1, the stepping programs against the one-shot
search.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.core import distributed as jdist
from repro.core.build import build as jbuild
from repro.core.navix import NavixConfig as JNavixConfig
from repro.core.search import SearchParams as JSearchParams
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import bitset
from repro_torch.core.distributed import (Mesh, ShardedNavix, make_mesh,
                                          merge_shard_topk,
                                          per_shard_reference,
                                          reference_merge, shard_searches)
from repro_torch.core.graph import FIELDS
from repro_torch.core.navix import NavixConfig

HEURISTICS = ["onehop_s", "directed", "blind", "adaptive_g",
              "adaptive_local", "onehop_a"]
#: sigma=0 and sigma=1 lanes fused with mid/low selectivities in one batch
SIGMAS = [1.0, 0.4, 0.1, 0.0, 0.03, 0.7]
SHARD_COUNTS = [1, 2, 4]
N = 637
K, EFS = 6, 24
STAT_FIELDS = ("iters", "t_dc", "s_dc", "upper_dc", "picks")
CFG = dict(m_u=8, ef_construction=48, metric="l2", seed=0)


def _lane_masks(n, sigmas, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in sigmas:
        if s >= 1.0:
            out.append(np.ones(n, bool))
        elif s <= 0.0:
            out.append(np.zeros(n, bool))
        else:
            out.append(rng.random(n) < s)
    return np.stack(out)


@pytest.fixture(scope="module")
def env():
    """(X, queries, factory): ``factory(S)`` -> (port ShardedNavix on a
    (1, S) cpu grid, the JAX shard graphs, the oracle's stand-in)."""
    X, _, centers = gaussian_mixture(640, 16, 8, seed=0)
    X = X[:N]
    rng = np.random.default_rng(7)
    base = centers[rng.integers(0, len(centers), size=8)]
    qs = (base + 0.25 * rng.normal(size=base.shape)).astype(np.float32)
    built = {}

    def factory(s):
        if s not in built:
            sn = ShardedNavix.build(X, NavixConfig(**CFG),
                                    make_mesh((1, s), device="cpu"))
            nl = sn.n_local
            V = np.concatenate([X, np.repeat(X[-1:], s * nl - N, 0)])
            jgraphs = [jbuild(jnp.asarray(V[i * nl:(i + 1) * nl]),
                              JNavixConfig(**CFG).build_params())[0]
                       for i in range(s)]
            stand = SimpleNamespace(
                n_shards=s, n_local=nl, n_total=N,
                _prep_query=lambda q: jnp.asarray(q, jnp.float32),
                graphs=jdist._stack_graphs(jgraphs))
            built[s] = (sn, jgraphs, stand)
        return built[s]

    return X, qs, factory


def _jparams(k, efs, heuristic):
    from repro.core.heuristics import Heuristic
    return JSearchParams(k=k, efs=efs,
                         heuristic=int(Heuristic.from_name(heuristic)),
                         metric="l2")


def _assert_ref(res, ref_d, ref_i, ref_stats, what):
    np.testing.assert_array_equal(res.ids.numpy(), ref_i,
                                  err_msg=f"ids ({what})")
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(
            getattr(res.stats, f).numpy(), np.asarray(getattr(ref_stats, f)),
            err_msg=f"stats.{f} ({what})")
    np.testing.assert_allclose(res.dists.numpy(), ref_d, rtol=1e-5)


def _assert_same(a, b, what=""):
    assert torch.equal(a.ids, b.ids), what
    assert torch.equal(a.dists, b.dists), what
    for f in STAT_FIELDS:
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), \
            f"stats.{f} {what}"


# -- the build -----------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_graphs_equal_reference_build(env, n_shards):
    """Each shard's graph equals the reference's build on its padded slice,
    field for field, and lives on its column's device."""
    _, _, factory = env
    sn, jgraphs, _ = factory(n_shards)
    assert sn.n_local == -(-N // n_shards) and sn.n_total == N
    assert len(sn.graphs) == n_shards
    for s, (g, jg) in enumerate(zip(sn.graphs, jgraphs)):
        assert g.device == sn._cell(0, s)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(g, f).numpy(), np.asarray(getattr(jg, f)),
                err_msg=f"shard {s} field {f}")


# -- lane-for-lane equivalence -------------------------------------------------


@pytest.mark.parametrize("lanes", ["per_lane", "shared"])
@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_search_many_matches_reference_oracle(env, n_shards, heuristic,
                                              lanes):
    _, qs, factory = env
    sn, _, stand = factory(n_shards)
    Q = qs[:len(SIGMAS)]
    if lanes == "per_lane":
        masks = _lane_masks(N, SIGMAS, seed=3)
        semimask = masks
    else:
        semimask = _lane_masks(N, [0.4], seed=5)[0]
        masks = np.broadcast_to(semimask, (len(Q), N))
    res = sn.search_many(Q, semimask=semimask, k=K, efs=EFS,
                         heuristic=heuristic)
    ref_d, ref_i, ref_stats = jdist.per_shard_reference(
        stand, Q, masks, _jparams(K, EFS, heuristic))
    _assert_ref(res, ref_d, ref_i, ref_stats, f"{heuristic}, S={n_shards}")
    # inside the port: bit for bit its own oracle
    own_d, own_i, own_stats = per_shard_reference(
        sn, Q, masks, sn._params(K, EFS, heuristic))
    np.testing.assert_array_equal(res.ids.numpy(), own_i)
    np.testing.assert_array_equal(res.dists.numpy(), own_d)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(res.stats, f).numpy(),
                                      getattr(own_stats, f))
    if heuristic != "onehop_a":          # onehop_a ignores the semimask
        ids = res.ids.numpy()
        for b in range(len(Q)):
            row = ids[b][ids[b] >= 0]
            assert masks[b][row].all(), f"lane {b} returned unselected ids"
        if lanes == "per_lane":
            assert (ids[3] == -1).all(), "sigma=0 lane must come back empty"


@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_matches_jax_sharded_navix_at_one_shard(env, heuristic):
    """S = 1: the reference's own ShardedNavix (``shard_map`` on a (1, 1)
    mesh) over the same graph gives the same ids and stats."""
    _, qs, factory = env
    sn, jgraphs, stand = factory(1)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jsn = jdist.ShardedNavix(mesh=mesh, graphs=stand.graphs, n_local=N,
                             n_total=N, config=JNavixConfig(**CFG))
    masks = _lane_masks(N, SIGMAS, seed=3)
    Q = qs[:len(SIGMAS)]
    ref = jsn.search_many(Q, semimask=masks, k=K, efs=EFS,
                          heuristic=heuristic)
    res = sn.search_many(Q, semimask=masks, k=K, efs=EFS,
                         heuristic=heuristic)
    _assert_ref(res, np.asarray(ref.dists), np.asarray(ref.ids), ref.stats,
                f"{heuristic}, jax ShardedNavix")


# -- quorum --------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4])
def test_quorum_dead_shard_equals_alive_restricted(env, n_shards):
    """One dead shard => the reference oracle merged over the alive shards
    only, and no dead-shard id appears; a quorum it misses raises."""
    _, qs, factory = env
    sn, _, stand = factory(n_shards)
    masks = _lane_masks(N, [0.5, 1.0, 0.08, 0.3], seed=11)
    Q = qs[:4]
    dead = n_shards - 1
    alive = np.ones(n_shards, bool)
    alive[dead] = False
    res = sn.search_many(Q, semimask=masks, k=K, efs=EFS, alive=alive,
                         quorum=n_shards - 1)
    ref_d, ref_i, ref_stats = jdist.per_shard_reference(
        stand, Q, masks, _jparams(K, EFS, "adaptive_local"), alive=alive)
    _assert_ref(res, ref_d, ref_i, ref_stats, f"alive {alive}")
    # one set of the oracle's searches serves both liveness masks
    searches = shard_searches(sn, Q, masks, sn._params(K, EFS,
                                                       "adaptive_local"))
    for a, want in ((alive, res), (None, sn.search_many(
            Q, semimask=masks, k=K, efs=EFS))):
        d, i, st = reference_merge(sn, searches, K, a)
        np.testing.assert_array_equal(want.ids.numpy(), i)
        np.testing.assert_array_equal(want.dists.numpy(), d)
        for f in STAT_FIELDS:
            np.testing.assert_array_equal(getattr(want.stats, f).numpy(),
                                          getattr(st, f))
    ids = res.ids.numpy()
    assert not ((ids >= dead * sn.n_local) & (ids >= 0)).any(), \
        "a dead shard's id surfaced"
    with pytest.raises(RuntimeError, match="quorum not met"):
        sn.search_many(Q, semimask=masks, k=K, efs=EFS, alive=alive,
                       quorum=n_shards)


def test_alive_and_quorum_errors_match_reference(env):
    """The alive-shape and quorum errors are the reference's, word for
    word (both raise before any search)."""
    _, qs, factory = env
    sn, _, stand = factory(1)
    jsn = jdist.ShardedNavix(mesh=jax.make_mesh((1, 1), ("data", "model")),
                             graphs=stand.graphs, n_local=N, n_total=N,
                             config=JNavixConfig(**CFG))
    msgs = []
    for index in (sn, jsn):
        with pytest.raises(ValueError, match="alive mask has shape") as e:
            index.search_many(qs[:2], k=K, alive=np.ones(3, bool))
        with pytest.raises(RuntimeError, match="quorum not met") as q:
            index.search_many(qs[:2], k=K, alive=np.zeros(1, bool),
                              quorum=1)
        msgs.append((str(e.value), str(q.value)))
    assert msgs[0] == msgs[1]


# -- padded rows -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["all_ones_local_words", "onehop_a"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_padded_rows_never_surface(env, n_shards, case):
    """A caller-built all-ones local bitset (its padded bits set too) and
    ONEHOP_A, which ignores the semimask, both reach the padded rows,
    which the merge guard drops."""
    X, qs, factory = env
    sn, _, _ = factory(n_shards)
    assert n_shards * sn.n_local > N            # this grid pads
    # queries at the last real row: the padded copies tie with it
    Q = np.repeat(qs[:1], 4, 0)
    Q[:2] = X[-1]
    if case == "all_ones_local_words":
        words = np.full((n_shards, sn.n_words_local), 0xFFFFFFFF, np.uint32)
        res = sn.search_many(Q, semimask=words, k=K, efs=EFS)
    else:
        res = sn.search_many(Q, k=K, efs=EFS, heuristic="onehop_a")
    ids = res.ids.numpy()
    assert (ids < N).all(), f"a padded id surfaced: {ids.max()}"
    assert (ids[:2, 0] == N - 1).all()
    assert ((ids >= 0) == np.isfinite(res.dists.numpy())).all()


# -- the data axis -------------------------------------------------------------


@pytest.mark.parametrize("lanes", ["per_lane", "shared"])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_data_axis_equals_one_row_bitwise(env, n_shards, lanes):
    """The same shard graphs wrapped under a (2, S) grid: each lane block
    is stepped on its own row, and the result is the (1, S) grid's, bit
    for bit; a batch the data axis does not divide raises."""
    _, qs, factory = env
    sn, _, _ = factory(n_shards)
    sn2 = ShardedNavix(mesh=make_mesh((2, n_shards), device="cpu"),
                       graphs=sn.graphs, n_local=sn.n_local,
                       n_total=sn.n_total, config=sn.config)
    assert sn2.lane_shards == 2 and sn2.n_shards == n_shards
    semimask = (_lane_masks(N, SIGMAS, seed=3) if lanes == "per_lane"
                else _lane_masks(N, [0.4], seed=5)[0])
    Q = qs[:len(SIGMAS)]
    _assert_same(sn.search_many(Q, semimask=semimask, k=K, efs=EFS),
                 sn2.search_many(Q, semimask=semimask, k=K, efs=EFS))
    with pytest.raises(ValueError, match="not divisible by the data-axis"):
        sn2.search_many(qs[:3], k=K, efs=EFS)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_stepping_programs_equal_one_shot(env, n_shards):
    """parked -> refill -> steps in chunks with an eviction between them
    -> finalize equals the one-shot search at k = efs; finalize_beams
    equals finalize's ids and dists; on a (2, S) grid too."""
    _, qs, factory = env
    sn, _, _ = factory(n_shards)
    for grid in (sn, ShardedNavix(mesh=make_mesh((2, n_shards),
                                                 device="cpu"),
                                  graphs=sn.graphs, n_local=sn.n_local,
                                  n_total=sn.n_total, config=sn.config)):
        params = grid._params(EFS, EFS, "adaptive_local")
        masks = _lane_masks(N, SIGMAS[:4], seed=9)
        Q = grid._prep_query(qs[:4])
        sel = grid.shard_semimask(masks)
        st, udc = grid.parked_state(4, params)
        st, udc = grid.refill_program(params)(
            grid.graphs, Q, sel, st, udc, np.ones(4, bool))
        steps = grid.steps_program(params)
        live = torch.ones(4, dtype=torch.bool)
        n_chunks = 0
        while bool(live.any()):
            st, live = steps(grid.graphs, Q, sel, st, 3)
            n_chunks += 1
        assert n_chunks > 1
        alive = np.ones(n_shards, bool)
        fin = grid.finalize_program(params)(st, udc, alive)
        want = grid.search_many(qs[:4], semimask=masks, k=EFS, efs=EFS)
        _assert_same(fin, want, "finalize vs one-shot")
        d, ids = grid.finalize_beams_program(params)(st, udc, alive)
        assert torch.equal(ids, fin.ids) and torch.equal(d, fin.dists)
        # evicted lanes come back empty on every shard
        st, udc = grid.evict_program(params)(
            st, udc, np.array([False, True, False, True]))
        d, ids = grid.finalize_beams_program(params)(st, udc, alive)
        assert (ids[[1, 3]] == -1).all()
        assert torch.equal(ids[[0, 2]], fin.ids[[0, 2]])


# -- the merge, the lanes helper, the semimask ------------------------------------


def _random_shard_lists(s, b, l, seed, pad_frac):
    """Per-shard candidate lists with duplicate distances and random
    padding; ids unique across (shard, slot), as shards own disjoint
    global id ranges (the reference test's generator)."""
    rng = np.random.default_rng(seed)
    d = rng.choice([0.0, 0.25, 0.5, 1.0, 2.0], size=(s, b, l))
    ids = np.broadcast_to(
        (np.arange(s)[:, None, None] * l + np.arange(l)[None, None, :]),
        (s, b, l)).copy().astype(np.int32)
    pad = rng.random((s, b, l)) < pad_frac
    d = np.where(pad, np.inf, d).astype(np.float32)
    ids = np.where(pad, -1, ids).astype(np.int32)
    return d, ids


def test_merge_topk_matches_lexsort_rule():
    """Random shard counts / paddings / duplicate distances: the merged
    top-k is sorted, -1 exactly on the +inf slots, no id twice, and
    exactly the numpy lexicographic-(d, id) rule of the reference's
    test."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(s=st.integers(1, 5), b=st.integers(1, 3), l=st.integers(1, 6),
           k_frac=st.floats(0.1, 1.5), seed=st.integers(0, 2**31 - 1),
           pad_frac=st.sampled_from([0.0, 0.3, 0.95]))
    @settings(max_examples=40, deadline=None)
    def run(s, b, l, k_frac, seed, pad_frac):
        k = max(1, min(int(k_frac * s * l), s * l))
        d, ids = _random_shard_lists(s, b, l, seed, pad_frac)
        out_d, out_i = merge_shard_topk(torch.from_numpy(d),
                                        torch.from_numpy(ids), k)
        out_d, out_i = out_d.numpy(), out_i.numpy()
        assert out_d.shape == out_i.shape == (b, k)
        # sorted ascending (a +inf, +inf pair is in order; np.diff of it
        # would be NaN)
        assert (out_d[:, 1:] >= out_d[:, :-1]).all()
        flat_d = np.swapaxes(d, 0, 1).reshape(b, s * l)
        flat_i = np.swapaxes(ids, 0, 1).reshape(b, s * l)
        for row in range(b):
            finite = np.isfinite(out_d[row])
            np.testing.assert_array_equal(out_i[row] >= 0, finite)
            got = out_i[row][finite]
            assert len(set(got.tolist())) == len(got)
            assert np.isin(got, flat_i[row][flat_i[row] >= 0]).all()
            order = np.lexsort((flat_i[row], flat_d[row]))[:k]
            ref_d = flat_d[row][order]
            ref_i = np.where(np.isfinite(ref_d), flat_i[row][order], -1)
            np.testing.assert_array_equal(out_d[row], ref_d)
            np.testing.assert_array_equal(out_i[row], ref_i)

    run()


def test_merge_topk_shard_order_invariant():
    """Permuting the shard axis never changes the merged output, even with
    duplicate distances across shards."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @given(s=st.integers(2, 5), b=st.integers(1, 3), l=st.integers(1, 6),
           seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=30, deadline=None)
    def run(s, b, l, seed):
        d, ids = _random_shard_lists(s, b, l, seed, 0.3)
        k = s * l
        perm = np.random.default_rng(seed).permutation(s)
        a = merge_shard_topk(torch.from_numpy(d), torch.from_numpy(ids), k)
        p = merge_shard_topk(torch.from_numpy(d[perm]),
                             torch.from_numpy(ids[perm]), k)
        assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])

    run()


def test_merge_topk_rejects_overlong_k():
    d = torch.zeros((2, 1, 3))
    ids = torch.zeros((2, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="k=7 > S\\*L=6"):
        merge_shard_topk(d, ids, 7)
    with pytest.raises(ValueError) as ref:
        jdist.merge_shard_topk(jnp.zeros((2, 1, 3)),
                               jnp.zeros((2, 1, 3), jnp.int32), 7)
    with pytest.raises(ValueError) as port:
        merge_shard_topk(d, ids, 7)
    assert str(ref.value) == str(port.value)


def test_broadcast_shard_lanes():
    """[S, W] -> [S, B, W] equal to the reference's broadcast; [S, B, W]
    passes through; a lane-count mismatch raises the reference's error."""
    words = np.arange(2 * 3, dtype=np.uint32).reshape(2, 3) * 0x01010101
    port = bitset.broadcast_shard_lanes(bitset.from_words(words, "cpu"), 4)
    ref = jbitset.broadcast_shard_lanes(jnp.asarray(words), 4)
    np.testing.assert_array_equal(bitset.to_words(port), np.asarray(ref))
    stack = bitset.from_words(np.stack([words] * 4, axis=1), "cpu")
    assert bitset.broadcast_shard_lanes(stack, 4) is stack
    with pytest.raises(ValueError) as p:
        bitset.broadcast_shard_lanes(stack, 5)
    with pytest.raises(ValueError) as r:
        jbitset.broadcast_shard_lanes(jnp.asarray(np.stack([words] * 4, 1)),
                                      5)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_semimask_words_equal_reference(env, n_shards):
    """``shard_semimask_np`` gives the reference's packed words (shared
    and per-lane, padded bits clear); pre-packed words pass through after
    the reference's shape check; sigma is the reference's."""
    _, _, factory = env
    sn, _, stand = factory(n_shards)
    stand.n_words_local = jbitset.n_words(sn.n_local)
    masks = _lane_masks(N, SIGMAS, seed=3)
    for m in (masks[1], masks):
        want = jdist.ShardedNavix.shard_semimask_np(stand, m)
        got = sn.shard_semimask_np(m)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        words = sn.shard_semimask(m)
        np.testing.assert_array_equal(bitset.to_words(words), want)
        np.testing.assert_array_equal(
            bitset.to_words(sn.shard_semimask(want)), want)
        sig = sn.sigma(words)
        ref_sig = jdist.ShardedNavix.sigma(stand, jnp.asarray(want))
        np.testing.assert_allclose(np.asarray(sig), np.asarray(ref_sig),
                                   rtol=1e-6)
    lists = [None, masks[1], masks[2]]
    np.testing.assert_array_equal(
        bitset.to_words(sn.shard_semimask(lists)),
        jdist.ShardedNavix.shard_semimask_np(
            stand, np.stack([np.ones(N, bool), masks[1], masks[2]])))
    bad = np.zeros((n_shards + 1, stand.n_words_local), np.uint32)
    errs = []
    for fn in (sn.shard_semimask,
               lambda m: jdist.ShardedNavix.shard_semimask(stand, m)):
        with pytest.raises(ValueError, match="pre-packed sharded") as e:
            fn(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="covers"):
        sn.shard_semimask_np(np.ones(N + 1, bool))


# -- the grid ------------------------------------------------------------------


def test_mesh_is_a_grid_of_devices(env, monkeypatch):
    mesh = make_mesh((2, 3), device="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.flat() == (torch.device("cpu"),) * 6
    assert mesh.at({"model": 2, "data": 1}) == torch.device("cpu")
    assert make_mesh((1, 2), device=["cpu", "cpu"]).shape["model"] == 2
    with pytest.raises(ValueError, match="devices for a"):
        make_mesh((1, 2), device=["cpu"])
    with pytest.raises(ValueError, match="rectangular"):
        Mesh([["cpu"], ["cpu", "cpu"]])
    with pytest.raises(ValueError, match="axis names"):
        Mesh([["cpu"]], ("model", "model"))
    sn, _, _ = env[2](2)
    with pytest.raises(ValueError, match="shard graphs"):
        ShardedNavix(mesh=make_mesh((1, 3), device="cpu"), graphs=sn.graphs,
                     n_local=sn.n_local, n_total=N, config=sn.config)
    # no silent fallback: a grid on the card raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 2), device="cuda:0")


def test_search_compat_wrappers(env):
    """``search_fn`` (with a shared mask and its per-lane broadcast) and
    ``search`` equal ``search_many``."""
    _, qs, factory = env
    sn, _, _ = factory(2)
    mask = _lane_masks(N, [0.4], seed=5)[0]
    want = sn.search_many(qs[:4], semimask=mask, k=K, efs=EFS)
    fn = sn.search_fn(K, EFS)
    shared = sn.shard_semimask(mask)
    for sel in (shared, bitset.broadcast_shard_lanes(shared, 4)):
        d, ids = fn(sn._prep_query(qs[:4]), sel, np.ones(2, bool))
        assert torch.equal(ids, want.ids) and torch.equal(d, want.dists)
    d, ids = sn.search(qs[:4], mask, k=K, efs=EFS)
    assert torch.equal(ids, want.ids) and torch.equal(d, want.dists)
    assert all(getattr(want.stats, f).dtype == torch.int32
               for f in STAT_FIELDS)
