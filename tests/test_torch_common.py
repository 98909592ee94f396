"""The port's shared helpers (``repro_torch.common.util``,
``repro_torch.common.hardware``) and bench presets against the JAX
package's.

``util``'s scalar helpers equal the reference's on a grid of inputs; the
tree walker yields the reference's key paths and leaf order, and
``tree_bytes`` / ``tree_params`` of an ``HnswGraph`` (f32 and int8, as
tensors and as meta tensors) equal the reference's on the same arrays (and
on ``jax.eval_shape`` of them). ``H100_SXM`` holds the data sheet's
values, and ``bound_s`` gives the bounds ``PERF.md`` records for kernels 5
and 6 at (1024, 65,536, 960).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _leaf_key
from repro.common import util as jutil
from repro.configs import navix_paper as jpaper
from repro.core.graph import HnswGraph as JHnswGraph
from repro.core.quantize import QuantizedStore as JQuantizedStore
from repro_torch.common import hardware, util
from repro_torch.configs import navix_paper
from repro_torch.core.graph import FIELDS, HnswGraph, graph_from_numpy
from repro_torch.core.quantize import quantize

import chip_smoke


@pytest.mark.parametrize("name", ["cdiv", "round_up"])
def test_binary_helpers_match_reference(name):
    for a in range(-9, 70):
        for b in (1, 2, 3, 7, 8, 64):
            assert getattr(util, name)(a, b) == getattr(jutil, name)(a, b)


def test_next_pow2_matches_reference():
    for x in range(-3, 5000):
        assert util.next_pow2(x) == jutil.next_pow2(x)


@pytest.mark.parametrize("name", ["human_bytes", "human_count"])
def test_human_helpers_match_reference(name):
    for x in (0, 1, 999, 1000, 1023, 1024, 1536, -2048, 12345.678, 3e9,
              7.5e12, 2 ** 50, 4.2e17, 1e21):
        assert getattr(util, name)(x) == getattr(jutil, name)(x)


def test_timer_accumulates():
    sink = {}
    for _ in range(2):
        with util.timer(sink, "t"):
            pass
    assert set(sink) == {"t"} and sink["t"] >= 0.0


def _graphs(index):
    """(port graph, reference graph) over the same arrays, f32 and int8."""
    port = graph_from_numpy({f: np.asarray(getattr(index.graph, f))
                             for f in FIELDS}, device="cpu")
    qport = port._replace(vectors=quantize(port.vectors))
    ref = index.graph
    qref = ref._replace(vectors=JQuantizedStore(
        codes=jnp.asarray(qport.vectors.codes.numpy()),
        scale=jnp.asarray(qport.vectors.scale.numpy())))
    return {"f32": (port, ref), "int8": (qport, qref)}


def _ref_keys(tree):
    return [_leaf_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _keys(tree):
    return [util.leaf_key(p) for p, _ in util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("resident", ["f32", "int8"])
def test_tree_sizes_match_reference(index, resident):
    port, ref = _graphs(index)[resident]
    assert util.tree_bytes(port) == jutil.tree_bytes(ref)
    assert util.tree_params(port) == jutil.tree_params(ref)
    # meta tensors count as jax.eval_shape's ShapeDtypeStructs do
    meta = port.to(torch.device("meta"))
    like = jax.eval_shape(lambda: ref)
    assert util.tree_bytes(meta) == jutil.tree_bytes(like) \
        == util.tree_bytes(port)
    assert util.tree_params(meta) == jutil.tree_params(like)
    assert util.tree_bytes(port) == port.nbytes()


def test_tree_walker_keys_order_and_roundtrip(index):
    port, ref = _graphs(index)["int8"]
    nested = {"g": [torch.zeros(2), (torch.ones(3),)], "b": {"z": 1, "c": 2},
              "none": None}
    jnested = {"g": [jnp.zeros(2), (jnp.ones(3),)], "b": {"z": 1, "c": 2},
               "none": None}
    assert _keys(nested) == _ref_keys(jnested) == ["b.c", "b.z", "g.0",
                                                  "g.1.0"]
    assert _keys(port) == _ref_keys(ref)
    for tree in (nested, port, [port, port]):
        leaves, treedef = util.tree_flatten_with_path(tree)
        back = util.tree_unflatten(treedef, [x for _, x in leaves])
        assert _keys(back) == _keys(tree)
        assert type(back) is type(tree)
    assert isinstance(util.tree_unflatten(
        util.tree_flatten_with_path(port)[1], util.tree_leaves(port)),
        HnswGraph)
    leaves, treedef = util.tree_flatten_with_path(nested)
    with pytest.raises(ValueError, match="fewer"):
        util.tree_unflatten(treedef, [x for _, x in leaves][:-1])
    with pytest.raises(ValueError, match="more"):
        util.tree_unflatten(treedef, [x for _, x in leaves] + [0])


def test_tree_walker_holds_no_leaf_after_it_returns():
    """Flattening and unflattening leave no reference cycle behind: with
    the garbage collector off, a tree's leaves are freed as soon as the
    tree and the walker's results are dropped (a self-calling nested
    walker would keep them until the collector's next pass)."""
    import gc
    import weakref

    tree = {"a": torch.zeros(3), "b": (torch.ones(2), [torch.zeros(1)]),
            "c": None}
    refs = [weakref.ref(t) for t in util.tree_leaves(tree)]
    gc.disable()
    try:
        paths, treedef = util.tree_flatten_with_path(tree)
        back = util.tree_unflatten(treedef, [leaf for _, leaf in paths])
        assert util.tree_leaves(back)[0] is tree["a"]
        del tree, paths, back
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_assert_no_nans_names_the_leaf_as_the_reference_flags_it():
    tree = {"a": torch.zeros(3), "b": [torch.tensor([1.0, float("nan")])],
            "i": torch.arange(3)}
    jtree = {"a": jnp.zeros(3), "b": [jnp.asarray([1.0, np.nan])],
             "i": jnp.arange(3)}
    with pytest.raises(AssertionError):
        jutil.assert_no_nans(jtree)
    with pytest.raises(AssertionError, match="non-finite values at step b.0"):
        util.assert_no_nans(tree, where="step ")
    tree["b"][0][1] = 2.0
    jtree["b"][0] = jnp.asarray([1.0, 2.0])
    jutil.assert_no_nans(jtree)
    util.assert_no_nans(tree)


def test_split_key_fans_out_independent_generators():
    kids = util.split_key(torch.Generator().manual_seed(0), 3)
    again = util.split_key(torch.Generator().manual_seed(0), 3)
    draws = [torch.rand(4, generator=g) for g in kids]
    assert len(kids) == 3
    for a, g in zip(draws, again):                  # deterministic
        assert torch.equal(a, torch.rand(4, generator=g))
    assert not torch.equal(draws[0], draws[1])      # independent streams


def test_h100_spec_is_the_data_sheet():
    h = hardware.H100_SXM
    assert hardware.TARGET is h
    assert (h.hbm_bandwidth, h.peak_bf16_flops, h.peak_tf32_flops,
            h.peak_int8_ops, h.peak_f32_flops) == (3.35e12, 989e12, 495e12,
                                                   1979e12, 67e12)
    assert (h.hbm_bytes, h.sm_count, h.smem_bytes) == (80 * 1024**3, 132,
                                                       232_448)
    assert (h.nvlink_bandwidth, h.nvlink_links) == (450e9, 18)
    assert hardware.compute_time_s(989e12, 1) == 1.0
    assert hardware.memory_time_s(2 * 3.35e12, 2) == 1.0
    assert hardware.collective_time_s(4 * 450e9, 4) == 1.0


def _matrix_work(b, n, d, code_bytes, metric):
    """The bytes, f32 flops and products of one all-pairs call, as
    ``chip_smoke._matrix_bound`` counts them."""
    nbytes = 4 * b * d + code_bytes * n * d + 4 * b * n
    if code_bytes == 1:
        nbytes += 4 * n
    norms = 2 * (b + n) * d if metric == "l2" else 0
    return nbytes, norms, 2 * b * n * d


@pytest.mark.parametrize("kernel,code_bytes,metric,split,rate,want_ms", [
    ("distance_matrix_wgmma (3xTF32)", 4, "dot", 3,
     hardware.H100_SXM.peak_tf32_flops, 0.7809),
    ("quantized_distance_matrix_wgmma (3xBF16)", 1, "l2", 3,
     hardware.H100_SXM.peak_bf16_flops, 0.3928)])
def test_bound_s_gives_the_recorded_bounds(kernel, code_bytes, metric, split,
                                           rate, want_ms):
    shape = (1024, 65_536, 960)
    nbytes, norms, products = _matrix_work(*shape, code_bytes, metric)
    s, by = hardware.bound_s(nbytes, norms, split * products, rate)
    assert by == "operations"
    assert round(s * 1e3, 4) == want_ms, kernel
    # chip_smoke's bound is this one
    assert chip_smoke._matrix_bound(*shape, code_bytes, metric) == (s * 1e3,
                                                                    by)


def test_bound_s_bytes_side():
    h = hardware.H100_SXM
    s, by = hardware.bound_s(3.35e12, 1.0)
    assert (s, by) == (1.0, "bytes")
    s, by = hardware.bound_s(0.0, h.peak_f32_flops, h.peak_bf16_flops,
                             h.peak_bf16_flops)
    assert (s, by) == (2.0, "operations")
    assert math.isclose(hardware.bound_s(0.0, 0.0, 495e12)[0], 1.0)


def test_bench_presets_match_reference():
    assert navix_paper.BENCH_INDEX._asdict() == jpaper.BENCH_INDEX._asdict()
    assert navix_paper.BENCH_DATASETS == jpaper.BENCH_DATASETS
    assert navix_paper.PAPER_INDEX._asdict() == jpaper.PAPER_INDEX._asdict()


def test_reference_graph_type_is_mirrored():
    assert HnswGraph._fields == JHnswGraph._fields == FIELDS
