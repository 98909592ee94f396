"""The port's dry run (``launch/op_analysis.py``, ``roofline.py``,
``dryrun_lib.py``, ``dryrun.py``, ``report.py``) against the JAX
package's (``hlo_analysis``, ``roofline``, ``dryrun_lib``).

``model_flops`` equals the reference's for every cell. The op counter's
FLOPs equal what ``hlo_analysis`` finds in the compiled HLO of the
functions of ``tests/test_hlo_analysis.py``: a scan against a Python loop
over the same layers, a nested scan, an unrolled loop; and it counts the
recomputation of ``torch.utils.checkpoint``. On a ``DTensor`` it counts
the local shard's work, not the global op that ``DTensor``'s sharding
propagation also runs. A SMOKE dry run of the dense LMs on a 2x2 ``fake``
mesh is ``ok``, its FLOPs a chip's share of the 1x1 run's; the record has
the reference's keys; the CLI and the report run.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from repro.config.base import get_arch as jget_arch
from repro.launch import dryrun_lib as jdl
from repro.launch import hlo_analysis as ha
from repro_torch.common.hardware import TARGET
from repro_torch.launch import dryrun, dryrun_lib, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.op_analysis import COLLECTIVES, OpCounter

DENSE_LMS = ["gemma2-9b", "gemma-7b", "qwen1.5-0.5b"]
#: the SMOKE cells' sizes: 4 sequences of 64 tokens (a decode cache of 64)
SMALL = {"global_batch": 4, "seq_len": 64}


def _hlo_flops(fn, *shapes):
    args = [jnp.zeros(s) for s in shapes]
    return ha.analyze_text(jax.jit(fn).lower(*args).compile().as_text()).flops


def _counted(fn, *shapes):
    args = [torch.empty(s, device="meta") for s in shapes]
    with OpCounter() as oc:
        fn(*args)
    return oc.cost


@pytest.mark.parametrize("arch_id,shape_name", dryrun_lib.all_cells())
def test_model_flops_equal_the_reference(arch_id, shape_name):
    jarch = jget_arch(arch_id)
    arch = dryrun_lib.get_arch(arch_id)
    assert dryrun_lib.model_flops(arch.config, arch.shape(shape_name)) == \
        jdl.model_flops(jarch.config, jarch.shape(shape_name))


def test_all_cells_equal_the_reference():
    assert dryrun_lib.all_cells() == jdl.all_cells()


def test_loop_flops_equal_the_hlo_scan():
    def jbody(x, w):
        return jnp.tanh(x @ w), None

    def jscan(x, ws):
        return lax.scan(jbody, x, ws)[0]

    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    want = _hlo_flops(jscan, (64, 128), (6, 128, 128))
    assert want == 2 * 6 * 64 * 128 * 128
    assert _counted(loop, (64, 128), (6, 128, 128)).flops == want


def test_nested_loops_multiply():
    def jinner(x, w):
        return x @ w, None

    def jouter(x, ws):
        def step(x, _):
            return lax.scan(jinner, x, ws)[0], None
        return lax.scan(step, x, None, length=3)[0]

    def outer(x, ws):
        for _ in range(3):
            for i in range(ws.shape[0]):
                x = x @ ws[i]
        return x

    want = _hlo_flops(jouter, (32, 64), (4, 64, 64))
    assert want == 2 * 3 * 4 * 32 * 64 * 64
    assert _counted(outer, (32, 64), (4, 64, 64)).flops == want


def test_unrolled_equals_the_hlo_unrolled():
    def jbody(x, w):
        return jnp.tanh(x @ w)

    def junrolled(x, ws):
        for i in range(ws.shape[0]):
            x = jbody(x, ws[i])
        return x

    def unrolled(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    want = _hlo_flops(junrolled, (64, 128), (5, 128, 128))
    got = _counted(unrolled, (64, 128), (5, 128, 128))
    assert got.flops == want
    # bytes: each mm reads x and w and writes its product; tanh reads and
    # writes it; the selects of ws[i] are views
    layer = 4 * (64 * 128 + 128 * 128 + 64 * 128) + 4 * 2 * 64 * 128
    assert got.bytes_accessed == 5 * layer
    assert got.n_ops == 15                     # the 5 selects counted too


def test_checkpoint_recomputation_is_counted():
    from torch.utils.checkpoint import checkpoint

    w = torch.empty(128, 128, device="meta", requires_grad=True)
    x = torch.empty(64, 128, device="meta")

    def run(remat):
        with OpCounter() as oc:
            y = x
            for _ in range(3):
                f = lambda a: torch.tanh(a @ w)   # noqa: E731
                y = checkpoint(f, y, use_reentrant=False) if remat else f(y)
            torch.autograd.grad(y.sum(), w)
        return oc.cost

    mm = 2 * 64 * 128 * 128
    # forward 3, backward 3 for w and 2 for the inputs (x needs none)
    assert run(False).flops == 8 * mm
    assert run(True).flops == 11 * mm           # + the 3 recomputed
    assert run(True).peak_bytes > 0


def test_a_dtensor_op_counts_its_local_shard():
    """One [64, 128] x [128, 32] product with the rows sharded over a data
    axis of 2: a chip's count is its half, and the global op that
    DTensor's sharding propagation runs on fake tensors is not counted. A
    contraction sharded over model ends in an all-reduce, counted in
    bytes under the reference's name."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard)

    with fake_mesh((2, 2), ("data", "model")) as mesh:
        x = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        w = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        with OpCounter() as oc:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        assert tuple(y.to_local().shape) == (32, 32)
    assert oc.cost.flops == 2 * 32 * 64 * 32
    assert set(oc.cost.coll_breakdown) == set(COLLECTIVES)
    assert oc.cost.coll_breakdown["all-reduce"] == 32 * 32 * 4
    assert oc.cost.collective_bytes == 32 * 32 * 4


def test_roofline_terms_are_the_h100s():
    cost = _counted(lambda x, w: x @ w, (1024, 1024), (1024, 1024))
    cost.coll_breakdown["all-gather"] = 9e9
    cost.collective_bytes = 9e9
    r = rl.analyze("x", cost, chips=4, model_flops=4 * cost.flops)
    assert r.t_compute == cost.flops / TARGET.peak_bf16_flops
    assert r.t_memory == cost.bytes_accessed / TARGET.hbm_bandwidth
    assert r.t_collective == 9e9 / TARGET.nvlink_bandwidth
    assert r.bottleneck == "collective" and r.bound_time == r.t_collective
    assert r.useful_flops_fraction == 1.0
    d = r.to_dict()
    assert d["link"] == "nvlink" and d["link_bandwidth"] == 450e9
    assert d["chip"] == TARGET.name


@pytest.fixture(scope="module")
def smoke_records():
    """gemma2-9b SMOKE's train_4k cell on a 2x2 and a 1x1 fake mesh."""
    out = {}
    for shape, name in [((2, 2), "2x2"), ((1, 1), "1x1")]:
        with fake_mesh(shape, ("data", "model")) as mesh:
            out[name] = dryrun_lib.run_cell("gemma2-9b", "train_4k", mesh,
                                            name, SMALL, smoke=True)
    return out


def test_smoke_dry_run_is_ok_and_counts_a_chips_share(smoke_records):
    two, one = smoke_records["2x2"], smoke_records["1x1"]
    assert two["status"] == "ok", two.get("error")
    assert one["status"] == "ok", one.get("error")
    assert set(two) >= {"cell", "status", "memory_analysis", "roofline"}
    assert set(two["roofline"]) >= {
        "name", "chips", "flops_per_chip", "bytes_per_chip",
        "coll_bytes_per_chip", "coll_breakdown", "model_flops",
        "peak_memory_per_chip", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "useful_flops_fraction",
        "roofline_fraction"}
    r2, r1 = two["roofline"], one["roofline"]
    assert r2["chips"] == 4 and r1["chips"] == 1
    assert r1["coll_bytes_per_chip"] == 0 < r2["coll_bytes_per_chip"]
    # every product shards over the 4 chips but the replicated remainder
    # (the tied head's vocabulary is split over model only at 512 / 2)
    assert r1["flops_per_chip"] / 4 <= r2["flops_per_chip"] \
        < r1["flops_per_chip"] / 2
    assert r2["model_flops"] == r1["model_flops"] > 0
    assert "plain versions" in two["kernels"]


@pytest.mark.parametrize("arch_id,shape_name", [
    (a, s) for a in DENSE_LMS for s in ("train_4k", "prefill_32k",
                                        "decode_32k")
    if (a, s) != ("gemma2-9b", "train_4k")])    # the fixture's cell
def test_dense_lm_smoke_cells_run_on_a_fake_mesh(arch_id, shape_name):
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        rec = dryrun_lib.run_cell(arch_id, shape_name, mesh, "2x2", SMALL,
                                  smoke=True)
    assert rec["status"] == "ok", (rec.get("op"), rec.get("error"))


def test_chunked_attention_runs_on_a_fake_mesh():
    """From 2048 tokens the training forward takes ``chunked_mha``."""
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        rec = dryrun_lib.run_cell("gemma2-9b", "train_4k", mesh, "2x2",
                                  {"global_batch": 2, "seq_len": 2048},
                                  smoke=True)
    assert rec["status"] == "ok", (rec.get("op"), rec.get("error"))


def test_a_failure_names_its_operator():
    with fake_mesh((1, 1), ("data", "model")) as mesh:
        rec = dryrun_lib.run_cell("gemma2-9b", "train_4k", mesh, "1x1",
                                  {"global_batch": 0}, smoke=True)
    assert rec["status"] == "fail"
    assert rec["op"] and rec["error"] and rec["trace"]


def test_cli_and_report(tmp_path, capsys):
    args = ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh",
            "one", "--batch", "2", "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == [
        "qwen1.5-0.5b__decode_32k__one_chip_1x1__b2.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok" and rec["shape"]["global_batch"] == 2
    assert dryrun.main(args) == 0                      # cached
    assert "[cached]" in capsys.readouterr().out
    table = report.render(report.load(str(tmp_path)), "one_chip_1x1")
    assert "| qwen1.5-0.5b/decode_32k | ok |" in table
