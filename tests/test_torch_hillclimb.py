"""The port's hillclimb runner (``launch/hillclimb.py``) against the JAX
package's variants.

The reference's ``run_gnn`` and ``run_retrieval`` fail at their baselines
in this JAX (its ``with_sharding_constraint`` refuses the Explicit mesh),
so each of its two variants is lowered on its own, as ``hillclimb.py``
builds it, in a process of its own with 512 placeholder devices; the
port's CLI runs both baselines and both variants on its 16x16 ``fake``
mesh. The halo-partitioned train step moves the reference's all-to-all
bytes a chip exactly: 45 exchanges (15 blocks forward, 15 in remat's
recompute, 15 in the backward) of 256 x 16 x 128 f32. The int8-stored
retrieval step gathers the reference's 4,000,000 B of scores a chip. The
FLOPs, bytes and other collectives are printed beside the reference's.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import hillclimb

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TIMEOUT_S = 240
HALO_A2A = 45 * 256 * 16 * 128 * 4

#: the reference's two variants, each lowered and compiled on its own as
#: ``repro.launch.hillclimb`` builds it (its import sets 512 host
#: devices), their roofline figures printed as one JSON line
REFERENCE = r"""
import repro.launch.hillclimb  # noqa: F401 -- sets XLA_FLAGS first
import json
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from repro.config.base import get_arch
from repro.launch import roofline as rl
from repro.launch.dryrun_lib import model_flops
from repro.launch.mesh import make_production_mesh
from repro.models import api as mapi
from repro.models.gnn_partitioned import (partitioned_input_specs,
                                          partitioned_loss)
from repro.training.optimizer import make_optimizer

mesh = make_production_mesh(multi_pod=False)
out = {}
arch = get_arch("meshgraphnet")
shape = arch.shape("ogb_products")
cfg = mapi.resolve_config(arch.config, shape)
specs = partitioned_input_specs(cfg, shape, 256, halo_per_pair=16)
loss_fn = partitioned_loss(cfg, mesh)
opt = make_optimizer(cfg.optimizer)

def train_step(params, opt_state, batch):
    (loss, metrics), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params, batch)
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, metrics

params_spec = mapi.abstract_params(cfg)
opt_spec = jax.eval_shape(opt.init, params_spec)
rep = lambda t: jax.tree.map(
    lambda x: NamedSharding(mesh, P(*([None] * x.ndim))), t)
axes = tuple(mesh.axis_names)
b_sh = {k: NamedSharding(mesh, P(axes, *([None] * (len(v.shape) - 1))))
        for k, v in specs.items()}
fn = jax.jit(train_step, in_shardings=(rep(params_spec), rep(opt_spec), b_sh),
             donate_argnums=(0, 1))
r = rl.analyze("halo", fn.lower(params_spec, opt_spec, specs).compile(), 256,
               model_flops(arch.config, shape))
out["halo"] = r.to_dict()

wd = get_arch("wide-deep")
wshape = wd.shape("retrieval_cand")
d, n_cand, k = wd.config.embed_dim, wshape["n_candidates"], 100

def retrieve_q(codes, scale, q, cand_ids):
    x = codes.astype(jnp.bfloat16) * scale[:, None].astype(jnp.bfloat16)
    scores = jnp.einsum("bd,nd->bn", q.astype(jnp.bfloat16), x,
                        preferred_element_type=jnp.float32)
    vals, idx = jax.lax.top_k(scores, k)
    return vals, jnp.take(cand_ids, idx)

sds = jax.ShapeDtypeStruct
qspecs = (sds((n_cand, d), jnp.int8), sds((n_cand,), jnp.float32),
          sds((1, d), jnp.float32), sds((n_cand,), jnp.int32))
sh = (NamedSharding(mesh, P("model", None)), NamedSharding(mesh, P("model")),
      NamedSharding(mesh, P(None, None)), NamedSharding(mesh, P("model")))
fn = jax.jit(retrieve_q, in_shardings=sh)
out["int8"] = rl.analyze("int8", fn.lower(*qspecs).compile(), 256,
                         2.0 * n_cand * d).to_dict()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's halo and int8 variants' roofline dicts."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's CLI over both variants: (rc, its output, its records by
    name)."""
    path = tmp_path_factory.mktemp("hillclimb") / "records.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = hillclimb.main(["--which", "gnn,retrieval", "--out", str(path)])
    recs = {r["cell"]: r for r in json.loads(path.read_text())}
    return rc, buf.getvalue(), recs


HALO = "gnn/ogb_products HALO-PARTITIONED"
INT8 = "recsys/retrieval_cand INT8-STORED"
BASELINES = ("gnn/ogb_products BASELINE", "recsys/retrieval_cand BASELINE")


def _beside(what, mine: dict, ref: dict) -> None:
    print(f"{what}: port / reference a chip: FLOPs {mine['flops_per_chip']:.4e}"
          f" / {ref['flops_per_chip']:.4e}; bytes {mine['bytes_per_chip']:.4e}"
          f" / {ref['bytes_per_chip']:.4e}; collectives "
          f"{mine['coll_breakdown']} / {ref['coll_breakdown']}")


def test_halo_all_to_all_bytes_equal_the_reference(port, reference):
    rc, _, recs = port
    mine = recs[HALO]["roofline"]
    ref = reference["halo"]
    _beside("halo step", mine, ref)
    assert mine["coll_breakdown"]["all-to-all"] == \
        ref["coll_breakdown"]["all-to-all"] == HALO_A2A
    assert 0 < mine["useful_flops_fraction"] <= 1
    # 15 blocks forward, 15 in the recompute, 15 in the backward
    assert recs[HALO]["comm_counts"][
        "c10d_functional.all_to_all_single"] == 45


def test_halo_moves_fewer_bytes_than_the_baseline(port):
    _, _, recs = port
    halo = recs[HALO]["roofline"]["coll_bytes_per_chip"]
    base = recs[BASELINES[0]]["roofline"]["coll_bytes_per_chip"]
    assert 0 < halo < base


def test_retrieval_variant_gathers_the_references_scores(port, reference):
    _, _, recs = port
    assert recs[INT8]["status"] == "ok", recs[INT8].get("error")
    mine, ref = recs[INT8]["roofline"], reference["int8"]
    _beside("int8 retrieval", mine, ref)
    assert mine["coll_breakdown"]["all-gather"] == \
        ref["coll_breakdown"]["all-gather"] == 4_000_000
    assert mine["flops_per_chip"] == ref["flops_per_chip"]


def test_both_baselines_are_ok(port):
    _, _, recs = port
    for name in BASELINES:
        assert recs[name]["status"] == "ok", recs[name].get("error")


def test_cli_prints_four_lines(port):
    rc, out, recs = port
    assert rc == 0 and len(recs) == 4
    lines = [ln for ln in out.splitlines() if "tC=" in ln]
    assert [ln.split(" tC=")[0].strip() for ln in lines] == [
        BASELINES[0], HALO, BASELINES[1], INT8]
    for ln in lines:
        assert all(f" {k}=" in ln for k in ("tM", "tN", "useful", "mem",
                                            "coll/chip"))
