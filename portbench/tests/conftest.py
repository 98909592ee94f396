"""A copy of the benchmark at a size the CPU runs in seconds.

``tiny_root`` copies ``BENCHMARK.json`` and ``portbench/`` into a
temporary checkout, adds the test cells below (a Wiki-schema
configuration with cos rows, its correlated cell and an int8-resident
cell, which exercise the general generator's other paths), and shrinks
every configuration and cell: fewer and narrower rows, a smaller index,
small batches and the plans on which the program's answers are whole at
that size (a tiny graph loses rows at the lowest selectivities that the
full-size index finds).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

#: a configuration of the Wiki schema (the paper's Figure 7a: Person,
#: Resource, Chunk; PersonChunk, ResourceChunk, WikiLink), cos rows
WIKI_CONFIG = {
    "name": "wiki768_cos", "n": 131072, "dim": 768, "metric": "cos",
    "precision": "float32", "schema": "wiki", "table": "Chunk",
    "clusters": 1000, "cluster_std": 0.35, "query_noise": 0.3,
    "near_noise": 0.15, "person_clusters": 100, "chunks_per_person": 6,
    "chunks_per_resource": 3, "links_per_person": 4, "birth_days": 36500,
    "index": {"m_u": 32, "ef_construction": 200, "sample_rate": 0.05,
              "morsel": 2048}}
_LIMITS = {"mask_rows": 0, "bad_answers": 0, "empty_share": 0.01,
           "dist_gap": 1e-05, "recall": 0.9, "plan_recall": 0.5}
#: test traffic beside the committed cells: (configuration, traffic)
TEST_CELLS = {
    "wiki768.f32.correlated": ("wiki768_cos", {
        "residency": "f32", "batch": 1024, "k": 100, "efs": 200,
        "heuristic": "adaptive_local", "pool": 4, "limits": _LIMITS,
        "plans": [
            {"select": "person_chunk", "sigma": 0.5, "queries": "person"},
            {"select": "person_chunk", "sigma": 0.1, "queries": "person"},
            {"select": "person_chunk", "sigma": 0.1,
             "queries": "nonperson"},
            {"select": "person_chunk", "sigma": 0.01,
             "queries": "nonperson"},
            {"select": "two_hop", "sigma": 0.1, "queries": "person"},
            {"select": "id_range", "sigma": 0.1,
             "queries": "uncorrelated"}]}),
    "gist960.int8.sweep": ("gist960_l2", {
        "residency": "int8", "batch": 1024, "k": 100, "efs": 200,
        "heuristic": "adaptive_local", "pool": 4, "limits": _LIMITS,
        "plans": [{"select": "id_range", "sigma": s,
                   "queries": "uncorrelated"}
                  for s in (0.9, 0.5, 0.1, 0.03, 0.01)]}),
}

TINY_CONFIG = dict(n=2000, dim=24, clusters=16)
TINY_INDEX = dict(m_u=12, ef_construction=64, morsel=512)
#: 12 lanes: a batch that is no power of two, as the committed cell's
TINY_CELL = dict(batch=12, k=8, efs=32, pool=2)
TINY_PLANS = {
    "rows": [{"select": "id_range", "sigma": s, "queries": "uncorrelated"}
             for s in (0.9, 0.5, 0.1)],
    "wiki": [{"select": "person_chunk", "sigma": 0.5, "queries": "person"},
             {"select": "person_chunk", "sigma": 0.1, "queries": "person"},
             {"select": "id_range", "sigma": 0.1,
              "queries": "uncorrelated"}],
}


def _edit(path: pathlib.Path, **changes) -> dict:
    d = json.loads(path.read_text())
    d.update(changes)
    path.write_text(json.dumps(d))
    return d


def make_tiny(root: pathlib.Path) -> pathlib.Path:
    """The copy, with the test cells added as files and every per-layer
    metric applying to every cell."""
    pkg = root / "portbench"
    shutil.copytree(REPO / "portbench", pkg,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    (pkg / "configs" / "wiki768_cos.json").write_text(json.dumps(WIKI_CONFIG))
    doc["configs"].append({"name": "wiki768_cos", "source": "test",
                           "why": "test",
                           "file": "portbench/configs/wiki768_cos.json",
                           "reduced": ["n"]})
    for name, (config, traffic) in TEST_CELLS.items():
        (pkg / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        doc["workloads"].append({"name": name, "chips": 1, "config": config,
                                 "traffic": name, "why": "test"})
    for m in doc["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    schema = {}
    for c in doc["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CONFIG, index={**cfg["index"], **TINY_INDEX})
        if cfg["schema"] == "wiki":
            cfg.update(person_clusters=4, birth_days=365)
        path.write_text(json.dumps(cfg))
        schema[c["name"]] = cfg["schema"]
    for w in doc["workloads"]:
        _edit(root / "portbench" / "workloads" / f"{w['name']}.json",
              plans=TINY_PLANS[schema[w["config"]]], **TINY_CELL)
    return root


@pytest.fixture
def tiny_root(tmp_path) -> pathlib.Path:
    return make_tiny(tmp_path)
