"""Typed configuration: shapes, the GNN and recsys model configs and the
arch registry (port of ``repro.config.base``).

Every architecture the port runs is a module in ``repro_torch.configs``
that builds an :class:`ArchDef` (full-size config, its shape set and a
reduced smoke config) and registers it under its id. The language-model
configs (``LMConfig``, ``MoEConfig``) belong to a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional

#: shape kinds determine which step function a cell drives:
#:   train / prefill / decode -> LM steps;  graph_* -> GNN steps;
#:   recsys_* -> recsys train / serve / retrieval steps
VALID_KINDS = (
    "train",
    "prefill",
    "decode",
    "graph_full",
    "graph_minibatch",
    "graph_batched",
    "recsys_train",
    "recsys_serve",
    "recsys_retrieval",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str
    params: Mapping[str, int] = dataclasses.field(default_factory=dict)
    #: set for shapes that are documented skips
    skip_reason: Optional[str] = None

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown shape kind {self.kind!r} "
                             f"(valid: {VALID_KINDS})")

    def __getitem__(self, key: str) -> int:
        return self.params[key]

    def get(self, key: str, default: int | None = None):
        return self.params.get(key, default)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch_id: str
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"             # segment_sum
    mlp_layers: int = 2
    in_node_dim: int = 16               # overridden per-shape (d_feat)
    in_edge_dim: int = 4
    out_dim: int = 3                    # meshgraphnet predicts accelerations
    layer_norm: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    optimizer: str = "adamw"

    family: str = "gnn"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    arch_id: str
    model: str                           # wide_deep | deepfm | dien | bst
    n_sparse: int
    embed_dim: int
    mlp_dims: tuple[int, ...]
    interaction: str                     # concat | fm | augru | transformer-seq
    field_vocabs: tuple[int, ...] = ()
    multi_hot_sizes: tuple[int, ...] = ()  # >1 => EmbeddingBag field
    n_dense: int = 13
    seq_len: int = 0                     # dien / bst behavior sequence
    gru_dim: int = 0                     # dien
    n_blocks: int = 0                    # bst
    n_heads: int = 0                     # bst
    item_vocab: int = 1_000_000          # behavior-sequence item table
    param_dtype: str = "float32"
    compute_dtype: str = "float32"       # CTR models are precision-sensitive
    remat: bool = False
    optimizer: str = "adamw"

    family: str = "recsys"

    def total_rows(self) -> int:
        return sum(self.field_vocabs) + (self.item_vocab if self.seq_len else 0)


AnyConfig = Any  # GNNConfig | RecsysConfig (LMConfig comes with its slice)


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    config: AnyConfig
    shapes: tuple[ShapeSpec, ...]
    smoke_config: AnyConfig
    description: str = ""
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; have "
                       f"{[s.name for s in self.shapes]}")


_REGISTRY: dict[str, ArchDef] = {}


def register_arch(arch: ArchDef) -> ArchDef:
    if arch.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {arch.arch_id}")
    _REGISTRY[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> ArchDef:
    # importing repro_torch.configs populates the registry
    import repro_torch.configs  # noqa: F401
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def config_to_json(cfg: AnyConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
