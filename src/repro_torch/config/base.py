"""Typed configuration: shapes, the LM, GNN and recsys model configs and
the arch registry (port of ``repro.config.base``).

Every architecture the port runs is a module in ``repro_torch.configs``
that builds an :class:`ArchDef` (full-size config, its shape set and a
reduced smoke config) and registers it under its id.
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
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"          # "swiglu" | "geglu"
    qkv_bias: bool = False               # qwen1.5
    attn_pattern: str = "global"         # "global" | "local_global" (gemma2)
    local_window: int = 4096             # sliding window for local layers
    attn_logit_softcap: float = 0.0      # gemma2 (50.0); 0 disables
    final_logit_softcap: float = 0.0     # gemma2 (30.0); 0 disables
    post_norms: bool = False             # gemma2 sandwich norms
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    norm_eps: float = 1e-6
    embedding_scale: bool = True         # gemma-style sqrt(d_model) scaling
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    optimizer: str = "adafactor"

    family: str = "lm"

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Analytic parameter count (embedding + per-layer + head)."""
        d, h, kv, hd, ff, v, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                  self.head_dim, self.d_ff, self.vocab_size,
                                  self.n_layers)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.moe is None:
            mlp = 3 * d * ff  # gated: up, gate, down
        else:
            e = self.moe
            mlp = ((e.n_experts + e.n_shared_experts) * 3 * d * e.d_ff_expert
                   + d * e.n_experts)
        norms = 2 * d
        emb = v * d if self.tie_embeddings else 2 * v * d
        return emb + L * (attn + mlp + norms) + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared
        experts)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        e = self.moe
        dense_like = dataclasses.replace(self, moe=None, d_ff=1)
        base = dense_like.n_params() - L * 3 * d  # strip placeholder mlp
        active_mlp = ((e.top_k + e.n_shared_experts) * 3 * d * e.d_ff_expert
                      + d * e.n_experts)
        return base + L * active_mlp


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


AnyConfig = Any  # LMConfig | GNNConfig | RecsysConfig


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
