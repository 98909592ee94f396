"""The recsys-family shape set, shared by the four recsys archs (port of
``repro.configs.recsys_shapes``)."""

from repro_torch.config.base import ShapeSpec

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", {"batch": 65536}),
    ShapeSpec("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)

#: per-field vocabulary sizes: a realistic skewed mixture (a few huge id
#: spaces, many small categorical fields), Criteo-style. Total ~= 89M rows
#: for 40 fields -- the embedding store is the dominant parameter payload
#: and is row-sharded over the mesh in production. All sizes are multiples
#: of 16 so the model-axis row sharding divides them exactly.
_VOCAB_CYCLE = (10_000_000, 1_000_000, 100_000, 10_000, 1_024)


def field_vocabs(n_fields: int) -> tuple[int, ...]:
    return tuple(_VOCAB_CYCLE[i % len(_VOCAB_CYCLE)] for i in range(n_fields))


def multi_hot_sizes(n_fields: int, every: int = 5, hot: int = 10) -> tuple[int, ...]:
    """Every ``every``-th field is a multi-hot bag (EmbeddingBag path)."""
    return tuple(hot if i % every == every - 1 else 1 for i in range(n_fields))


def smoke_vocabs(n_fields: int) -> tuple[int, ...]:
    return tuple(100 + 13 * (i % 7) for i in range(n_fields))
