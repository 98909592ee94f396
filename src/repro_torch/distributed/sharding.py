"""Per-architecture sharding policies for the production mesh (port of
``repro.distributed.sharding``).

Mesh axes: ("pod", "data", "model") multi-pod / ("data", "model") single
pod. Policies:

  LM train    FSDP over (pod x data) on the d_model dim of every weight,
              TP over model on heads / d_ff / vocab, EP over model for MoE
              experts; batch over (pod x data); vocab-parallel logits.
  LM decode   batch over (pod x data); KV cache sharded by kv-head over
              model when divisible (kv=16 archs) else by sequence;
              long_500k (batch=1) shards the sequence over every axis.
  GNN         node tensors sharded over (pod x data); edge tensors over all
              axes (edge-parallel message passing); params replicated.
  RecSys      embedding tables row-sharded over model; batch over
              (pod x data); retrieval candidates sharded over model.

A spec is a :class:`Spec`: for each dim of a tensor, None, an axis name or
a tuple of names, laid out as JAX's ``PartitionSpec`` lays it out (a
one-name tuple is the name), so the two compare element for element.
:func:`to_placements` turns one into the ``Shard`` / ``Replicate`` list
of a ``DTensor`` on a torch ``DeviceMesh``. Only parameters, optimizer
state and step inputs get specs; activations follow the model's hints
(``autoshard.constrain``). The rules read only the mesh's axis names and
sizes (:func:`repro_torch.distributed.autoshard.mesh_axes`), so a
shape-only mesh serves them.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.common.util import (_is_namedtuple, tree_flatten_with_path,
                                     tree_unflatten)
from repro_torch.config.base import (GNNConfig, LMConfig, RecsysConfig,
                                     ShapeSpec)
from repro_torch.distributed.autoshard import mesh_axes, mesh_groups


class Spec(tuple):
    """A partition spec: one entry per leading tensor dim, each None, an
    axis name or a tuple of axis names (major first). A tuple of one name
    is stored as the name, as ``PartitionSpec`` stores it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _group(axes) -> tuple[str, ...]:
    return axes if isinstance(axes, tuple) else (axes,)


def sanitize(spec: Spec, shape: tuple, mesh) -> Spec:
    """Drop sharding from dims the mesh axes don't divide (granite's 49,155
    vocab stays replicated; padding a non-divisible payload is the data
    layer's job)."""
    sizes = mesh_axes(mesh)
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in _group(axes))
        out.append(axes if dim % size == 0 else None)
    return Spec(*out)


def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names the axes on it, else
    ``Replicate()``. A dim sharded over ("pod", "data") is ``Shard(d)`` on
    both axes' mesh dims, the outer first (or on the one dim that merges
    them), so its blocks are laid out as JAX lays them. A mesh dim of
    size 1 shards nothing and is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    sizes, groups = mesh_axes(mesh), mesh_groups(mesh)
    out: list = [Replicate()] * len(groups)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        want, dims, i = _group(axes), [], 0
        for p, g in enumerate(groups):
            if want[i:i + len(g)] == g:
                dims.append(p)
                i += len(g)
        if i != len(want):
            raise ValueError(f"{spec}: axes {want} do not lie on whole mesh "
                             f"dims in the mesh's order {groups}")
        for p in dims:
            if out[p] != Replicate():
                raise ValueError(f"{spec}: mesh dim {groups[p]} shards two "
                                 f"dims")
            if math.prod(sizes[a] for a in groups[p]) > 1:
                out[p] = Shard(d)
    return tuple(out)


def spec_leaves(tree: Any, out: list | None = None) -> list:
    """The :class:`Spec` leaves of a tree of specs, in the order of
    ``tree_flatten_with_path`` over the tree it mirrors (dict keys sorted)."""
    out = [] if out is None else out
    if isinstance(tree, Spec):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            spec_leaves(tree[k], out)
    elif _is_namedtuple(tree):
        for f in tree._fields:
            spec_leaves(getattr(tree, f), out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            spec_leaves(v, out)
    else:
        raise TypeError(f"not a spec tree: {type(tree).__name__}")
    return out


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def lm_param_spec(path: str, shape: tuple, dp, model_size: int = 16) -> Spec:
    if "embed" in path:                       # [V, D]
        return Spec("model", dp)
    if "lm_head" in path:                     # [D, V]
        return Spec(dp, "model")
    if "router" in path:                      # [L, D, E]
        return Spec(None, dp, None)
    if "shared" in path or ("mlp" in path and len(shape) == 3):
        if path.endswith("wi"):               # [L, D, 2F]
            return Spec(None, dp, "model")
        if path.endswith("wo"):               # [L, F, D]
            return Spec(None, "model", dp)
    if "mlp" in path and len(shape) == 4:     # MoE experts
        if shape[1] % model_size:             # E doesn't divide the model
            # axis (granite: 40/16): shard the matmul dims over both axes
            # instead -- replicated experts would cost params+grads x16
            if path.endswith("wi"):           # [L, E, D, 2Fe]
                return Spec(None, None, dp, "model")
            if path.endswith("wo"):           # [L, E, Fe, D]
                return Spec(None, None, "model", dp)
        if path.endswith("wi"):               # [L, E, D, 2Fe]
            return Spec(None, "model", dp, None)
        if path.endswith("wo"):               # [L, E, Fe, D]
            return Spec(None, "model", None, dp)
    if "attn" in path and len(shape) == 3:
        if path.endswith("wo"):               # [L, H*hd, D]
            return Spec(None, "model", dp)
        return Spec(None, dp, "model")        # wq/wk/wv [L, D, X]
    if "attn" in path and len(shape) == 2 and not path.endswith("scale"):
        return Spec(None, "model")            # biases [L, X]
    return Spec(*([None] * len(shape)))       # norms etc: replicated


def recsys_param_spec(path: str, shape: tuple, dp) -> Spec:
    # row-shard every big [V, D] embedding table over model; the dense
    # towers/GRU/transformer params are small and replicate
    if len(shape) == 2 and shape[0] >= 4096:
        return Spec("model", None)
    return Spec(*([None] * len(shape)))


def param_specs(cfg, params_spec: Any, mesh) -> Any:
    """The spec of every leaf of ``params_spec`` (a parameter tree of
    tensors, ``meta`` ones serve), as a tree of the same structure."""
    dp = dp_axes(mesh)
    model_size = mesh_axes(mesh)["model"]
    paths, treedef = tree_flatten_with_path(params_spec)
    out = []
    for path, leaf in paths:
        p = "/".join(path)
        shape = tuple(leaf.shape)
        if isinstance(cfg, LMConfig):
            spec = lm_param_spec(p, shape, dp, model_size)
        elif isinstance(cfg, RecsysConfig):
            spec = recsys_param_spec(p, shape, dp)
        else:
            spec = Spec(*([None] * len(shape)))   # GNN: replicate
        out.append(sanitize(spec, shape, mesh))
    return tree_unflatten(treedef, out)


def _mirror(opt_tree, param_tree):
    """The reference's structural recursion: a subtree of the optimizer
    state against the parameter specs it follows."""
    if isinstance(opt_tree, dict):
        if set(opt_tree) == {"vr", "vc"}:
            ps = param_tree
            return {"vr": Spec(*ps[:-1]), "vc": Spec(*(ps[:-2] + ps[-1:]))}
        if set(opt_tree) == {"v"} and isinstance(param_tree, Spec):
            return {"v": param_tree}
        return {k: _mirror(v, param_tree[k] if isinstance(param_tree, dict)
                           and k in param_tree else param_tree)
                for k, v in opt_tree.items()}
    if isinstance(opt_tree, (tuple, list)):
        t = type(opt_tree)
        if (isinstance(param_tree, (tuple, list))
                and not isinstance(param_tree, Spec)):
            return t(_mirror(o, q) for o, q in zip(opt_tree, param_tree))
        return t(_mirror(o, param_tree) for o in opt_tree)
    if isinstance(param_tree, Spec):
        if hasattr(opt_tree, "shape") and len(opt_tree.shape) == 0:
            return Spec()
        return param_tree
    return Spec()


def opt_specs(param_spec_tree: Any, opt_state_spec: Any) -> Any:
    """Optimizer-state specs derived from param specs.

    AdamW m/v mirror the param; Adafactor vr drops the last dim's axis and
    vc drops the second-to-last (factored stats follow their dims); the
    step count is replicated."""
    out = {}
    for k, v in opt_state_spec.items():
        if k == "count":
            out[k] = Spec()
        elif k in ("m", "v", "per_param"):
            out[k] = _mirror(v, param_spec_tree)
        else:
            paths, treedef = tree_flatten_with_path(v)
            out[k] = tree_unflatten(treedef, [Spec()] * len(paths))
    return out


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def _sanitize_tree(raw, specs, mesh):
    if isinstance(raw, Spec):
        return sanitize(raw, specs[0], mesh)
    if isinstance(raw, dict):
        return {k: _sanitize_tree(raw[k], specs[k], mesh) for k in raw}
    if _is_namedtuple(raw):
        return type(raw)(*(_sanitize_tree(getattr(raw, f), getattr(specs, f),
                                          mesh) for f in raw._fields))
    raise TypeError(f"not a spec tree: {type(raw).__name__}")


def batch_specs(cfg, shape: ShapeSpec, specs: dict, mesh) -> dict:
    """The specs of a step's inputs: ``specs`` is ``input_specs``'s tree
    of ``(shape, dtype)`` pairs (a decode step's ``cache`` a ``KVCache``
    of them: the in-place ``k`` / ``v`` and the on-device ``length``)."""
    return _sanitize_tree(_batch_specs_raw(cfg, shape, specs, mesh), specs,
                          mesh)


def _batch_specs_raw(cfg, shape: ShapeSpec, specs: dict, mesh) -> dict:
    dp = dp_axes(mesh)
    model_size = mesh_axes(mesh)["model"]

    if isinstance(cfg, LMConfig):
        if shape.kind in ("train", "prefill"):
            return {"tokens": Spec(dp, None)}
        # decode: cache [L, B, S, KV, hd] + token [B]
        b = shape["global_batch"]
        if b == 1:
            cache_kv = Spec(None, None, dp + ("model",), None, None)
            token = Spec(None)
        elif cfg.n_kv_heads % model_size == 0:
            cache_kv = Spec(None, dp, None, "model", None)
            token = Spec(dp)
        else:
            cache_kv = Spec(None, dp, "model", None, None)
            token = Spec(dp)
        from repro_torch.models.transformer import KVCache
        return {"cache": KVCache(k=cache_kv, v=cache_kv, length=Spec()),
                "token": token}

    if isinstance(cfg, GNNConfig):
        all_axes = dp + ("model",)
        out = {}
        for name, (s, _) in specs.items():
            if name.startswith("edge"):
                out[name] = Spec(all_axes, *([None] * (len(s) - 1)))
            else:
                out[name] = Spec(dp, *([None] * (len(s) - 1)))
        return out

    if isinstance(cfg, RecsysConfig):
        out = {}
        for name, (s, _) in specs.items():
            if name == "candidates":
                out[name] = Spec("model")
            else:
                out[name] = Spec(dp, *([None] * (len(s) - 1)))
        return out

    raise TypeError(type(cfg))
