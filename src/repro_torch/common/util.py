"""Small shared utilities: timing, rounding, generator fan-out, tree sizing
(port of ``repro.common.util``).

A *tree* here is what the port nests its state in: dicts, lists, tuples
and NamedTuples (``HnswGraph``, ``QuantizedStore``, ``SearchStats``), with
tensors or arrays at the leaves. ``None`` is an empty subtree, as in
``jax.tree_util``. :func:`tree_flatten_with_path` is the port's one tree
walker; the checkpoint store and the ``tree_*`` helpers below use it. Its
key paths and leaf order are the reference's: dict keys sorted, a
NamedTuple field keyed ``"." + name`` (the ``str`` of jax's
``GetAttrKey``), a sequence index by its number, so
:func:`leaf_key` joins them into the names the reference's checkpoints
carry (``.lower``, ``.vectors..codes``, ``g.1.0``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Iterator

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 2 ** math.ceil(math.log2(x))


@contextlib.contextmanager
def timer(sink: dict, key: str) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    sink[key] = sink.get(key, 0.0) + (time.perf_counter() - t0)


# -- the tree walker ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a tree with its leaves taken out: ``kind`` is
    ``"leaf"``, ``"none"``, ``"dict"`` (``meta``: the sorted keys),
    ``"namedtuple"`` (``meta``: the class), ``"list"`` or ``"tuple"``."""
    kind: str
    meta: Any = None
    children: tuple = ()


_LEAF = TreeDef("leaf")
_NONE = TreeDef("none")
_END = object()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


# The walkers are module-level functions given their accumulator: a nested
# function that calls itself is a reference cycle, which would hold every
# leaf it saw (a model's parameters, its optimizer state) until the
# garbage collector's next pass.


def _walk(node, path: tuple[str, ...], leaves: list) -> TreeDef:
    if node is None:
        return _NONE
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys, tuple(
            _walk(node[k], (*path, str(k)), leaves) for k in keys))
    if _is_namedtuple(node):
        return TreeDef("namedtuple", type(node), tuple(
            _walk(getattr(node, f), (*path, f".{f}"), leaves)
            for f in node._fields))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, None, tuple(
            _walk(v, (*path, str(i)), leaves) for i, v in enumerate(node)))
    leaves.append((path, node))
    return _LEAF


def tree_flatten_with_path(tree: Any
                           ) -> tuple[list[tuple[tuple[str, ...], Any]],
                                      TreeDef]:
    """``([(path, leaf), ...], treedef)``: every leaf with its key path (a
    tuple of strings), in the reference's order, and the structure that
    :func:`tree_unflatten` rebuilds from the leaves."""
    leaves: list[tuple[tuple[str, ...], Any]] = []
    treedef = _walk(tree, (), leaves)
    return leaves, treedef


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` (in flatten order) put
    back; raises if their number differs from the tree's."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree has") from None
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.meta, kids))
    if td.kind == "namedtuple":
        return td.meta(*kids)
    return kids if td.kind == "list" else tuple(kids)


def leaf_key(path: tuple[str, ...]) -> str:
    """A leaf's name in a checkpoint: its key path joined with ``"."``
    (``repro.checkpoint.store._leaf_key``'s form)."""
    return ".".join(path)


# -- tree sizing ----------------------------------------------------------------


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_bytes(tree: Any) -> int:
    """Total bytes of all arrays in a tree (tensors on any device, meta
    tensors included, or numpy arrays)."""
    return sum(math.prod(leaf.shape) * _itemsize(leaf.dtype)
               for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape") and hasattr(leaf, "dtype"))


def tree_params(tree: Any) -> int:
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape"))


def split_key(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``gen``'s device, each seeded from ``gen`` (the
    counterpart of ``jax.random.split``: ``gen`` advances, the children
    are independent of each other and of its later draws)."""
    seeds = torch.randint(0, 2 ** 63 - 1, (n,), generator=gen,
                          dtype=torch.int64, device=gen.device)
    return [torch.Generator(device=gen.device).manual_seed(int(s))
            for s in seeds.tolist()]


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.3g}{unit}"
        n /= 1000.0
    return f"{n:.3g}Q"


def assert_no_nans(tree: Any, where: str = "") -> None:
    """Raise ``AssertionError`` naming the first floating leaf that holds
    a non-finite value (one device read a floating leaf)."""
    for path, leaf in tree_flatten_with_path(tree)[0]:
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(
                f"non-finite values at {where}{leaf_key(path)}")
