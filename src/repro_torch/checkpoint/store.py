"""Checkpoints of the port's trees and indexes (port of
``repro.checkpoint.store``), in the reference's on-disk format.

Layout: one directory per step, written as ``step_%08d.tmp`` and renamed
to ``step_%08d/`` once complete. It holds one ``.npy`` per leaf, named by
the leaf's key (``repro_torch.common.util.leaf_key``: ``.lower``,
``.vectors..codes``, ``g.1.0``) with ``/`` made ``_``; a ``manifest.json``
with the step, its creation time, the caller's ``extra`` and each leaf's
file, shape, dtype and SHA1 of its bytes; and ``COMMIT``, written last, so
a step cut short (a preempted write) never counts as complete and
:func:`latest_complete` skips it. A bf16 leaf is stored as a ``uint16``
view with ``"bfloat16"`` as its manifest dtype, so its SHA1 is the one the
reference computes over the same bytes. Either package reads the other's
checkpoints: the reference's ``load`` takes a port-written graph with the
JAX graph as ``like``, and :func:`load` here a reference-written one.

The reference restores onto a mesh through ``shardings``; here ``device``
takes its place. A sharded index (``ShardedNavix``) is saved as the list of
its shard graphs, with its grid shape, ``n_local``, ``n_total`` and config
in ``extra``, and rebuilt around the loaded list.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.util import (leaf_key, tree_flatten_with_path,
                                     tree_unflatten)

def _host(leaf) -> tuple[np.ndarray, str]:
    """(the numpy array written for ``leaf``, its logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store a uint16 view, record the
            # logical dtype in the manifest
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | pathlib.Path, step: int, tree: Any,
         extra: Optional[dict] = None) -> pathlib.Path:
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step,
                "created": time.time(),  # navilint: wallclock-ok manifest timestamp, not duration math
                "extra": extra or {},
                "leaves": {}}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        key = leaf_key(path)
        arr, logical_dtype = _host(leaf)
        fname = key.replace("/", "_") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": logical_dtype,
            "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (tmp / "COMMIT").write_text("ok")          # written last: atomicity mark
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    return d


def latest_complete(ckpt_dir: str | pathlib.Path) -> Optional[pathlib.Path]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(p for p in d.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and (p / "COMMIT").exists())
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """The host tensor of a stored leaf: bf16, and uint32 words (which the
    port holds as int32, as its semimasks), by a bit view, never by a
    value cast."""
    if logical_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def load(step_dir: str | pathlib.Path, like: Any,
         device: str | torch.device | None = None,
         verify: bool = True) -> Any:
    """Restore a tree onto ``device`` (CUDA by default: see
    ``resolve_device``, which raises on a host without CUDA). ``like``
    gives the tree's structure, and its leaves only their shape and dtype,
    so meta tensors (``torch.empty(shape, dtype=..., device="meta")``)
    serve, as ``jax.eval_shape`` does for the reference. Raises
    ``IOError`` on a checksum mismatch (``verify``) and ``ValueError`` on
    a shape or dtype that differs from ``like``'s."""
    dev = resolve_device(device)
    step_dir = pathlib.Path(step_dir)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    paths, treedef = tree_flatten_with_path(like)
    out = []
    for path, leaf in paths:
        key = leaf_key(path)
        meta = manifest["leaves"][key]
        arr = np.load(step_dir / meta["file"])
        if verify:
            got = hashlib.sha1(arr.tobytes()).hexdigest()
            if got != meta["sha1"]:
                raise IOError(f"checksum mismatch for {key}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        t = _tensor(arr, meta["dtype"])
        if t.dtype != leaf.dtype:
            raise ValueError(f"{key}: checkpoint dtype {meta['dtype']} != "
                             f"expected {leaf.dtype}")
        out.append(t.to(dev))
    return tree_unflatten(treedef, out)


def load_manifest(step_dir: str | pathlib.Path) -> dict:
    return json.loads((pathlib.Path(step_dir) / "manifest.json").read_text())
