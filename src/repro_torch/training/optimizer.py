"""Optimizers, written out (port of ``repro.training.optimizer``).

AdamW for the small and medium archs; Adafactor (factored second moments,
Shazeer & Stern 2018) for the largest. Both are functional updates over a
tree of tensors, run under ``torch.no_grad()``: ``update(grads, state,
params)`` returns new parameters and a new state and changes neither
input. The state trees are the reference's (``{"m", "v", "count"}`` and
``{"per_param": {"vr", "vc"} | {"v"}, "count"}``, f32 moments and an int32
count), so they checkpoint under the reference's leaf keys.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.util import tree_flatten_with_path, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)
    name: str


def _flat(tree) -> tuple[list, Any]:
    paths, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in paths], treedef


def _map(fn, tree):
    leaves, treedef = _flat(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def _count(params) -> torch.Tensor:
    leaves, _ = _flat(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        zeros = _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"m": zeros, "v": _map(torch.clone, zeros),
                "count": _count(params)}

    def upd_one(g, m, v, p, cf):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** cf)
        vhat = v / (1 - b2 ** cf)
        step = lr * (mhat / (torch.sqrt(vhat) + eps)
                     + weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - step).to(p.dtype), m, v

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        cf = c.to(torch.float32)             # bias corrections in f32
        flat_p, treedef = _flat(params)
        outs = [upd_one(g, m, v, p, cf) for g, m, v, p in zip(
            _flat(grads)[0], _flat(state["m"])[0], _flat(state["v"])[0],
            flat_p)]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                {"m": tree_unflatten(treedef, [o[1] for o in outs]),
                 "v": tree_unflatten(treedef, [o[2] for o in outs]),
                 "count": c})

    return Optimizer(init=init, update=update, name="adamw")


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments: for a [..., r, c] parameter keep row and
    column statistics only, O(r + c) state instead of O(r * c)."""

    def _factored(p) -> bool:
        return p.ndim >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2

    def init(params):
        def per_param(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"per_param": _map(per_param, params),
                "count": _count(params)}

    def upd_one(g, st, p, beta):
        # each full-size temporary is let go as soon as it is used, so that
        # few f32 copies of a leaf are alive at once (the tied embedding
        # of gemma2-9b is 3.7 GB in f32)
        g = g.to(torch.float32)
        g2 = g * g + eps
        if _factored(p):
            vr = beta * st["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * st["vc"] + (1 - beta) * g2.mean(dim=-2)
            del g2
            denom = (vr[..., :, None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                   min=eps))
            u = g * torch.rsqrt(denom + eps)
            del denom
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            del g2
            u = g * torch.rsqrt(v + eps)
            new_st = {"v": v}
        del g
        # update clipping (RMS(u) <= clip_threshold)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return (p.to(torch.float32) - lr * u).to(p.dtype), new_st

    def upd(g, st, p, beta):
        # a stacked (per-layer) factored parameter is updated one leading
        # slice at a time, as the reference's lax.map does: its update
        # clipping takes the RMS of each slice. Each slice's result goes
        # straight into the new leaf (no list of slices to stack).
        if p.ndim >= 3 and p.shape[0] > 1 and _factored(p):
            new_p = torch.empty_like(p)
            new_st = {k: torch.empty_like(s) for k, s in st.items()}
            for i in range(p.shape[0]):
                sti = {k: s[i] for k, s in st.items()}
                new_p[i], sti = upd_one(g[i], sti, p[i], beta)
                for k, s in sti.items():
                    new_st[k][i] = s
            return new_p, new_st
        return upd_one(g, st, p, beta)

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        beta = 1.0 - c.to(torch.float32) ** (-decay)
        flat_p, treedef = _flat(params)
        # the per-parameter state dicts are the leaves' subtrees
        flat_s = _subtrees(state["per_param"], params)
        outs = [upd(g, s, p, beta)
                for g, s, p in zip(_flat(grads)[0], flat_s, flat_p)]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                {"per_param": tree_unflatten(treedef, [o[1] for o in outs]),
                 "count": c})

    return Optimizer(init=init, update=update, name="adafactor")


def _subtrees(tree, like, out: list | None = None) -> list:
    """The subtrees of ``tree`` that sit where ``like`` has leaves, in
    ``like``'s leaf order (``flatten_up_to``). A module-level recursion, so
    that no reference cycle holds the state until the garbage collector's
    next pass (``common.util``'s walkers say why)."""
    out = [] if out is None else out
    if isinstance(like, dict):
        for k in sorted(like):
            _subtrees(tree[k], like[k], out)
    elif isinstance(like, (list, tuple)):
        for a, b in zip(tree, like):
            _subtrees(a, b, out)
    else:
        out.append(tree)
    return out


def make_optimizer(name: str, lr: float | None = None) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr or 1e-3)
    if name == "adafactor":
        return adafactor(lr=lr or 1e-2)
    raise ValueError(f"unknown optimizer {name!r}")
