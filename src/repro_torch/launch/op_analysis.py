"""Per-chip cost of a step, counted from the aten ops it runs: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference compiles a step and parses the optimized HLO; the port has
no compiled artifact, so it runs the step once (on ``meta`` tensors,
``DTensor``s on a mesh for a sharded cell) under :class:`OpCounter`, a
dispatch mode that sees every aten op on this chip's local shards:

  * flops  = the ``torch.utils.flop_counter`` formula of every mm, bmm,
             addmm, baddbmm and convolution (the reference's dot and
             convolution instructions);
  * bytes  = the input and output bytes of every op that materialises a
             result (views and allocations excluded): the reference's
             HBM-traffic model, in which fused internals never reach HBM,
             is here one of unfused ops, each reading and writing HBM;
  * collective bytes for each kind, the result bytes of every functional
    collective (``_c10d_functional``), under the reference's five names;
  * peak bytes: the most bytes of live local storage at any point, the
    tensors registered with :meth:`OpCounter.track` (parameters,
    optimizer state, inputs) included. A storage is live until its last
    user (a saved activation too) lets it go.

Only local work counts. A ``DTensor`` op is handed back to ``DTensor``
(the mode returns ``NotImplemented``), whose sharding propagation then
runs the op once more at the global shape on fake tensors (not counted)
and the op itself on the local shards (counted); so a figure is this
chip's, as the reference's post-SPMD HLO shapes are per partition. A
Python loop over layers and the recomputation of ``torch.utils.checkpoint``
run their ops as often as they run, which is the counterpart of the
reference's while-loop trip counts.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional collectives (``_c10d_functional`` op names) by the
#: reference's kind names
_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "permute_tensor": "collective-permute"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")

#: ops that move no tensor data of their own: allocations without a fill,
#: host reads of metadata, the functional collectives' waits and wrappers
_NON_MATERIAL = {"empty", "empty_strided", "empty_like", "new_empty",
                 "new_empty_strided", "detach", "alias", "lift_fresh",
                 "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
                 "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    coll_breakdown: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    peak_bytes: float = 0.0        # the most live local storage bytes
    arg_bytes: float = 0.0         # bytes of the tracked tensors
    n_ops: int = 0                 # local aten ops counted

    def to_dict(self):
        return dataclasses.asdict(self)


class OpCounter(TorchDispatchMode):
    """Counts the local aten ops run inside it into :attr:`cost`.
    :attr:`last_op` names the op dispatched last and :attr:`failed_op`
    the innermost local op that raised (a dry run's finding)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.last_op: str | None = None
        self.failed_op: str | None = None
        self._live: dict[int, int] = {}       # storage id -> bytes
        self._bytes = 0

    # -- memory ------------------------------------------------------------

    def _free(self, key: int) -> None:
        self._bytes -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._bytes += st.nbytes()
        weakref.finalize(st, self._free, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._bytes)

    def track(self, tree) -> None:
        """Count the tensors of ``tree`` (for a DTensor, its local shard)
        as live from now on, as the step's arguments."""
        from torch.distributed.tensor import DTensor

        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                before = self._bytes
                self._hold(t)
                self.cost.arg_bytes += self._bytes - before

    # -- the dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        self.last_op = str(func)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on the shards
        try:
            out = func(*args, **kwargs)
        except Exception:
            if self.failed_op is None:
                self.failed_op = str(func)
            raise
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                      # DTensor's shape propagation
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        from torch.utils.flop_counter import flop_registry

        c = self.cost
        c.n_ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                b = sum(_nbytes(t) for t in outs)
                c.collective_bytes += b
                c.coll_breakdown[kind] += b
        if func.is_view or name in _NON_MATERIAL:
            return
        c.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
