"""Query-plan operators (port of ``repro.query.operators``).

Selection subqueries + first-class kNN rows.

The paper evaluates predicate-agnostic queries by running an arbitrary
selection subquery Q_S first (filters, joins) and passing the resulting
selected set S to the kNN operator as a node semimask via sideways
information passing. This module holds the whole plan algebra: the Q_S
evaluator (a small typed operator tree over the columnar GraphStore
producing a boolean mask over one node table) plus the row-producing
operators the unified NavixDB pipeline executes on top of it.

Selection (mask) operators mirror the paper's workloads:
  NodeScan          MATCH (c:Chunk)                    -> all true
  Filter            WHERE c.cid < X / range / eq / isin
  HopJoin           MATCH (p)-[:R]->(c) WHERE mask(p)  -> semi-join (1 hop)
  (chain HopJoin twice for the 2-hop graph-RAG workload of Section 5.7.1)
  And / Or / Not    boolean combinators

Row operators (executed by ``repro_torch.api.db.NavixDB``, not by
``evaluate``):
  KnnSearch         QUERY_HNSW_INDEX: child = Q_S, produces scored rows
  Project           keep named property columns of the result rows
  Limit             truncate to the first n rows

All nodes are frozen dataclasses: plans are hashable values, which is what
lets the serving engine group requests by plan and the program cache key
its entries by plan shape. The query *vector* is deliberately not part
of ``KnnSearch`` -- it is bound at execution time, so one plan shape serves
any number of queries (and batches) through one program-cache entry.

``evaluate`` runs on the host (numpy) -- this is the prefiltering phase
whose cost Table 7 accounts separately -- and the resulting mask is packed
to a device bitset for the search operator. Masks, and their words through
``repro_torch.core.bitset.pack_np``, equal the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np

from repro_torch.storage.columnar import GraphStore

SelectionPlan = Union["NodeScan", "Filter", "HopJoin", "And", "Or", "Not"]
Plan = Union[SelectionPlan, "KnnSearch", "Project", "Limit"]


@dataclasses.dataclass(frozen=True)
class NodeScan:
    table: str


@dataclasses.dataclass(frozen=True)
class Filter:
    child: Plan
    column: str
    op: str                    # "<", "<=", ">", ">=", "==", "range", "isin"
    value: object = None
    lo: object = None
    hi: object = None


@dataclasses.dataclass(frozen=True)
class HopJoin:
    """Semi-join: select dst-table nodes reachable from selected src nodes
    via rel (direction 'fwd': src->dst edges; 'bwd' follows edges backwards)."""
    child: Plan                # plan over the rel's source side
    rel: str
    direction: str = "fwd"


@dataclasses.dataclass(frozen=True)
class And:
    left: Plan
    right: Plan


@dataclasses.dataclass(frozen=True)
class Or:
    left: Plan
    right: Plan


@dataclasses.dataclass(frozen=True)
class Not:
    child: Plan


@dataclasses.dataclass(frozen=True)
class KnnSearch:
    """The paper's QUERY_HNSW_INDEX as a plan operator.

    ``child`` is the selection subquery Q_S (None = unfiltered search);
    ``index`` names a catalog entry (None = resolve by the child's output
    table); ``table`` is only needed when ``child`` is None. The query
    vector is bound at execution time (see module docstring).
    """
    child: Optional[Plan] = None
    k: int = 10
    index: Optional[str] = None
    table: Optional[str] = None
    efs: int = 0                   # 0 -> 2*k at execution
    heuristic: str = "adaptive_local"


@dataclasses.dataclass(frozen=True)
class Project:
    child: Plan
    columns: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Limit:
    child: Plan
    n: int


@dataclasses.dataclass(frozen=True)
class PipelineParts:
    """A root plan split into its three execution stages (top-down)."""
    selection: Optional[Plan]      # Q_S subtree (mask-producing), or None
    knn: Optional[KnnSearch]       # the kNN operator, or None (pure Q_S)
    projections: tuple[str, ...]   # union of Project columns above the knn
    limit: Optional[int]           # smallest Limit above the knn, or None


def split_pipeline(plan: Plan) -> PipelineParts:
    """Walk Project/Limit wrappers down to the KnnSearch (if any) and its
    selection subtree. Row operators below a KnnSearch are rejected."""
    projections: tuple[str, ...] = ()
    limit: Optional[int] = None
    node = plan
    while isinstance(node, (Project, Limit)):
        if isinstance(node, Project):
            projections = tuple(c for c in node.columns
                                if c not in projections) + projections
        else:
            limit = node.n if limit is None else min(limit, node.n)
        node = node.child
    if isinstance(node, KnnSearch):
        sel = node.child
        if sel is not None and not is_selection(sel):
            raise TypeError(f"KnnSearch child must be a selection subquery, "
                            f"got {type(sel).__name__}")
        return PipelineParts(selection=sel, knn=node,
                             projections=projections, limit=limit)
    if not is_selection(node):
        raise TypeError(f"unsupported plan node {type(node).__name__}")
    return PipelineParts(selection=node, knn=None,
                         projections=projections, limit=limit)


def is_selection(plan: Plan) -> bool:
    return isinstance(plan, (NodeScan, Filter, HopJoin, And, Or, Not))


@dataclasses.dataclass
class QueryResult:
    table: str
    mask: np.ndarray           # bool[n]
    seconds: float             # prefiltering time (Table 7)

    @property
    def selectivity(self) -> float:
        return float(self.mask.mean())


def output_table(plan: Plan, store: GraphStore) -> str:
    if isinstance(plan, NodeScan):
        return plan.table
    if isinstance(plan, Filter):
        return output_table(plan.child, store)
    if isinstance(plan, HopJoin):
        rel = store.rel(plan.rel)
        return rel.dst_table if plan.direction == "fwd" else rel.src_table
    if isinstance(plan, (And, Or)):
        lt = output_table(plan.left, store)
        rt = output_table(plan.right, store)
        if lt != rt:
            raise ValueError(f"boolean combinator over different tables: {lt} vs {rt}")
        return lt
    if isinstance(plan, Not):
        return output_table(plan.child, store)
    if isinstance(plan, KnnSearch):
        if plan.child is not None:
            return output_table(plan.child, store)
        if plan.table is None:
            raise ValueError("unfiltered KnnSearch needs an explicit table")
        return plan.table
    if isinstance(plan, (Project, Limit)):
        return output_table(plan.child, store)
    raise TypeError(plan)


def _eval(plan: Plan, store: GraphStore) -> np.ndarray:
    if isinstance(plan, NodeScan):
        return np.ones(store.node(plan.table).n, dtype=bool)
    if isinstance(plan, Filter):
        mask = _eval(plan.child, store)
        col = store.node(output_table(plan.child, store)).column(plan.column)
        if plan.op == "<":
            pred = col < plan.value
        elif plan.op == "<=":
            pred = col <= plan.value
        elif plan.op == ">":
            pred = col > plan.value
        elif plan.op == ">=":
            pred = col >= plan.value
        elif plan.op == "==":
            pred = col == plan.value
        elif plan.op == "range":
            pred = (col >= plan.lo) & (col < plan.hi)
        elif plan.op == "isin":
            pred = np.isin(col, np.asarray(plan.value))
        else:
            raise ValueError(f"unknown filter op {plan.op!r}")
        return mask & pred
    if isinstance(plan, HopJoin):
        rel = store.rel(plan.rel)
        src_mask = _eval(plan.child, store)
        csr = rel.fwd if plan.direction == "fwd" else rel.bwd
        n_out = store.node(rel.dst_table if plan.direction == "fwd"
                           else rel.src_table).n
        out = np.zeros(n_out, dtype=bool)
        sel = np.flatnonzero(src_mask)
        # expand CSR ranges of the selected sources (vectorized)
        starts, ends = csr.offsets[sel], csr.offsets[sel + 1]
        total = int((ends - starts).sum())
        if total:
            idx = np.repeat(starts, ends - starts) + _ranges(ends - starts)
            out[csr.targets[idx]] = True
        return out
    if isinstance(plan, And):
        return _eval(plan.left, store) & _eval(plan.right, store)
    if isinstance(plan, Or):
        return _eval(plan.left, store) | _eval(plan.right, store)
    if isinstance(plan, Not):
        return ~_eval(plan.child, store)
    raise TypeError(plan)


def _ranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for per-source offsets into CSR ranges."""
    csum = np.cumsum(lengths)
    out = np.arange(csum[-1])
    out -= np.repeat(csum - lengths, lengths)
    return out


def evaluate(plan: Plan, store: GraphStore) -> QueryResult:
    """Run Q_S; returns the node semimask + prefiltering wall time."""
    if not is_selection(plan):
        raise TypeError(
            f"evaluate() runs selection subqueries only; execute "
            f"{type(plan).__name__} plans through repro_torch.api.NavixDB")
    t0 = time.perf_counter()
    table = output_table(plan, store)
    mask = _eval(plan, store)
    return QueryResult(table=table, mask=mask,
                       seconds=time.perf_counter() - t0)
