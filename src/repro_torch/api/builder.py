"""Fluent query builder (port of ``repro.api.builder``) -- the
Cypher-analogue surface of NavixDB.

    Q.match("Chunk").where("year", ">=", 2020).knn(qvec, k=10)
    Q.match("Person").where("birth_date", "range", lo=0, hi=18250)
     .hop("PersonChunk", "fwd").knn(qvec, k=100).project("cID")

Each call returns a new immutable builder; ``.plan()`` compiles to the
exact ``repro_torch.query.operators`` tree a user could hand-build (the two
are ``==``-equal, which the tests assert). The query *vector* passed to
``.knn`` is bound on the builder, not in the plan node, so the same plan
shape can be re-executed with any vector (or a batch) and reuses one
program-cache entry; ``.knn()`` without a vector produces a plan template for
the serving engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.query.operators import (And, Filter, HopJoin, KnnSearch,
                                         Limit, NodeScan, Not, Or, Plan,
                                         Project)


@dataclasses.dataclass(frozen=True)
class Q:
    """Immutable builder wrapping a partially-constructed plan tree."""
    _plan: Plan
    bound_query: Optional[np.ndarray] = None

    # -- entry point --------------------------------------------------------
    @classmethod
    def match(cls, table: str) -> "Q":
        """MATCH (x:table) -- start a selection over one node table."""
        return cls(NodeScan(table))

    # -- selection subquery (Q_S) ------------------------------------------
    def where(self, column: str, op: str, value=None, *, lo=None,
              hi=None) -> "Q":
        """WHERE column <op> value; op in {<, <=, >, >=, ==, range, isin}."""
        return self._wrap(Filter(self._plan, column, op, value=value,
                                 lo=lo, hi=hi))

    def hop(self, rel: str, direction: str = "fwd") -> "Q":
        """Semi-join one relationship hop; chain twice for 2-hop RAG."""
        return self._wrap(HopJoin(self._plan, rel, direction))

    def union(self, other: "Q") -> "Q":
        return self._wrap(Or(self._plan, other._plan))

    def intersect(self, other: "Q") -> "Q":
        return self._wrap(And(self._plan, other._plan))

    def negate(self) -> "Q":
        return self._wrap(Not(self._plan))

    # -- the kNN operator ---------------------------------------------------
    def knn(self, query: Optional[np.ndarray] = None, k: int = 10,
            index: Optional[str] = None, efs: int = 0,
            heuristic: str = "adaptive_local") -> "Q":
        """QUERY_HNSW_INDEX over the current selection.

        ``query`` ([d] or [b, d]) is bound for execute(); omit it to build
        a reusable plan template (the vector is then supplied per request,
        e.g. by the serving engine).
        """
        node = KnnSearch(child=self._plan, k=k, index=index, efs=efs,
                         heuristic=heuristic)
        bound = None if query is None else np.asarray(query, np.float32)
        return Q(node, bound)

    # -- row operators ------------------------------------------------------
    def project(self, *columns: str) -> "Q":
        return self._wrap(Project(self._plan, tuple(columns)))

    def limit(self, n: int) -> "Q":
        return self._wrap(Limit(self._plan, n))

    # -- compile ------------------------------------------------------------
    def plan(self) -> Plan:
        return self._plan

    def _wrap(self, node: Plan) -> "Q":
        return Q(node, self.bound_query)
