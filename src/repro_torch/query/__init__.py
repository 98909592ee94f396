"""Declarative plan operators: selection subqueries, kNN, projection
(counterpart of ``repro.query``)."""
