"""``prefilter_ms``: the query front door's milliseconds an execute
(``api/db.py``, ``query/operators.py``, ``core/bitset.py``):
``StageTimings.prefilter_ms + pack_ms``, averaged over the window's
executes outside the profiled sub-window. Moves ``qps``."""


def read(run: dict) -> float | None:
    ms = [e["timings"]["prefilter_ms"] + e["timings"]["pack_ms"]
          for e in run["executes"] if not e["profiled"]]
    return sum(ms) / len(ms) if ms else None
