"""``search_ms``: the beam loop's milliseconds an execute (``core/navix.py``
-> ``core/search_batch.py``): ``StageTimings.search_ms``, whose clock
stops after ``NavixDB._sync`` waits for the device, averaged over the
window's executes outside the profiled sub-window. Moves ``qps``."""


def read(run: dict) -> float | None:
    ms = [e["timings"]["search_ms"] for e in run["executes"]
          if not e["profiled"]]
    return sum(ms) / len(ms) if ms else None
