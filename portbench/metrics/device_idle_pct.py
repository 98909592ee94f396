"""``device_idle_pct``: the share of the profiled sub-window (one whole
cycle of the cell's plans) in which no device event (kernel, copy, set)
ran. Moves ``qps``."""


def read(run: dict) -> float | None:
    t = run["trace"]
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
