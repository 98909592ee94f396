"""``launches_per_query``: launches of the gather-distance kernels (the
f32 and the int8 one's ``LAUNCHES`` counters) over the window, per query
answered in it. Moves ``qps``: each launch is host dispatch."""


def read(run: dict) -> float | None:
    if not run["launches"] or not run["queries"]:
        return None
    return run["launches"] / run["queries"]
