"""``gather_distance_roofline``: kernel 1's share of its roofline
(``kernels/gather_distance.py``, ``csrc/gather_distance.cu``, f32 rows).

The bytes the profiled executes' distances need (``portbench.roofline.
gather_bytes``: each distance's row once, each query once, each output
once) over the device memory's rate, divided by kernel 1's device time in
the profiled sub-window. Moves ``qps``."""

import re

from portbench.roofline import bound_s, gather_bytes

KERNEL = re.compile(r"(^|[^A-Za-z0-9_])gather_distance_(tiled|spread)_kernel")
RESIDENCY = "f32"


def read(run: dict) -> float | None:
    t = run["trace"]
    if not t or run["cell"]["residency"] != RESIDENCY:
        return None
    seconds = sum(s for name, s in t["ops_s"].items() if KERNEL.search(name))
    if not seconds:
        return None
    prof = [e for e in run["executes"] if e["profiled"]]
    nbytes = gather_bytes(sum(e["distances"] for e in prof),
                          sum(e["queries"] for e in prof),
                          run["config"]["dim"], RESIDENCY)
    return 100.0 * bound_s(nbytes) / seconds
