"""The serving tier: closed-queue engine + live front door (port of
``repro.serving``).

* :class:`SearchEngine` -- closed-queue drains (submit everything, then
  ``drain()``); the continuous-batching scheduler's reference driver.
* :class:`SearchService` -- the live loop: ``submit() -> Future`` while
  the device steps, deadlines, backpressure.
* Both run the same :class:`~repro_torch.serving.lanes.LaneBatch` device core,
  so their per-lane answers stay in bitwise lockstep.
"""

from repro_torch.serving.engine import (Request, Response, SearchEngine,
                                        canonical_plan, greedy_generate,
                                        resolve_alive)
from repro_torch.serving.heartbeat import HeartbeatMonitor
from repro_torch.serving.lanes import LaneBatch
from repro_torch.serving.queues import (QueueFull, QueueItem,
                                        ServiceClosed, SubmissionQueue,
                                        sigma_bin)
from repro_torch.serving.service import SearchService

__all__ = [
    "HeartbeatMonitor", "LaneBatch", "QueueFull", "QueueItem", "Request",
    "Response", "SearchEngine", "SearchService", "ServiceClosed",
    "SubmissionQueue", "canonical_plan", "greedy_generate",
    "resolve_alive", "sigma_bin",
]
