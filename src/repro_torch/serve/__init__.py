"""repro_torch.serve — the host-side serving planes.

Two serving planes live here, mirroring the paper's CPU/accelerator split
(the CPU aggregates and schedules, the device runs saturated batches):

* :mod:`repro_torch.serve.tucker_service` — the micro-batching Tucker
  decomposition service (``TuckerService``): independent ``submit()``
  requests are grouped by spec and flushed as single batched
  ``TuckerPlan.batch`` dispatches, on the card by default.
* :mod:`repro_torch.serve.engine` — the LM token-serving engine (prefill,
  then greedy decode). Import it explicitly; it pulls in the model stack,
  which this package init does not.
"""
from repro_torch.serve.batching import (
    AdaptiveBatchPolicy,
    BatchKey,
    Flush,
    MicroBatcher,
    PolicyUpdate,
)
from repro_torch.serve.metrics import LatencyTracker, ServiceMetrics
from repro_torch.serve.tucker_service import (
    ServiceConfig,
    ServiceOverloadedError,
    TuckerService,
    TuckerTicket,
    serve_follower,
)

__all__ = [
    "AdaptiveBatchPolicy",
    "BatchKey",
    "Flush",
    "LatencyTracker",
    "MicroBatcher",
    "PolicyUpdate",
    "ServiceConfig",
    "ServiceMetrics",
    "ServiceOverloadedError",
    "TuckerService",
    "TuckerTicket",
    "serve_follower",
]
