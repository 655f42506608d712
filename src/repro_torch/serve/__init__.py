"""repro_torch.serve -- the serving engines, ported from ``repro.serve``:
the spectral one and the LM one (``ServeEngine``)."""

from repro_torch.runtime.faults import CircuitBreaker, FaultPlan, RetryPolicy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.queue import Admission, CoalescingQueue, PendingQueue
from repro_torch.serve.spectral import (
    PlanPool,
    SpectralEngine,
    SpectralFuture,
    SpectralRequest,
    StreamMismatch,
    plan_key,
)

__all__ = [
    "Admission",
    "CircuitBreaker",
    "CoalescingQueue",
    "FaultPlan",
    "PendingQueue",
    "PlanPool",
    "Request",
    "RetryPolicy",
    "ServeEngine",
    "SpectralEngine",
    "SpectralFuture",
    "SpectralRequest",
    "StreamMismatch",
    "plan_key",
]
