"""repro_torch.serve -- the spectral serving engine, ported from
``repro.serve`` (the LM engine ``ServeEngine`` is not ported yet,
ROADMAP A15)."""

from repro_torch.runtime.faults import CircuitBreaker, FaultPlan, RetryPolicy
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
    "RetryPolicy",
    "SpectralEngine",
    "SpectralFuture",
    "SpectralRequest",
    "StreamMismatch",
    "plan_key",
]
