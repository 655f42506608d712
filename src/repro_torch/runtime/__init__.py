"""repro_torch.runtime -- fault injection, monitoring and recovery,
ported from ``repro.runtime``: seeded chaos plans (:mod:`.faults`), the
serving retry budget and circuit breaker, latency windows and straggler
detection (:mod:`.monitor`), and the restart loop with ``elastic_mesh``
(:mod:`.elastic`)."""

from repro_torch.runtime.elastic import (
    FailureInjector,
    Resume,
    SimulatedFailure,
    backoff_delay,
    elastic_mesh,
    run_with_recovery,
)
from repro_torch.runtime.faults import (
    CircuitBreaker,
    DeviceLossFault,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    RetryPolicy,
)
from repro_torch.runtime.monitor import LatencyWindow, StepMonitor, StepStats, percentiles

__all__ = [
    "CircuitBreaker",
    "DeviceLossFault",
    "FailureInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "LatencyWindow",
    "Resume",
    "RetryPolicy",
    "SimulatedFailure",
    "StepMonitor",
    "StepStats",
    "backoff_delay",
    "elastic_mesh",
    "percentiles",
    "run_with_recovery",
]
