"""repro_torch.obs -- execution telemetry (port of ``repro.obs``): the
span recorder the trace-mode executor and ``Plan.profile`` write, and
the benchmark history ledger with its noise-aware regression check."""

from repro_torch.obs.history import append_snapshot, detect_regressions, read_history, snapshot_from_bench
from repro_torch.obs.trace import CounterSample, Span, TraceRecorder, merge_traces

__all__ = [
    "CounterSample", "Span", "TraceRecorder", "append_snapshot", "detect_regressions", "merge_traces",
    "read_history", "snapshot_from_bench",
]
