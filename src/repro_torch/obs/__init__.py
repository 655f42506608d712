"""repro_torch.obs -- execution telemetry (port of ``repro.obs``): the
span recorder the trace-mode executor and ``Plan.profile`` write."""

from repro_torch.obs.trace import CounterSample, Span, TraceRecorder, merge_traces

__all__ = ["CounterSample", "Span", "TraceRecorder", "merge_traces"]
