"""Tracing primitives for the stage-schedule executor (PyTorch port of
``repro.obs.trace``; standard library only).

The paper's breakdown (communication vs local FFT compute, per
parcelport) is a timeline result: HPX's APEX stamps wall-clock spans
around every task so cost can be attributed to the operation that
incurred it. Here the tasks are the Stage records of the schedule IR: a
:class:`TraceRecorder` collects :class:`Span` records (name +
wall-clock start/duration + free-form ``args``) and counter samples,
and exports them as Chrome-trace JSON (loadable in ``chrome://tracing``
or https://ui.perfetto.dev) or as one JSON object per line (JSONL).

Producers:

- ``run_schedule(..., trace=rec)`` stamps one span per schedule
  segment (exchange spans carry backend/role/wire bytes -- see
  :mod:`repro_torch.core.schedule`); on a ``ProcessGroupMesh`` each rank
  records its own spans under ``pid=rank``;
- ``Plan.profile`` aggregates those spans into an observed-vs-predicted
  per-stage table.

Consumers: ``CommParams.refine_online`` (alpha/beta re-fit from
observed exchange spans) and ``planner.record_observed`` (the wisdom
observed-timings channel).

Timestamps come from an injectable monotonic clock (seconds); exports
convert to the microseconds Chrome-trace expects. Span ``ts`` are
relative to the recorder's creation, so merged traces from different
processes line up per-pid rather than pretending to share a clock.
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional


@dataclasses.dataclass
class Span:
    """One completed wall-clock interval. ``t0``/``dur`` are seconds
    (``t0`` relative to the recorder's epoch); ``cat`` groups spans for
    filtering (``"exchange"`` marks collective stages); ``args`` is the
    free-form attribute payload shown in the trace viewer."""

    name: str
    t0: float
    dur: float
    cat: str = "stage"
    pid: int = 0
    tid: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_chrome(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "ph": "X",
            "ts": self.t0 * 1e6,
            "dur": self.dur * 1e6,
            "pid": self.pid,
            "tid": self.tid,
            "cat": self.cat,
            "args": dict(self.args),
        }


@dataclasses.dataclass
class CounterSample:
    """One counter sample (Chrome-trace ``ph:"C"``): ``values`` maps
    series name -> number, plotted as a stacked area per counter name."""

    name: str
    t: float
    values: Dict[str, float]
    pid: int = 0

    def to_chrome(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "ph": "C",
            "ts": self.t * 1e6,
            "pid": self.pid,
            "tid": 0,
            "args": dict(self.values),
        }


class TraceRecorder:
    """Collects spans + counters; exports Chrome-trace JSON and JSONL.

    The clock is injectable (tests pass a fake); production uses
    ``time.perf_counter``. Recording is append-only and cheap (one
    dataclass per span) so it can stay on in serving paths.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None, *, pid: int = 0):
        self._clock = clock or time.perf_counter
        self._epoch = self._clock()
        self.pid = pid
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        self._process_names: Dict[int, str] = {}
        self._adopted: List[Dict[str, Any]] = []

    # -- recording ---------------------------------------------------------
    def now(self) -> float:
        """Seconds since the recorder was created."""
        return self._clock() - self._epoch

    @contextmanager
    def span(self, name: str, *, cat: str = "stage", tid: int = 0, **args) -> Iterator[Span]:
        """Context manager stamping one span around the enclosed work.
        Extra keyword arguments become the span's ``args``; the yielded
        span may be annotated further before the block exits."""
        sp = Span(name=name, t0=self.now(), dur=0.0, cat=cat, pid=self.pid, tid=tid, args=args)
        try:
            yield sp
        finally:
            sp.dur = self.now() - sp.t0
            self.spans.append(sp)

    def add_span(
        self,
        name: str,
        t0: float,
        dur: float,
        *,
        cat: str = "stage",
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> Span:
        """Record an already-timed interval (``t0`` in recorder-relative
        seconds, e.g. from :meth:`now`)."""
        sp = Span(name=name, t0=t0, dur=dur, cat=cat, pid=self.pid, tid=tid, args=dict(args or {}))
        self.spans.append(sp)
        return sp

    def counter(self, name: str, **values: float) -> CounterSample:
        c = CounterSample(name=name, t=self.now(), values=dict(values), pid=self.pid)
        self.counters.append(c)
        return c

    # -- queries -----------------------------------------------------------
    def mark(self) -> int:
        """Bookmark for :meth:`spans_since` (e.g. per serve dispatch)."""
        return len(self.spans)

    def spans_since(self, mark: int) -> List[Span]:
        return self.spans[mark:]

    def exchange_spans(self) -> List[Span]:
        """The collective-stage spans (``cat == "exchange"``) -- what
        ``CommParams.refine_online`` fits against."""
        return [s for s in self.spans if s.cat == "exchange"]

    def total_seconds(self) -> float:
        return sum(s.dur for s in self.spans)

    # -- merging -----------------------------------------------------------
    def set_process_name(self, pid: int, name: str) -> None:
        self._process_names[pid] = name

    def adopt(
        self,
        events: Iterable[Dict[str, Any]],
        *,
        pid: Optional[int] = None,
        name: Optional[str] = None,
    ) -> None:
        """Fold pre-exported Chrome events (e.g. printed by a benchmark
        subprocess) into this recorder under their own pid row. Events
        keep their source-relative timestamps -- different processes do
        not share a clock, so rows line up per-pid, not globally."""
        events = list(events)
        if pid is None:
            used = {e.get("pid", 0) for e in self._adopted} | {s.pid for s in self.spans}
            used.add(self.pid)
            pid = max(used) + 1
        for e in events:
            e = dict(e)
            e["pid"] = pid
            self._adopted.append(e)
        if name is not None:
            self.set_process_name(pid, name)

    def merge(self, other: "TraceRecorder", *, pid: Optional[int] = None, name: Optional[str] = None) -> None:
        self.adopt(other._chrome_events(), pid=pid, name=name)

    # -- exports -----------------------------------------------------------
    def _chrome_events(self) -> List[Dict[str, Any]]:
        return [s.to_chrome() for s in self.spans] + [c.to_chrome() for c in self.counters]

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The ``chrome://tracing`` / Perfetto JSON object."""
        events = self._chrome_events() + list(self._adopted)
        for pid, pname in sorted(self._process_names.items()):
            events.append({
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": pname},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)

    def to_jsonl(self) -> str:
        """One JSON object per line: spans (``{"kind": "span", ...}``
        with seconds-valued ``t0``/``dur``) then counters."""
        lines = []
        for s in self.spans:
            lines.append(json.dumps({
                "kind": "span", "name": s.name, "cat": s.cat, "t0": s.t0,
                "dur": s.dur, "pid": s.pid, "tid": s.tid, "args": s.args,
            }))
        for c in self.counters:
            lines.append(json.dumps({
                "kind": "counter", "name": c.name, "t": c.t,
                "pid": c.pid, "values": c.values,
            }))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def from_jsonl(cls, path: str) -> "TraceRecorder":
        rec = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if d.get("kind") == "span":
                    rec.spans.append(Span(
                        name=d["name"], t0=d["t0"], dur=d["dur"],
                        cat=d.get("cat", "stage"), pid=d.get("pid", 0),
                        tid=d.get("tid", 0), args=d.get("args", {}),
                    ))
                elif d.get("kind") == "counter":
                    rec.counters.append(CounterSample(
                        name=d["name"], t=d["t"], values=d.get("values", {}),
                        pid=d.get("pid", 0),
                    ))
        return rec


def merge_traces(recorders: Iterable[TraceRecorder], names: Optional[Iterable[str]] = None) -> TraceRecorder:
    """Merge recorders into a fresh one, one pid row each."""
    out = TraceRecorder()
    names = list(names) if names is not None else None
    for i, rec in enumerate(recorders):
        label = names[i] if names and i < len(names) else None
        out.merge(rec, pid=i + 1, name=label)
    return out
