"""Step-time monitoring + straggler detection, ported from
``repro.runtime.monitor`` (standard library only, as there).

When every rank executes the same program, classic work-stealing does
not apply; the operable levers are (a) detecting that steps are slower
than the fleet baseline (failing HBM, thermal throttle, a slow host
input pipeline), (b) flagging the offender for the scheduler to cordon,
and (c) keeping the input pipeline ahead of the device so a slow host
never blocks the collective. This module implements the detection half;
the spectral serving engine wraps its dispatch in one so queue and
straggler telemetry are on by default.

Telemetry is window-bounded (a ``deque`` per monitor/window) so
always-on recording cannot grow without bound; ``reset()`` is the
escape hatch that drops accumulated state. A step may carry *spans*
(``repro_torch.obs.trace`` spans, their JSONL dicts, or plain
``(name, seconds)`` pairs) so a straggler flag names the offending
stage -- the culprit -- instead of just "the step was slow".
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    tokens: int
    flagged: bool
    #: name of the slowest span within the step (None when no spans
    #: were attached) -- what a straggler flag attributes the time to
    culprit: Optional[str] = None


def percentiles(
    samples: Iterable[float], qs: Sequence[float] = (50, 90, 99)
) -> Dict[str, float]:
    """Nearest-rank percentiles of ``samples``: ``{"p50": ..., ...}``.

    Convention (asserted by tests): rank = ``max(1, ceil(q/100 * n))``,
    1-indexed into the sorted samples -- so ``q=0`` returns the minimum,
    ``q=100`` the maximum, and a single sample is every percentile of
    itself. Empty input returns 0.0 for every quantile (a serving
    dashboard wants numbers, not exceptions, before traffic arrives).

    Labels encode the quantile with ``.`` -> ``_`` (``99.9`` ->
    ``"p99_9"``). Two *distinct* quantiles whose labels would collide
    (e.g. ``99.9`` and ``99.90000000000001`` both format to ``99.9`` at
    ``%g`` precision) raise instead of silently collapsing into one
    dict key; passing the same quantile twice (``50`` and ``50.0``) is
    fine -- they are the same percentile."""
    data = sorted(samples)
    out: Dict[str, float] = {}
    label_q: Dict[str, float] = {}
    for q in qs:
        if not 0 <= q <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        label = "p" + f"{q:g}".replace(".", "_")
        prev = label_q.get(label)
        if prev is not None and prev != q:
            raise ValueError(
                f"percentile labels collide: q={prev!r} and q={q!r} both "
                f"format to {label!r}; pass distinguishable quantiles"
            )
        label_q[label] = q
        if not data:
            out[label] = 0.0
            continue
        # nearest-rank: ceil(q/100 * n), 1-indexed; p0 -> first sample
        rank = max(1, math.ceil(q / 100 * len(data)))
        out[label] = float(data[min(rank, len(data)) - 1])
    return out


class LatencyWindow:
    """Rolling window of recent scalar samples (latencies, queue depths)
    with O(1) record and on-demand percentile summaries -- the telemetry
    primitive behind the spectral serving engine's p50/p99 stats."""

    def __init__(self, maxlen: int = 2048):
        self._window: collections.deque = collections.deque(maxlen=maxlen)
        self.count = 0  # lifetime samples, not just the retained window
        self.total = 0.0

    def record(self, value: float) -> None:
        self._window.append(float(value))
        self.count += 1
        self.total += float(value)

    def __len__(self) -> int:
        return len(self._window)

    def percentiles(self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        return percentiles(self._window, qs)

    def summary(self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        out = self.percentiles(qs)
        out["count"] = self.count
        out["mean"] = (self.total / self.count) if self.count else 0.0
        out["max"] = max(self._window) if self._window else 0.0
        return out


def _span_name_seconds(span) -> Optional[Tuple[str, float]]:
    """(name, seconds) from a trace span (``repro_torch.obs.trace.Span``
    or any object with ``name`` / ``dur``), a JSONL span dict, or a
    plain (name, seconds) pair; None for anything unusable."""
    if isinstance(span, dict):
        name, dur = span.get("name"), span.get("dur")
    elif isinstance(span, (tuple, list)) and len(span) == 2:
        name, dur = span
    else:
        name, dur = getattr(span, "name", None), getattr(span, "dur", None)
    if isinstance(name, str) and isinstance(dur, (int, float)):
        return name, float(dur)
    return None


class StepMonitor:
    """EMA-baselined straggler detector over a bounded step history.

    ``history`` keeps the most recent ``history_limit`` steps (the EMA
    and lifetime counters survive trimming), so leaving a monitor
    recording forever -- the serving dispatch does -- costs
    O(history_limit) memory. ``reset()`` drops everything."""

    def __init__(
        self,
        *,
        ema_alpha: float = 0.1,
        straggler_factor: float = 2.0,
        warmup: int = 3,
        history_limit: int = 512,
    ):
        self.alpha = ema_alpha
        self.factor = straggler_factor
        self.warmup = warmup
        self.history_limit = history_limit
        self.reset()

    def reset(self) -> None:
        """Drop all recorded telemetry (history, EMA baseline, step and
        flag counters) -- the escape hatch for always-on monitors."""
        self.ema: Optional[float] = None
        self.history: collections.deque = collections.deque(maxlen=self.history_limit)
        self._t0: Optional[float] = None
        self._step = 0
        self.flag_count = 0  # lifetime, survives history trimming

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *, tokens: int = 0, spans: Optional[Iterable] = None) -> StepStats:
        """Close the step opened by :meth:`start`. ``spans`` optionally
        attributes the step's time to its stages (trace spans or
        ``(name, seconds)`` pairs): the slowest becomes the step's
        ``culprit``, so a straggler flag names the offending stage."""
        dt = time.perf_counter() - self._t0
        flagged = False
        if self._step >= self.warmup and self.ema is not None:
            flagged = dt > self.factor * self.ema
        if self.ema is None:
            self.ema = dt
        elif not flagged:  # don't let outliers poison the baseline
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        culprit = None
        if spans is not None:
            parsed = [p for p in map(_span_name_seconds, spans) if p is not None]
            if parsed:
                culprit = max(parsed, key=lambda p: p[1])[0]
        st = StepStats(self._step, dt, tokens, flagged, culprit)
        self.history.append(st)
        self._step += 1
        if flagged:
            self.flag_count += 1
        return st

    def percentiles(
        self, qs: Sequence[float] = (50, 90, 99), window: Optional[int] = None
    ) -> Dict[str, float]:
        """Step-time percentiles over the most recent ``window`` steps
        (default: the whole retained history) -- the p50/p99 view of the
        same samples the EMA smooths."""
        recent: Iterable[StepStats] = self.history
        if window is not None:
            recent = list(self.history)[-window:]
        return percentiles((s.seconds for s in recent), qs)

    @property
    def tokens_per_sec(self) -> float:
        recent = list(self.history)[-10:]
        tok = sum(s.tokens for s in recent)
        sec = sum(s.seconds for s in recent)
        return tok / sec if sec else 0.0

    def straggler_report(self) -> dict:
        """Summary incl. per-culprit flag attribution: ``culprits`` maps
        stage name -> number of *flagged* steps it was slowest in."""
        flags = [s for s in self.history if s.flagged]
        culprits: Dict[str, int] = {}
        for s in flags:
            if s.culprit is not None:
                culprits[s.culprit] = culprits.get(s.culprit, 0) + 1
        return {
            "steps": self._step,
            "flagged": self.flag_count,
            "ema_s": self.ema,
            "worst": max((s.seconds for s in self.history), default=0.0),
            "culprits": culprits,
        }
