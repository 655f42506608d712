"""Deterministic chaos injection + recovery primitives (the fault layer),
ported from ``repro.runtime.faults`` (standard library only, as there).

- :class:`FaultPlan` -- a seeded, fully deterministic chaos hook
  installed via ``run_schedule(..., faults=)`` (and through
  ``Plan.faults`` / ``plan_fft(faults=)`` / ``SpectralEngine.set_faults``).
  The executor consults it before every Exchange segment (and before a
  ``global:`` library dispatch); a matching spec can **raise**
  (:class:`InjectedFault`), **stall** past a deadline (injectable
  ``sleep``), or report **device loss** (:class:`DeviceLossFault`
  carrying the surviving device count -- the signal
  ``run_with_recovery`` + ``elastic_mesh`` turn into a remesh). Every
  decision comes from explicit counters plus a seeded
  ``random.Random``, so a plan with the same specs and seed fires on
  the same matches as the reference's.
- :class:`RetryPolicy` -- the dispatch retry budget (attempts + wall
  deadline) the serving engine applies before quarantining a request.
- :class:`CircuitBreaker` -- per-key closed/open/half-open breaker with
  an injectable clock; the serving engine keys it by
  ``(backend, plan-key)`` and degrades open keys to the ``xla_auto``
  library schedule until a probe succeeds.

On a :class:`~repro_torch.core.mesh.ProcessGroupMesh` every rank holds
its own plan; the executor (:mod:`repro_torch.core.schedule`) makes the
ranks agree on whether a plan is armed and whether a fault fired, so
they all raise together. Nothing here imports the core/serve layers --
the executor and engine duck-type against ``FaultPlan.active()`` /
``on_stage()`` -- so the module stays a dependency leaf.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple


class InjectedFault(RuntimeError):
    """Raised by a :class:`FaultPlan` ``error`` spec at the stage it names."""


class DeviceLossFault(InjectedFault):
    """A collective 'returned' on a shrunken device set: the exchange's
    ring lost ranks. ``alive`` is the surviving device count the
    recovery layer should remesh to (None = unknown, re-probe)."""

    def __init__(self, message: str, *, alive: Optional[int] = None):
        super().__init__(message)
        self.alive = alive


@dataclasses.dataclass
class FaultSpec:
    """One armed fault. ``match`` is a substring of the stage label the
    executor reports (``Exchange(slab:model, alltoall, p=8, fft)`` /
    ``global:fft2`` -- see ``repro_torch.core.schedule._stage_label``), so a
    spec can name one Exchange ("rows"), a backend ("scatter"), every
    collective ("Exchange"), or anything (""). Firing is decided per
    *matching execution*: matches ``{at, at+every, at+2*every, ...}``
    fire (``every=None`` = every match from ``at`` on), capped at
    ``times`` total firings (None = unlimited) -- so the default
    ``at=0, times=1`` fires exactly once, on the first match, and
    ``times=3`` poisons the next three matching executions; a ``rate``
    spec instead fires each match with probability ``rate`` drawn from
    the plan's seeded RNG."""

    mode: str  # "error" | "stall" | "device_loss"
    match: str = "Exchange"
    at: int = 0
    every: Optional[int] = None
    times: Optional[int] = 1
    rate: Optional[float] = None
    stall_s: float = 0.0
    alive: Optional[int] = None  # device_loss: surviving device count

    def __post_init__(self):
        if self.mode not in ("error", "stall", "device_loss"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.rate is not None and not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


class FaultPlan:
    """A deterministic, seeded set of :class:`FaultSpec`\\ s.

    The executor calls :meth:`on_stage` with each Exchange's label just
    before launching the segment; the plan counts matches per spec and
    applies whichever armed spec is scheduled to fire -- raising,
    sleeping (``sleep`` is injectable), or raising device loss. Every
    firing is appended to :attr:`events` (and stamped as a ``cat="fault"``
    span when a :class:`repro_torch.obs.trace.TraceRecorder` is attached via
    ``recorder=``), so chaos runs leave an auditable trail.

    :meth:`active` is False once every spec is exhausted -- callers
    (``Plan.execute``) then return to the plain executor, which is what
    lets a circuit-breaker probe observe recovery."""

    def __init__(
        self,
        specs: Tuple[FaultSpec, ...] = (),
        *,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        recorder=None,
    ):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed
        self.sleep = sleep
        self.recorder = recorder
        self._rng = random.Random(seed)
        self._seen: Dict[int, int] = {}  # spec index -> matching executions
        self._fired: Dict[int, int] = {}  # spec index -> firings
        self.injected = 0
        self.stalled_s = 0.0
        self.events: List[dict] = []

    # -- constructors ------------------------------------------------------
    @classmethod
    def error(cls, match: str = "Exchange", **kw) -> "FaultPlan":
        """Raise :class:`InjectedFault` at the named stage."""
        plan_kw = {k: kw.pop(k) for k in ("seed", "sleep", "recorder") if k in kw}
        return cls((FaultSpec("error", match=match, **kw),), **plan_kw)

    @classmethod
    def stall(cls, stall_s: float, match: str = "Exchange", **kw) -> "FaultPlan":
        """Stall the named stage by ``stall_s`` (via the injectable
        sleep) -- the 'slow parcelport' mode retry deadlines catch."""
        plan_kw = {k: kw.pop(k) for k in ("seed", "sleep", "recorder") if k in kw}
        return cls((FaultSpec("stall", match=match, stall_s=stall_s, **kw),), **plan_kw)

    @classmethod
    def device_loss(
        cls, alive: Optional[int] = None, match: str = "Exchange", **kw
    ) -> "FaultPlan":
        """Raise :class:`DeviceLossFault` (ring lost ranks; ``alive``
        survivors) at the named stage."""
        plan_kw = {k: kw.pop(k) for k in ("seed", "sleep", "recorder") if k in kw}
        return cls(
            (FaultSpec("device_loss", match=match, alive=alive, **kw),), **plan_kw
        )

    @classmethod
    def rate(
        cls, rate: float, mode: str = "error", match: str = "Exchange", *, seed: int = 0, **kw
    ) -> "FaultPlan":
        """Fire each matching execution with probability ``rate`` from
        the seeded RNG (the benchmark's fixed injected-fault rate)."""
        plan_kw = {k: kw.pop(k) for k in ("sleep", "recorder") if k in kw}
        return cls(
            (FaultSpec(mode, match=match, rate=rate, times=None, **kw),),
            seed=seed,
            **plan_kw,
        )

    # -- state -------------------------------------------------------------
    def active(self) -> bool:
        """Whether any spec can still fire (executors skip the chaos
        path entirely -- running the plain executor -- when False)."""
        return any(
            s.times is None or self._fired.get(i, 0) < s.times
            for i, s in enumerate(self.specs)
        )

    def reset(self) -> None:
        """Re-arm: zero all counters and reseed the RNG, so a reset plan
        replays the identical fault sequence."""
        self._rng = random.Random(self.seed)
        self._seen.clear()
        self._fired.clear()
        self.injected = 0
        self.stalled_s = 0.0
        self.events.clear()

    # -- the executor hook -------------------------------------------------
    def _scheduled(self, spec: FaultSpec, k: int) -> bool:
        if spec.rate is not None:
            return self._rng.random() < spec.rate
        if k < spec.at:
            return False
        if spec.every is None:
            return True  # every match from `at` on; `times` caps firings
        return (k - spec.at) % spec.every == 0

    def on_stage(self, label: str, *, index: int = 0) -> None:
        """Called by the executor before launching the stage named
        ``label``; raises / stalls when an armed spec fires."""
        for i, spec in enumerate(self.specs):
            if spec.times is not None and self._fired.get(i, 0) >= spec.times:
                continue
            if spec.match not in label:
                continue
            k = self._seen.get(i, 0)
            self._seen[i] = k + 1
            if not self._scheduled(spec, k):
                continue
            self._fired[i] = self._fired.get(i, 0) + 1
            self.injected += 1
            self._record(spec, label, index, k)
            if spec.mode == "stall":
                self.stalled_s += spec.stall_s
                self.sleep(spec.stall_s)
            elif spec.mode == "device_loss":
                raise DeviceLossFault(
                    f"injected device loss at {label} (match {k}"
                    f"{'' if spec.alive is None else f', {spec.alive} alive'})",
                    alive=spec.alive,
                )
            else:
                raise InjectedFault(f"injected fault at {label} (match {k})")

    def _record(self, spec: FaultSpec, label: str, index: int, k: int) -> None:
        event = {
            "mode": spec.mode,
            "stage": label,
            "index": index,
            "match_count": k,
            "injected": self.injected,
        }
        self.events.append(event)
        if self.recorder is not None:
            with self.recorder.span(f"fault:{spec.mode}", cat="fault", **event):
                pass  # instant marker span: the fault fired here


# ---------------------------------------------------------------------------
# Dispatch retry budget + circuit breaker (serving-side recovery)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-dispatch retry budget: up to ``max_retries`` re-executions of
    a failed solo request, abandoned once ``deadline_s`` of wall clock
    (the engine's injectable clock) has elapsed since the first attempt."""

    max_retries: int = 1
    deadline_s: float = float("inf")


class CircuitBreaker:
    """Per-key three-state breaker with an injectable clock.

    ``closed`` keys dispatch normally; ``failure_threshold`` consecutive
    failures open a key (``allow`` returns False -- callers degrade);
    after ``reset_after_s`` the next ``allow`` admits ONE half-open
    probe, whose success re-closes the key (failure re-opens it and
    restarts the timeout). Counters (``opened``/``reclosed``/``probes``)
    feed the serving engine's ``metrics()``. ``allow`` and
    ``record_failure`` take the time as ``now`` where the caller gives
    it (the serving engine on a process group passes this breaker's
    clock agreed over the ranks, so every rank opens, probes and closes
    a key together); otherwise they read ``clock``."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        reset_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self.clock = clock
        self._state: Dict[Hashable, str] = {}
        self._failures: Dict[Hashable, int] = {}
        self._opened_at: Dict[Hashable, float] = {}
        self.opened = 0  # transitions into "open" (first open + re-opens)
        self.reclosed = 0  # half-open probes that healed the key
        self.probes = 0  # half-open probes admitted

    def state(self, key: Hashable) -> str:
        return self._state.get(key, "closed")

    def states(self) -> Dict[Hashable, str]:
        return dict(self._state)

    def allow(self, key: Hashable, now: Optional[float] = None) -> bool:
        """Whether the next dispatch for ``key`` may use the primary
        plan (False: degrade). Transitions open -> half-open when the
        reset timeout has elapsed, admitting exactly one probe."""
        st = self.state(key)
        if st == "closed":
            return True
        now = self.clock() if now is None and st == "open" else now
        if st == "open" and now - self._opened_at[key] >= self.reset_after_s:
            self._state[key] = "half-open"
            self.probes += 1
            return True
        return False  # open (cooling down) or half-open (probe in flight)

    def record_success(self, key: Hashable) -> None:
        if self.state(key) != "closed":
            self.reclosed += 1
        self._state[key] = "closed"
        self._failures[key] = 0

    def record_failure(self, key: Hashable, now: Optional[float] = None) -> None:
        n = self._failures.get(key, 0) + 1
        self._failures[key] = n
        st = self.state(key)
        if st == "half-open" or (st == "closed" and n >= self.failure_threshold):
            self._state[key] = "open"
            self._opened_at[key] = self.clock() if now is None else now
            self._failures[key] = 0
            self.opened += 1

    def reset(self) -> None:
        """Forget every key (e.g. after an elastic remesh -- the old
        mesh's failures say nothing about the new fabric)."""
        self._state.clear()
        self._failures.clear()
        self._opened_at.clear()

    def stats(self) -> Dict[str, int]:
        states = list(self._state.values())
        return {
            "open": states.count("open"),
            "half_open": states.count("half-open"),
            "opened": self.opened,
            "reclosed": self.reclosed,
            "probes": self.probes,
        }
