"""Spectral serving engine: many concurrent FFT-family requests, one mesh.
PyTorch port of ``repro.serve.spectral``.

Serving traffic is many small-to-medium fft/rfft/poisson/convolve/
gradient requests arriving concurrently. The engine runs them through
the plan front-end:

- **Warm plan-cache pool** (:class:`PlanPool`): plans keyed like planner
  wisdom (shape / ndim / dtype / P / decomp / real, the reference's key
  text byte for byte), LRU-evicted beyond ``capacity``.
  :meth:`PlanPool.warm_from_wisdom` parses an imported wisdom file and
  pre-plans (and runs once) every entry matching this mesh, so a warmed
  engine's request path contains no ``plan_fft`` call.
- **Request coalescing** (:class:`repro_torch.serve.queue.CoalescingQueue`):
  same-key requests (same op + shape + dtype + real + lengths) batch
  into ONE stacked execution -- the batch axis is a leading dim of the
  plan's ``global_shape``. The operands are stacked with ``torch.stack``
  on the mesh's device and zero-padded up to a power-of-two bucket
  (outputs sliced back per request), so the pool holds O(log max_batch)
  plans per shape. Admission is max-batch / max-wait.
- **Async dispatch**: a dispatched batch is never waited on. On the card
  the engine records a CUDA event on the current stream right after the
  batch's launches; :meth:`SpectralFuture.block` waits on its own
  batch's event only. On the CPU the work is done when the launch
  returns.
- **Telemetry**: p50/p99 request latency, queue-wait and queue-depth
  windows (:class:`repro_torch.runtime.monitor.LatencyWindow`),
  coalescing factor, the host-side ``pool`` / ``stack`` / ``execute``
  dispatch stages, and plan-pool hit/miss/eviction counters.
- **Fault tolerance**: per-request isolation (a poisoned request in a
  coalesced batch is split out, retried solo under a
  :class:`repro_torch.runtime.faults.RetryPolicy` budget, and
  quarantined -- its siblings still resolve, and its future re-raises
  the recorded error); a per-(backend, plan-key)
  :class:`repro_torch.runtime.faults.CircuitBreaker` that degrades a
  repeatedly failing key to the ``xla_auto`` backend (one ``torch.fft``
  call on the gathered global array -- the reference's own degradation
  target, not a port of a kernel) and re-probes the primary plan after
  a cool-down; and :meth:`SpectralEngine.remesh` for elastic re-scale.
  Chaos is injected with :meth:`SpectralEngine.set_faults`. Isolation,
  retries and the breaker act on injected faults
  (:class:`~repro_torch.runtime.faults.InjectedFault`) only: any other
  exception -- a kernel that fails to launch, a transport error, a
  plan that cannot be built -- propagates to the caller whose call
  dispatched the batch, and is never served degraded.

The engine serves on a :class:`~repro_torch.core.mesh.SimMesh` (the
caller's arrays are global) and, SPMD, on a
:class:`~repro_torch.core.mesh.ProcessGroupMesh`: every rank runs the
same program, submits the same request sequence (op, dtype, lengths,
ndim) with its own block of each operand -- the counterpart of a sharded
``jax.Array``'s addressable shard -- and gets its own block of each
output. Pool keys and plans are the global shape's. Each host decision
that leads into collectives is agreed, one ``mesh.host_max`` (a CPU
all-reduce that never waits on the card's stream) per decision: a
submission that completes a full batch, each ``poll``, flush and forced
dispatch, the retry budget's clock and the breaker's clock. Submissions
wait on the rank until the next agreement, which admits them into the
queue at its agreed time after checking that every rank submitted as
many requests with the same keys (a rank whose stream differs makes
every rank raise :class:`StreamMismatch` before anything dispatches).
Every rank thus batches, retries, quarantines, degrades and probes
together whatever its own clock says; injected faults are agreed by the
executor. A partial batch's max-wait is read at the next agreement (a
``poll``, a full batch, a flush), not at any submission. ``result()`` /
``block()`` of a still-queued future is collective on a process group
(every rank calls it at the same point of its program, as it does every
other engine call). ``stats()`` counts the agreements and their host
time.

Request ops (all flow through any :class:`repro_torch.core.Plan`):
``fft``, ``rfft``, ``ifft`` (c2c spectrum in the plan's own layout),
``poisson``, ``convolve``, ``correlate``, ``gradient``, ``laplacian``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.apps import convolve as _convolve
from repro_torch.apps import derivatives as _derivatives
from repro_torch.apps import poisson as _poisson
from repro_torch.core import planner as _planner
from repro_torch.core.grid import grid_from_mesh
from repro_torch.core.mesh import fft_axis
from repro_torch.core.plan import plan_fft
from repro_torch.runtime.faults import CircuitBreaker, InjectedFault, RetryPolicy
from repro_torch.runtime.monitor import LatencyWindow, StepMonitor
from repro_torch.serve.queue import Admission, CoalescingQueue


# ---------------------------------------------------------------------------
# Request ops -- every op takes (plan, stacked operands, lengths)
# ---------------------------------------------------------------------------


def _op_fft(plan, ops, lengths):
    return plan.execute(ops[0])


def _op_ifft(plan, ops, lengths):
    return plan.inverse(ops[0])


def _op_poisson(plan, ops, lengths):
    return _poisson.solve_poisson(ops[0], plan, lengths)


def _op_convolve(plan, ops, lengths):
    return _convolve.fft_convolve(ops[0], ops[1], plan)


def _op_correlate(plan, ops, lengths):
    return _convolve.fft_correlate(ops[0], ops[1], plan)


def _op_gradient(plan, ops, lengths):
    return _derivatives.gradient(ops[0], plan, lengths)


def _op_laplacian(plan, ops, lengths):
    return _derivatives.laplacian(ops[0], plan, lengths)


#: op name -> (fn, arity). "rfft" is "fft" with a real-input check;
#: "ifft" consumes the spectrum in the plan's own forward-output layout
#: (c2c only -- a real plan's spectrum shape is not the request shape).
_OPS: Dict[str, Tuple[Callable, int]] = {
    "fft": (_op_fft, 1),
    "rfft": (_op_fft, 1),
    "ifft": (_op_ifft, 1),
    "poisson": (_op_poisson, 1),
    "convolve": (_op_convolve, 2),
    "correlate": (_op_correlate, 2),
    "gradient": (_op_gradient, 1),
    "laplacian": (_op_laplacian, 1),
}


def _dtype_name(dtype) -> str:
    """``complex64`` for ``torch.complex64``, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


# ---------------------------------------------------------------------------
# Plan pool
# ---------------------------------------------------------------------------


def plan_key(shape, ndim: int, dtype, p: int, decomp: str, real: bool) -> str:
    """Pool key, the same identity the planner's wisdom keys carry:
    shape (batch bucket included) / ndim / dtype / P / decomp / real --
    the reference's text byte for byte."""
    dims = "x".join(str(d) for d in shape)
    return (
        f"shape={dims}|ndim={ndim}|dtype={_dtype_name(dtype)}|P={p}"
        f"|decomp={decomp}|real={int(real)}"
    )


class PlanPool:
    """LRU cache of warm (validated, backend-resolved) plans.

    ``get`` returns a cached plan or builds one through
    :func:`repro_torch.core.plan_fft` (``planner="measure"``
    consults/extends wisdom); beyond ``capacity`` the least-recently-used
    plan is evicted. ``warm_from_wisdom`` pre-populates the pool from a
    wisdom file so serving starts hot. Works on a ``SimMesh`` and on a
    ``ProcessGroupMesh`` (where every rank builds the same plans)."""

    def __init__(
        self,
        mesh,
        *,
        capacity: int = 32,
        planner: str = "estimate",
        plan_kwargs: Optional[dict] = None,
        faults=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.mesh = mesh
        self.capacity = capacity
        self.planner = planner
        #: optional FaultPlan installed on every plan the pool hands out
        #: (chaos testing); see :meth:`set_faults`
        self.faults = faults
        self.plan_kwargs = dict(plan_kwargs or {})
        self.decomp = self.plan_kwargs.get("decomp", "slab")
        self._plans: "collections.OrderedDict[str, object]" = collections.OrderedDict()
        #: key -> stage-schedule content hash of the cached plan's planned
        #: direction (Plan.schedule_hash()), beside the frozen key format
        self._schedule_hashes: Dict[str, str] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.plan_seconds = 0.0  # time spent planning on the request path
        self.warm_seconds = 0.0  # time spent planning/running at warm start
        #: decision provenance tally: Plan.selection_channel -> count
        self.channels: Dict[str, int] = {}

    # -- identity ---------------------------------------------------------
    def shards(self) -> int:
        """Shard count plans from this pool run over (P of the key)."""
        if self.decomp == "pencil":
            return grid_from_mesh(
                self.mesh, self.plan_kwargs.get("row_axis"), self.plan_kwargs.get("col_axis")
            ).size
        ax = self.plan_kwargs.get("axis_name") or fft_axis(self.mesh)
        return self.mesh.shape[ax]

    def key(self, shape, ndim: int, dtype, real: bool) -> str:
        return plan_key(shape, ndim, dtype, self.shards(), self.decomp, real)

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: str) -> bool:
        return key in self._plans

    def keys(self):
        return list(self._plans)

    # -- core -------------------------------------------------------------
    def _build(self, shape, ndim, dtype, real, backend: Optional[str] = None):
        kwargs = dict(self.plan_kwargs)
        if backend is not None:
            kwargs["backend"] = backend
            kwargs.pop("planner", None)
        else:
            kwargs.setdefault("planner", self.planner)
        return plan_fft(tuple(shape), self.mesh, ndim=ndim, dtype=dtype, real=real, **kwargs)

    def _insert(self, key: str, plan) -> None:
        if self.faults is not None:
            plan.faults = self.faults
        self._plans[key] = plan
        self._plans.move_to_end(key)
        self._schedule_hashes[key] = plan.schedule_hash()
        ch = getattr(plan, "selection_channel", "pinned")
        self.channels[ch] = self.channels.get(ch, 0) + 1
        while len(self._plans) > self.capacity:
            evicted, _ = self._plans.popitem(last=False)
            self._schedule_hashes.pop(evicted, None)
            self.evictions += 1

    def set_faults(self, faults) -> None:
        """Install (or clear, with ``None``) a fault plan on the pool
        AND retrofit it onto every already-warm plan -- warm first, then
        arm chaos, so warm-up itself is never poisoned."""
        self.faults = faults
        for plan in self._plans.values():
            plan.faults = faults

    def invalidate(self) -> None:
        """Drop every cached plan. Hit/miss history and provenance
        tallies are kept -- this is the 'plans are stale' path, not a
        telemetry reset."""
        self._plans.clear()
        self._schedule_hashes.clear()

    def remesh(self, mesh) -> None:
        """Point the pool at a new mesh (elastic re-scale after device
        loss): cached plans bake the old mesh and P, so they are all
        invalidated; re-warm from wisdom at the new P next."""
        self.invalidate()
        self.mesh = mesh

    def schedule_hash(self, key: str) -> Optional[str]:
        """Stage-schedule hash of the pooled plan under ``key`` (None
        when the key is cold/evicted)."""
        return self._schedule_hashes.get(key)

    def schedule_hashes(self) -> Dict[str, str]:
        """Snapshot of key -> schedule hash for every warm plan. Equal
        hashes mean the pool would execute the identical stage pipeline
        for those keys."""
        return dict(self._schedule_hashes)

    def get(self, shape, ndim: int, dtype, real: bool):
        """(plan, hit): the cached plan for this problem, planning (and
        counting a miss) when cold."""
        key = self.key(shape, ndim, dtype, real)
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            self.hits += 1
            return plan, True
        self.misses += 1
        t0 = time.perf_counter()
        plan = self._build(shape, ndim, dtype, real)
        self.plan_seconds += time.perf_counter() - t0
        self._insert(key, plan)
        return plan, False

    # -- warm start -------------------------------------------------------
    def warm(
        self,
        shape,
        ndim: int,
        dtype,
        real: bool,
        *,
        backend: Optional[str] = None,
        compile: bool = True,
    ):
        """Pre-plan one problem into the pool (pinning ``backend`` when
        given -- e.g. a wisdom entry's recorded winner, variant id
        included) and, with ``compile``, run zeros through both
        directions on the mesh's device (the caller's shape: the global
        array on a SimMesh, the rank's block on a ProcessGroupMesh), so
        the first real request pays neither ``plan_fft`` nor a first
        launch."""
        key = self.key(shape, ndim, dtype, real)
        plan = self._plans.get(key)
        t0 = time.perf_counter()
        if plan is None:
            plan = self._build(shape, ndim, dtype, real, backend=backend)
            self._insert(key, plan)
        if compile:
            spec = plan.input_spec()
            x = torch.zeros(self.mesh.caller_shape(spec.shape, spec.tail), dtype=spec.dtype,
                            device=self.mesh.device)
            y = plan.execute(x)
            if plan.ndim > 1:  # 1-D large has no inverse
                plan.inverse(y)
            if self.mesh.device.type == "cuda":
                torch.cuda.synchronize(self.mesh.device)
        self.warm_seconds += time.perf_counter() - t0
        return plan

    def warm_from_wisdom(self, source: Optional[str] = None, *, compile: bool = True) -> int:
        """Import ``source`` (path or JSON text; None = use wisdom
        already in process) and pre-plan every entry matching this
        pool's mesh, decomposition, local impl and device kind, pinned to
        the recorded winning backend. Returns the number of plans warmed;
        unparseable or mismatched entries are skipped (wisdom stays
        advisory)."""
        if source is not None:
            _planner.import_wisdom(source)
        dev = _planner.device_kind(self.mesh)
        p = self.shards()
        warmed = 0
        for key, entry in _planner.wisdom_items():
            info = _planner.parse_wisdom_key(key)
            if info is None or info["dev"] != dev or info["p"] != p:
                continue
            if info["decomp"] != self.decomp or info["direction"] != "forward":
                continue
            if info["local_impl"] != self.plan_kwargs.get("local_impl", "torch"):
                continue
            if info["fuse_dft"] or info["transpose_back"] or info["pipeline"]:
                continue
            dtype = getattr(torch, info["dtype"], None)
            if not isinstance(dtype, torch.dtype):
                continue
            if self.key(info["shape"], info["ndim"], dtype, info["real"]) in self:
                continue
            backend = entry.get("backend") if isinstance(entry, dict) else None
            try:
                self.warm(info["shape"], info["ndim"], dtype, info["real"], backend=backend, compile=compile)
            except (ValueError, NotImplementedError, TypeError):
                continue  # foreign entry (other mesh axes, stale backend)
            warmed += 1
        return warmed

    def stats(self) -> Dict[str, float]:
        return {
            "plans": len(self._plans),
            "distinct_schedules": len(set(self._schedule_hashes.values())),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "plan_seconds": self.plan_seconds,
            "warm_seconds": self.warm_seconds,
            "channels": dict(self.channels),
        }


# ---------------------------------------------------------------------------
# Requests / futures
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpectralRequest:
    op: str
    operands: Tuple
    ndim: int
    real: bool
    lengths: Optional[Tuple[float, ...]]
    submit_t: float

    @property
    def shape(self):
        return tuple(self.operands[0].shape)


class SpectralFuture:
    """Per-request handle. ``result()`` returns the (possibly still
    in-flight) output, forcing dispatch of a still-queued request by
    polling the engine at its admission deadline -- it never waits
    longer than the queue's max-wait. ``block()`` additionally waits for
    the device (its own batch's CUDA event) and records the request's
    end-to-end latency into the engine's telemetry window.

    A request that failed every retry is *quarantined*: its future
    carries the recorded exception in ``error`` and both ``result()``
    and ``block()`` re-raise it -- the failure is isolated to this
    handle; coalesced siblings resolve normally.

    On a process group the value is the rank's own block of the output,
    and forcing a still-queued request's dispatch is collective: every
    rank calls ``result()`` / ``block()`` on the same request."""

    def __init__(self, engine: "SpectralEngine", request: SpectralRequest):
        self._engine = engine
        self.request = request
        self._value = None
        self._event: Optional[torch.cuda.Event] = None
        self._dispatched = False
        self._recorded = False
        self.dispatch_t: Optional[float] = None
        self.batch_size: Optional[int] = None
        self.pool_hit: Optional[bool] = None
        self.backend: Optional[str] = None
        self.degraded: Optional[bool] = None
        self.error: Optional[BaseException] = None

    def _resolve(self, value, *, event, dispatch_t, batch_size, pool_hit, backend, degraded=False) -> None:
        self._value = value
        self._event = event
        self._dispatched = True
        self.dispatch_t = dispatch_t
        self.batch_size = batch_size
        self.pool_hit = pool_hit
        self.backend = backend
        self.degraded = degraded

    def _reject(self, error: BaseException, *, dispatch_t) -> None:
        self.error = error
        self._dispatched = True
        self.dispatch_t = dispatch_t
        self.batch_size = 1  # quarantined requests always ran solo last

    def done(self) -> bool:
        """Dispatched (output possibly still in flight on device)."""
        return self._dispatched

    def failed(self) -> bool:
        """Quarantined: every attempt (batch, solo retries) failed."""
        return self.error is not None

    def result(self):
        while not self._dispatched:
            self._engine._force_dispatch()
        if self.error is not None:
            raise self.error
        return self._value

    def block(self):
        while not self._dispatched:
            self._engine._force_dispatch()
        if self.error is not None:
            if not self._recorded:
                self._recorded = True
                self._engine._record_completion(self, failed=True)
            raise self.error
        if self._event is not None:
            self._event.synchronize()
        if not self._recorded:
            self._recorded = True
            self._engine._record_completion(self)
        return self._value


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class StreamMismatch(RuntimeError):
    """The ranks of a process group reached an engine decision with
    different request streams (another decision point, request count or
    request key); every rank raises the same one."""


#: The host decisions the ranks agree on; an agreement carries its
#: point's index, so ranks at different points raise instead of mixing
#: answers.
_DECISIONS = ("submit", "poll", "flush", "force", "retry", "breaker")


class SpectralEngine:
    """Queue -> coalescer -> plan pool -> async dispatch.

    Single-threaded and cooperative: callers ``submit`` (full batches
    dispatch inline), the caller's loop ``poll``\\ s to flush
    partially-filled batches past their max-wait, and ``drain()``
    flushes + blocks everything. The engine never waits on a batch it
    launched; on the card the batches queue on the current stream.
    """

    def __init__(
        self,
        mesh,
        *,
        max_batch: int = 8,
        max_wait_s: float = 0.002,
        coalesce: bool = True,
        capacity: int = 32,
        planner: str = "estimate",
        plan_kwargs: Optional[dict] = None,
        wisdom: Optional[str] = None,
        warm_compile: bool = True,
        clock: Callable[[], float] = time.monotonic,
        window: int = 2048,
        faults=None,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.mesh = mesh
        self.max_batch = max_batch
        self.coalesce = coalesce
        self._clock = clock
        self.pool = PlanPool(mesh, capacity=capacity, planner=planner, plan_kwargs=plan_kwargs)
        self.queue = CoalescingQueue(
            Admission(max_batch=max_batch, max_wait_s=max_wait_s),
            coalesce=coalesce,
            clock=clock,
        )
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker(clock=clock)
        self.faults = None
        #: pool_key -> xla_auto plan, the degradation target a tripped
        #: breaker routes that key's traffic through
        self._degraded: Dict[str, object] = {}
        self._window_len = window
        self.reset_stats()
        self._outstanding: List[SpectralFuture] = []
        #: (key, future) of the submissions since the last agreement (process group)
        self._unadmitted: List[Tuple[tuple, SpectralFuture]] = []
        if wisdom is not None:
            self.warm_start(wisdom, compile=warm_compile)
        if faults is not None:
            # armed AFTER any warm start so warm-up is never poisoned
            self.set_faults(faults)

    def reset_stats(self) -> None:
        """Zero the telemetry windows and counters (the plan pool and
        its hit/miss history are kept) -- e.g. between benchmark
        measurement windows."""
        w = self._window_len
        self.latency = LatencyWindow(w)  # submit -> device-done (blocked)
        self.queue_wait = LatencyWindow(w)  # submit -> dispatch
        self.queue_depth = LatencyWindow(w)  # sampled at each submit
        self.batch_sizes = LatencyWindow(w)
        # host-side dispatch breakdown, one window per stage: plan-pool
        # lookup / operand stack+pad on the device / launch
        self.stage_windows: Dict[str, LatencyWindow] = {
            name: LatencyWindow(w) for name in ("pool", "stack", "execute")
        }
        # straggler detection over dispatches; flagged dispatches name
        # the slowest stage above as their culprit
        self.dispatch_monitor = StepMonitor(history_limit=w)
        self.requests = 0
        self.batches = 0
        self.padded = 0  # zero-pad rows added to fill buckets
        # fault-tolerance counters, injected faults only (module docstring)
        self.errors = 0  # failed batch executions, retries included
        self.retries = 0  # solo re-attempts under the retry policy
        self.batch_splits = 0  # poisoned batches split into solo retries
        self.quarantined = 0  # requests that exhausted every attempt
        self.failed_requests = 0  # quarantined futures observed via block()
        self.degraded_dispatches = 0  # dispatches routed to xla_auto
        # host agreements on a process group (mesh.host_max) and their host seconds
        self.agreements = 0
        self.agreement_s = 0.0

    # -- warm start -------------------------------------------------------
    def warm_start(self, source: Optional[str] = None, *, compile: bool = True) -> int:
        """Pre-plan every wisdom entry matching this mesh (see
        :meth:`PlanPool.warm_from_wisdom`), for each hot shape warming
        all power-of-two batch buckets the coalescer can produce."""
        warmed = self.pool.warm_from_wisdom(source, compile=compile)
        # wisdom shapes are batched global shapes; extend each to the
        # full bucket ladder so partial batches of the same shape are
        # warm too (a (8, n, n) entry warms (1|2|4, n, n) as well)
        for key in self.pool.keys():
            plan = self.pool._plans[key]
            shape = plan.global_shape
            if len(shape) <= plan.ndim or shape[0] not in self._buckets():
                continue
            for bucket in self._buckets():
                if bucket == shape[0]:
                    continue
                try:
                    self.pool.warm(
                        (bucket,) + shape[1:], plan.ndim, plan.dtype, plan.real,
                        backend=plan.backend, compile=compile,
                    )
                    warmed += 1
                except (ValueError, NotImplementedError):
                    continue
        return warmed

    # -- fault tolerance --------------------------------------------------
    def set_faults(self, faults) -> None:
        """Arm (or, with ``None``, disarm) a
        :class:`repro_torch.runtime.faults.FaultPlan` on every plan the
        engine executes -- pooled, future, and degraded alike. Call after
        warming so warm-up itself is never poisoned; which stages fire
        is the plan's ``match`` business (the ``xla_auto`` degradation
        path runs under a ``global:<kind>`` label, so ``match="Exchange"``
        chaos leaves it healthy)."""
        self.faults = faults
        self.pool.set_faults(faults)
        for plan in self._degraded.values():
            plan.faults = faults

    def remesh(self, mesh, *, wisdom: Optional[str] = None, warm: bool = True,
               compile: bool = True) -> int:
        """Elastic re-scale: point the engine at a new (typically
        smaller, post-device-loss) mesh. Flushes anything queued against
        the old mesh, invalidates every pooled plan, drops the
        degraded-plan cache, resets the circuit breaker (its keys embed
        the old P), and -- with ``warm`` -- re-warms the pool from
        wisdom at the new P. Returns the number of plans warmed. On a
        process group the flush is collective over the old group, so
        call it on every old rank or drain first: with nothing queued,
        the survivors alone remesh."""
        if self.queue.depth() or self._unadmitted:
            self.flush()
        self.mesh = mesh
        self.pool.remesh(mesh)
        self._degraded.clear()
        self.breaker.reset()
        if warm:
            return self.warm_start(wisdom, compile=compile)
        return 0

    def _buckets(self) -> List[int]:
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        out.append(self.max_batch)
        return out

    def _bucket(self, k: int) -> int:
        b = 1
        while b < k:
            b <<= 1
        return min(b, self.max_batch)

    # -- submission -------------------------------------------------------
    def submit(
        self,
        op: str,
        x,
        y=None,
        *,
        ndim: int = 2,
        lengths: Optional[Sequence[float]] = None,
    ) -> SpectralFuture:
        """Enqueue one request (a tensor or array-like, on any device:
        the batch is stacked on the mesh's device); returns its future
        immediately. Any coalesced batch the submission completes
        dispatches inline (no blocking); partially-filled batches wait
        for more same-key requests or the admission max-wait (see
        :meth:`poll`)."""
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; serving ops: {sorted(_OPS)}")
        fn, arity = _OPS[op]
        if ndim not in (2, 3):
            raise ValueError(f"serving covers ndim 2 or 3, got {ndim}")
        x = torch.as_tensor(x)
        if x.ndim < ndim:
            raise ValueError(f"op {op!r} input rank {x.ndim} < ndim={ndim}")
        real = x.is_floating_point()
        if op == "rfft" and not real:
            raise ValueError(f"rfft takes a real input, got dtype {_dtype_name(x.dtype)} (use op='fft')")
        if op == "ifft" and real:
            raise ValueError(
                "ifft consumes a c2c spectrum (complex); real inverse "
                "transforms round-trip through the same future's plan"
            )
        operands = (x,)
        if arity == 2:
            if y is None:
                raise ValueError(f"op {op!r} takes two operands (pass y=)")
            y = torch.as_tensor(y)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(
                    f"op {op!r} operands must match: {tuple(x.shape)}/{_dtype_name(x.dtype)} "
                    f"vs {tuple(y.shape)}/{_dtype_name(y.dtype)}"
                )
            operands = (x, y)
        elif y is not None:
            raise ValueError(f"op {op!r} takes one operand")
        lengths = None if lengths is None else tuple(float(v) for v in lengths)
        shape = tuple(x.shape)
        if self.mesh.caller_holds_block:  # a rank's block: the key holds the global shape
            shape = self.mesh.global_shape(shape, self._operand_tail(op, ndim))
        key = (op, shape, _dtype_name(x.dtype), ndim, real, lengths)
        now = self._clock()
        req = SpectralRequest(op, operands, ndim, real, lengths, now)
        fut = SpectralFuture(self, req)
        self.requests += 1
        self._outstanding.append(fut)
        if self.mesh.caller_holds_block:
            self._unadmitted.append((key, fut))
            self.queue_depth.record(self.queue.depth() + len(self._unadmitted))
            full = self.max_batch if self.coalesce else 1
            if self.queue.size(key) + sum(k == key for k, _ in self._unadmitted) >= full:
                self._dispatch_batches(self.queue.ready(self._agree("submit", now)))
            return fut
        self.queue.push(key, fut, now=now)
        self.queue_depth.record(self.queue.depth())
        self._dispatch_batches(self.queue.ready(now))  # full batches only
        return fut

    # -- agreement (process group) ----------------------------------------
    def _agree(self, decision: str, t: float) -> float:
        """The largest of the ranks' times ``t`` for one host
        ``decision``, in one ``mesh.host_max`` that also carries the
        decision point, this rank's request count and a checksum of the
        keys submitted since the last agreement; raises
        :class:`StreamMismatch` on every rank when any of those differ
        between ranks (dropping those submissions). Otherwise admits them
        into the queue at the agreed time, which it returns."""
        point = _DECISIONS.index(decision) + 1
        seq = self.requests
        unadmitted, self._unadmitted = self._unadmitted, []
        crc = zlib.crc32(repr([key for key, _ in unadmitted]).encode())
        t0 = time.perf_counter()
        hi_point, lo_point, hi_seq, lo_seq, hi_crc, lo_crc, agreed = self.mesh.host_max(
            [point, -point, seq, -seq, crc, -crc, t])
        self.agreement_s += time.perf_counter() - t0
        self.agreements += 1
        if (hi_point, hi_seq, hi_crc) != (-lo_point, -lo_seq, -lo_crc):
            points = sorted({_DECISIONS[int(hi_point) - 1], _DECISIONS[int(-lo_point) - 1]})
            raise StreamMismatch(
                f"the ranks' request streams differ: decision points {points}, request counts "
                f"{int(-lo_seq)}..{int(hi_seq)}, key checksums {int(-lo_crc)}..{int(hi_crc)}; every rank "
                "must submit the same op, dtype, global shape, ndim and lengths in the same order"
            )
        for key, fut in unadmitted:
            self.queue.push(key, fut, now=agreed)
        return agreed

    def _decision_time(self, decision: str) -> float:
        """The engine's clock for a host decision: agreed over the ranks
        on a process group."""
        now = self._clock()
        return self._agree(decision, now) if self.mesh.caller_holds_block else now

    def _breaker_time(self, key) -> Optional[float]:
        """The time ``breaker.allow(key)`` decides by: the breaker's own
        clock on a SimMesh (None: it reads it) or where the key is not
        open (no time is read); agreed over the ranks otherwise."""
        if not self.mesh.caller_holds_block or self.breaker.state(key) != "open":
            return None
        return self._agree("breaker", self.breaker.clock())

    def _operand_tail(self, op: str, ndim: int) -> Tuple[Optional[str], ...]:
        """Trailing partition spec of a request's operand: the data
        side's (``input_spec().tail``), or for ``ifft`` the spectrum's in
        the forward output's layout (see :meth:`_plan_shape`)."""
        kw = self.pool.plan_kwargs
        if self.pool.decomp == "pencil":
            grid = grid_from_mesh(self.mesh, kw.get("row_axis"), kw.get("col_axis"))
            row, col = grid.row_axis, grid.col_axis
            if op == "ifft" and ndim == 3 and not kw.get("transpose_back", False):
                row, col = col, row
            return (row, col) + (None,) * (ndim - 2)
        return (kw.get("axis_name") or fft_axis(self.mesh),) + (None,) * (ndim - 1)

    # -- pumping ----------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> int:
        """Dispatch every batch the admission policy has made ready
        (full batches plus max-wait-expired partials); returns the
        number of batches dispatched. On a process group the ranks'
        ``now`` (default: their clocks) is agreed."""
        if self.mesh.caller_holds_block:
            now = self._agree("poll", self._clock() if now is None else now)
        return self._dispatch_batches(self.queue.ready(now))

    def flush(self) -> int:
        """Dispatch everything queued, policy or not (on a process group,
        after an agreement that admits what was submitted since the
        last one)."""
        if self.mesh.caller_holds_block:
            self._agree("flush", self._clock())
        return self._dispatch_batches(self.queue.flush())

    def drain(self, *, raise_errors: bool = False) -> None:
        """Flush the queue and block until every outstanding request's
        output is on device (recording latencies, in submission order).
        Quarantined futures do not abort the drain: their failures are
        counted (``failed_requests``) and, with ``raise_errors``, the
        first one re-raises after every sibling has been blocked."""
        self.flush()
        first: Optional[BaseException] = None
        for fut in list(self._outstanding):
            try:
                fut.block()
            except InjectedFault as e:  # a quarantined future: keep draining siblings
                if first is None:
                    first = e
        if first is not None and raise_errors:
            raise first

    def _force_dispatch(self) -> None:
        """A caller is blocked on a queued future: advance the clock to
        the queue's admission deadline (the max-wait flush that would
        happen anyway) instead of sleeping for it. On a process group
        the ranks agree on ``now`` and dispatch together."""
        now = self._decision_time("force")
        deadline = self.queue.next_deadline(now)
        if deadline is None or not self._dispatch_batches(self.queue.ready(max(now, deadline))):
            self.flush()  # defensive: never spin on a stuck queue

    # -- dispatch ---------------------------------------------------------
    def _plan_shape(self, op: str, shape: Tuple[int, ...], ndim: int) -> Tuple[int, ...]:
        """The *planned* (data-side) shape behind a request's global
        shape: identical to it except for ``ifft``, whose input is a spectrum
        in the plan's own forward-output layout -- slab fft2 without
        transpose_back is transposed, pencil fft3 without transpose_back
        is axis-reversed -- so the trailing dims map back accordingly.
        (``decomp="auto"`` pools are treated as slab here; pin the
        decomposition when serving non-square inverse traffic.)"""
        if op != "ifft":
            return shape
        trail = shape[-ndim:]
        tb = self.pool.plan_kwargs.get("transpose_back", False)
        if self.pool.decomp == "pencil":
            if ndim == 3 and not tb:
                trail = trail[::-1]
        elif ndim == 2 and not tb:
            trail = (trail[1], trail[0])
        return shape[:-ndim] + trail

    def _dispatch_batches(self, batches) -> int:
        for key, futs in batches:
            self._dispatch(key, futs)
        return len(batches)

    def _dispatch(self, key, futs: List[SpectralFuture]) -> None:
        """Failure-isolation wrapper around :meth:`_execute_batch`: a
        batch that raises an injected fault is split into solo dispatches
        (one poisoned request must not take its coalesced siblings
        down); a solo request that raises one is retried under the
        engine's :class:`RetryPolicy` budget and finally quarantined --
        its future records the error. Any other exception propagates."""
        try:
            self._execute_batch(key, futs)
            return
        except InjectedFault as e:  # per-request isolation boundary
            self.errors += 1
            err = e
        if len(futs) > 1:
            self.batch_splits += 1
            for fut in futs:
                self._dispatch(key, [fut])
            return
        t0 = self._decision_time("retry")
        attempt = 0
        while attempt < self.retry.max_retries and self._decision_time("retry") - t0 <= self.retry.deadline_s:
            attempt += 1
            self.retries += 1
            try:
                self._execute_batch(key, futs)
                return
            except InjectedFault as e:
                self.errors += 1
                err = e
        self.quarantined += 1
        now = self._clock()
        futs[0]._reject(err, dispatch_t=now)
        self.queue_wait.record(now - futs[0].request.submit_t)

    def _degraded_plan(self, pool_key: str, shape, ndim, dtype, real):
        """The ``xla_auto`` plan (one library transform of the gathered
        global array) a tripped breaker degrades ``pool_key``'s traffic
        to -- cached outside the LRU pool so degradation never evicts
        healthy plans."""
        plan = self._degraded.get(pool_key)
        if plan is None:
            plan = self.pool._build(shape, ndim, dtype, real, backend="xla_auto")
            if self.faults is not None:
                plan.faults = self.faults
            self._degraded[pool_key] = plan
        return plan

    def _execute_batch(self, key, futs: List[SpectralFuture]) -> None:
        op = key[0]
        fn, arity = _OPS[op]
        req0 = futs[0].request
        shape, ndim, real, lengths = key[1], req0.ndim, req0.real, req0.lengths
        k = len(futs)
        bucket = self._bucket(k)
        self.dispatch_monitor.start()
        t0 = self._clock()
        plan_shape = (bucket,) + self._plan_shape(op, shape, ndim)
        dtype = req0.operands[0].dtype
        plan, hit = self.pool.get(plan_shape, ndim, dtype, real)
        if self.mesh.caller_holds_block and plan.input_spec(opposite=op == "ifft").tail != self._operand_tail(op, ndim):
            raise ValueError(f"the {plan.decomp} plan's operand layout is not the one the blocks were "
                             f"submitted in; pin decomp= in plan_kwargs to serve {op} on a process group")
        pool_key = self.pool.key(plan_shape, ndim, dtype, real)
        bkey = (plan.backend, pool_key)
        degraded = False
        if not self.breaker.allow(bkey, now=self._breaker_time(bkey)):
            plan = self._degraded_plan(pool_key, plan_shape, ndim, dtype, real)
            self.degraded_dispatches += 1
            degraded = True
        t_pool = self._clock()
        stacked = []
        for j in range(arity):
            ops = [self.mesh.place(f.request.operands[j]) for f in futs]
            if bucket > k:
                ops += [torch.zeros_like(ops[0])] * (bucket - k)
            stacked.append(torch.stack(ops))
        t_stack = self._clock()
        try:
            out = fn(plan, tuple(stacked), lengths)  # queued launches, not device time
        except InjectedFault:
            # only the primary plan feeds the breaker -- a failing degraded
            # dispatch must not re-open a breaker that already tripped
            if not degraded:
                agreed = self._agree("breaker", self.breaker.clock()) if self.mesh.caller_holds_block else None
                self.breaker.record_failure(bkey, now=agreed)
            raise
        event = None
        if self.mesh.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.mesh.device))
        if not degraded:
            self.breaker.record_success(bkey)
        self.padded += bucket - k
        now = self._clock()
        spans = [("pool", t_pool - t0), ("stack", t_stack - t_pool), ("execute", now - t_stack)]
        for name, dt in spans:
            self.stage_windows[name].record(dt)
        self.dispatch_monitor.stop(tokens=k, spans=spans)
        self.batches += 1
        self.batch_sizes.record(k)
        for i, fut in enumerate(futs):
            value = tuple(o[i] for o in out) if isinstance(out, tuple) else out[i]
            fut._resolve(value, event=event, dispatch_t=now, batch_size=k, pool_hit=hit,
                         backend=plan.backend, degraded=degraded)
            self.queue_wait.record(now - fut.request.submit_t)

    # -- telemetry --------------------------------------------------------
    def _record_completion(self, fut: SpectralFuture, *, failed: bool = False) -> None:
        if failed:
            self.failed_requests += 1
        else:
            self.latency.record(self._clock() - fut.request.submit_t)
        try:
            self._outstanding.remove(fut)
        except ValueError:
            pass

    def stats(self) -> dict:
        """Serving telemetry snapshot: request latency percentiles (over
        blocked completions), queue wait/depth, coalescing factor,
        dispatch stages, plan-pool counters and the fault counters."""
        dispatched = int(self.batch_sizes.total)
        return {
            "requests": self.requests,
            "completed": self.latency.count,
            "batches": self.batches,
            "mean_batch": (dispatched / self.batches) if self.batches else 0.0,
            "padded": self.padded,
            "latency_s": self.latency.summary((50, 90, 99)),
            "queue_wait_s": self.queue_wait.summary((50, 90, 99)),
            "queue_depth": self.queue_depth.summary((50, 99)),
            "stages_s": {name: w.summary((50, 99)) for name, w in self.stage_windows.items()},
            "dispatch": self.dispatch_monitor.straggler_report(),
            "pool": self.pool.stats(),
            "agreements": {
                "count": self.agreements,
                "host_s": self.agreement_s,
                "per_dispatch": (self.agreements / self.batches) if self.batches else 0.0,
            },
            "faults": {
                "errors": self.errors,
                "retries": self.retries,
                "batch_splits": self.batch_splits,
                "quarantined": self.quarantined,
                "failed_requests": self.failed_requests,
                "degraded_dispatches": self.degraded_dispatches,
                "breaker": self.breaker.stats(),
            },
        }

    def metrics(self) -> dict:
        """Flat scalar gauge/counter mapping for scraping (one number
        per key): live queue depth, request/batch counters, latency and
        queue-wait percentiles, per-dispatch-stage p50s, plan-pool
        counters, the dispatch straggler telemetry
        (``dispatch_culprit_<stage>``), planner provenance
        (``plan_channel_<channel>``, ``wisdom_stale``), and the fault
        counters -- ``errors`` / ``retries`` / ``batch_splits`` /
        ``quarantined`` / ``failed_requests`` count injected faults only,
        ``degraded_dispatches`` the dispatches routed to ``xla_auto``,
        and ``breaker_<name>`` the breaker's states and transitions."""
        pool = self.pool.stats()
        lat = self.latency.percentiles((50, 99))
        wait = self.queue_wait.percentiles((50, 99))
        report = self.dispatch_monitor.straggler_report()
        out = {
            "requests": self.requests,
            "completed": self.latency.count,
            "batches": self.batches,
            "padded": self.padded,
            "queue_depth": self.queue.depth() + len(self._unadmitted),
            "queue_depth_p99": self.queue_depth.percentiles((99,))["p99"],
            "latency_p50_s": lat["p50"],
            "latency_p99_s": lat["p99"],
            "queue_wait_p50_s": wait["p50"],
            "queue_wait_p99_s": wait["p99"],
            "pool_hits": pool["hits"],
            "pool_misses": pool["misses"],
            "pool_evictions": pool["evictions"],
            "dispatch_steps": report["steps"],
            "dispatch_flagged": report["flagged"],
        }
        for name, w in self.stage_windows.items():
            out[f"dispatch_{name}_p50_s"] = w.percentiles((50,))["p50"]
        for name, count in report["culprits"].items():
            out[f"dispatch_culprit_{name}"] = count
        for name, count in sorted(pool["channels"].items()):
            out[f"plan_channel_{name.replace('-', '_')}"] = count
        out["wisdom_stale"] = sum(1 for row in _planner.wisdom_report() if row["stale"])
        out["errors"] = self.errors
        out["retries"] = self.retries
        out["batch_splits"] = self.batch_splits
        out["quarantined"] = self.quarantined
        out["failed_requests"] = self.failed_requests
        out["degraded_dispatches"] = self.degraded_dispatches
        out["agreements"] = self.agreements
        out["agreement_s"] = self.agreement_s
        for name, v in self.breaker.stats().items():
            out[f"breaker_{name}"] = v
        return out
