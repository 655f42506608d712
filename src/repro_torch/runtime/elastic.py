"""Failure recovery + elastic re-scale orchestration, ported from
``repro.runtime.elastic``.

``run_with_recovery`` wraps a loop in the restart contract: on any
failure (device loss, preemption, injected fault) the loop restores the
latest checkpoint and resumes, up to ``max_restarts``. Because
checkpoints hold full logical arrays (:mod:`repro_torch.checkpoint`),
a restart may come back on a *different* rank count -- ``elastic_mesh``
builds the largest valid mesh for whatever is alive (shrink it
explicitly with ``max_devices`` / ``devices`` when chaos tests simulate
rank loss).

Restart pacing is capped exponential backoff with deterministic jitter:
``backoff_s * 2**(restart-1)`` up to ``backoff_cap_s``, scaled by a
``seed``-ed jitter factor so a thundering herd of restarts de-correlates
*reproducibly*. ``sleep`` is injectable, so tests assert the exact delay
sequence without waiting for it. The loop function receives ``None`` on
the first run and an explicit :class:`Resume` value afterwards: the
restart ordinal, the failure that caused it, and the step to resume
from (``None`` = restore the latest checkpoint).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import random
import time
from typing import Callable, List, Optional

from repro_torch.core.mesh import DEFAULT_TIMEOUT_S, ProcessGroupMesh, SimMesh, ring_axes

log = logging.getLogger("repro_torch.runtime")

#: Ranks a single process simulates when ``elastic_mesh`` is given no
#: ``devices``: the reference's multi-device tests force 8 host devices.
SIM_DEVICES = 8


class SimulatedFailure(RuntimeError):
    """Raised by tests / chaos hooks to simulate node loss."""


class FailureInjector:
    """Raises :class:`SimulatedFailure` on a repeatable step schedule.

    ``FailureInjector(k)`` fires once at step ``k``; ``every=n`` extends
    the schedule to ``{k, k+n, k+2n, ...}``, capped at ``times`` total
    firings (None = unlimited). The schedule is pure arithmetic on the
    step counter, so a chaos run replays identically (and every rank of
    a process group fires at the same step); :attr:`fired_steps` records
    each firing."""

    def __init__(
        self,
        at_step: Optional[int] = None,
        *,
        every: Optional[int] = None,
        times: Optional[int] = 1,
    ):
        self.at_step = at_step
        self.every = every
        self.times = times
        self.fired_steps: List[int] = []

    @property
    def fired(self) -> bool:
        return bool(self.fired_steps)

    def scheduled(self, step: int) -> bool:
        """Whether ``maybe_fail(step)`` would raise."""
        if self.at_step is None or step < self.at_step:
            return False
        if self.times is not None and len(self.fired_steps) >= self.times:
            return False
        if step == self.at_step:
            return True
        return self.every is not None and (step - self.at_step) % self.every == 0

    def maybe_fail(self, step: int):
        if self.scheduled(step):
            self.fired_steps.append(step)
            raise SimulatedFailure(f"injected failure at step {step}")


def elastic_mesh(
    axis_names=("data", "model"),
    *,
    model_parallel: int = 1,
    devices=None,
    max_devices: Optional[int] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
):
    """Build the largest mesh available right now (a restart may see
    fewer ranks). ``model_parallel`` is fixed by the checkpointed layout;
    the first axis absorbs whatever ranks remain (ranks that do not fill
    a whole model-parallel group are dropped). ``devices`` pins an
    explicit alive list and ``max_devices`` keeps its first ones -- the
    knobs chaos tests use to simulate rank loss.

    - One process: a :class:`SimMesh` of the alive count
      (``devices`` defaults to :data:`SIM_DEVICES` simulated ranks), one
      axis or ``(n // model_parallel, model_parallel)`` named
      ``axis_names``, on ``device`` (``None``: the card).
    - Under ``torch.distributed``: ``devices`` lists global ranks
      (default: all of them). Every rank of the job must call this
      function, the non-survivors too, because ``dist.new_group`` (the
      survivors' group, and on two axes each ring's) is collective over
      the whole job; a survivor gets a :class:`ProcessGroupMesh` on the
      new group, a non-survivor ``None``.
    """
    import torch.distributed as dist

    distributed = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = range(dist.get_world_size() if distributed else SIM_DEVICES)
    devs = list(devices)
    if max_devices is not None:
        devs = devs[:max_devices]
    n = len(devs) - (len(devs) % model_parallel)
    if n < model_parallel:
        raise ValueError(
            f"{len(devs)} alive devices cannot fill one "
            f"model_parallel={model_parallel} group"
        )
    devs = devs[:n]
    names = tuple(axis_names)
    if len(names) == 1:
        if model_parallel != 1:
            raise ValueError("model_parallel needs a second mesh axis")
        grid = None
    else:
        grid = (n // model_parallel, model_parallel)
    if not distributed:
        if grid is None:
            return SimMesh(n, names[0], device)
        return SimMesh(grid, device=device, axis_names=names)
    group = dist.new_group(devs, timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_rank() in devs:
        return ProcessGroupMesh(names[0], device, group, grid=grid,
                                axis_names=None if grid is None else names, timeout_s=timeout_s)
    if grid is not None:
        # the survivors' ProcessGroupMesh makes one group per ring of each
        # axis (rings of one rank need none); join each creation in order
        layout = SimMesh(grid, device="cpu", axis_names=names)
        for axes in ring_axes(names):
            for ring in layout.ring_ranks(axes):
                if len(ring) > 1:
                    dist.new_group([devs[r] for r in ring], timeout=datetime.timedelta(seconds=timeout_s))
    return None


@dataclasses.dataclass(frozen=True)
class Resume:
    """Explicit restart token handed to the recovery loop's ``loop_fn``
    (first run gets ``None``). ``step=None`` means 'restore the latest
    checkpoint'."""

    restarts: int
    cause: str = ""
    step: Optional[int] = None


def backoff_delay(
    restart: int,
    base_s: float,
    *,
    cap_s: float = 30.0,
    jitter: float = 0.25,
    rng: Optional[random.Random] = None,
) -> float:
    """Capped exponential backoff for the ``restart``-th retry (1-based):
    ``base_s * 2**(restart-1)`` clamped to ``cap_s``, scaled by a
    uniform ``1 +- jitter`` factor drawn from ``rng`` (deterministic for
    a seeded Random; no jitter when rng is None)."""
    if base_s <= 0:
        return 0.0
    delay = min(cap_s, base_s * (2.0 ** max(0, restart - 1)))
    if jitter and rng is not None:
        delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
    return min(delay, cap_s)


def run_with_recovery(
    loop_fn: Callable[[Optional[Resume]], None],
    *,
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    backoff_cap_s: float = 30.0,
    jitter: float = 0.25,
    seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
    on_restart: Optional[Callable[[int, Exception], None]] = None,
) -> int:
    """``loop_fn(resume)`` runs until completion or raises; returns the
    number of restarts consumed. ``resume`` is ``None`` on the first
    attempt and a :class:`Resume` afterwards. ``on_restart(restarts,
    exc)`` runs before the backoff sleep -- the hook elastic callers use
    to shrink the device pool / rebuild state for the next attempt."""
    rng = random.Random(seed)
    restarts = 0
    resume: Optional[Resume] = None
    while True:
        try:
            loop_fn(resume)
            return restarts
        except Exception as e:  # noqa: BLE001 -- recovery boundary
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("run failed (%s); restart %d/%d", e, restarts, max_restarts)
            if on_restart is not None:
                on_restart(restarts, e)
            delay = backoff_delay(
                restarts, backoff_s, cap_s=backoff_cap_s, jitter=jitter, rng=rng
            )
            if delay > 0:
                sleep(delay)
            resume = Resume(restarts=restarts, cause=f"{type(e).__name__}: {e}")
