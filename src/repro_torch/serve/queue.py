"""Shared request-queue machinery for the serving engines, ported from
``repro.serve.queue`` (standard library only, as there).

Two pieces, both deque-backed (O(1) at either end):

- :class:`PendingQueue`: a plain FIFO (the reference's LM engine keeps
  its pending prompts in one; that engine is not ported yet);
- :class:`CoalescingQueue`: the spectral engine's admission queue.
  Items are pushed under a *coalesce key* (same key == same plan + same
  op == batchable into one stacked execution); a key group becomes ready
  when it reaches ``Admission.max_batch`` items or its oldest item has
  waited ``Admission.max_wait_s`` -- the standard batching-server
  admission policy (fill fast under load, bound tail latency when idle).
  ``coalesce=False`` degrades every group to batches of one, which is
  the control arm of the serving benchmark.

The clock is injectable so admission behavior is testable without
sleeping. ``push``, ``ready`` and ``next_deadline`` also take ``now``
explicitly: the spectral engine on a process group passes the time its
ranks agreed on, so every rank's queue makes the same batches whatever
its own clock reads.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple


class PendingQueue:
    """Deque-backed FIFO: O(1) push/pop at both ends."""

    def __init__(self, items=()):
        self._q: collections.deque = collections.deque(items)

    def push(self, item) -> None:
        self._q.append(item)

    def extend(self, items) -> None:
        self._q.extend(items)

    def pop(self):
        """Oldest item (FIFO). Raises IndexError when empty."""
        return self._q.popleft()

    def peek(self):
        return self._q[0]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


@dataclasses.dataclass(frozen=True)
class Admission:
    """Batching admission policy: flush a key group at ``max_batch``
    items immediately, or whatever has accumulated once the group's
    oldest item has waited ``max_wait_s``."""

    max_batch: int = 8
    max_wait_s: float = 0.002

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")


class CoalescingQueue:
    """Same-key request coalescing with a max-batch / max-wait policy."""

    def __init__(
        self,
        admission: Optional[Admission] = None,
        *,
        coalesce: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.admission = admission or Admission()
        self.coalesce = coalesce
        self.clock = clock
        # key -> FIFO of (arrival_time, item); dict preserves key arrival
        # order, so ready() drains groups oldest-first
        self._groups: Dict[Hashable, PendingQueue] = {}
        self.pushed = 0

    def push(self, key: Hashable, item, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = PendingQueue()
        group.push((now, item))
        self.pushed += 1

    def depth(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def size(self, key: Hashable) -> int:
        """Items queued under ``key``."""
        group = self._groups.get(key)
        return len(group) if group else 0

    def __len__(self) -> int:
        return self.depth()

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest time at which some queued group hits max_wait (i.e.
        when a ``ready()`` poll would flush it); None when empty."""
        arrivals = [g.peek()[0] for g in self._groups.values() if g]
        if not arrivals:
            return None
        return min(arrivals) + self.admission.max_wait_s

    def _pop_batch(self, group: PendingQueue, count: int) -> List:
        return [group.pop()[1] for _ in range(count)]

    def ready(self, now: Optional[float] = None) -> List[Tuple[Hashable, List]]:
        """Pop and return every group the policy says to dispatch now, as
        ``(key, items)`` batches (items in arrival order). Full batches
        flush regardless of age; partial batches flush only once their
        oldest item has waited ``max_wait_s``."""
        now = self.clock() if now is None else now
        batches: List[Tuple[Hashable, List]] = []
        max_batch = self.admission.max_batch if self.coalesce else 1
        for key in list(self._groups):
            group = self._groups[key]
            while len(group) >= max_batch:
                batches.append((key, self._pop_batch(group, max_batch)))
            if group and now - group.peek()[0] >= self.admission.max_wait_s:
                batches.append((key, self._pop_batch(group, len(group))))
            if not group:
                del self._groups[key]
        return batches

    def flush(self) -> List[Tuple[Hashable, List]]:
        """Pop everything immediately (shutdown / drain), still in
        max_batch-sized groups so the executor's compile buckets hold."""
        batches: List[Tuple[Hashable, List]] = []
        max_batch = self.admission.max_batch if self.coalesce else 1
        for key in list(self._groups):
            group = self._groups[key]
            while group:
                batches.append((key, self._pop_batch(group, min(len(group), max_batch))))
            del self._groups[key]
        return batches
