"""Synthetic LM data pipeline, ported from ``repro.data.pipeline``:
deterministic, host-sharded, resumable.

- *stateless index -> batch map*: ``batch_at(step)`` is a pure function of
  (seed, step, host) in numpy, so resume-after-failure needs only the
  step number and any host can recompute any shard. It is the
  reference's code: both packages give the same batches bit for bit.
- *host sharding*: each process materializes only its rows of the global
  batch.
- *prefetch*: a daemon thread keeps a bounded queue of ready batches so
  host-side generation overlaps device compute; with ``device`` set,
  :meth:`Prefetcher.next` moves each batch there (the reference's
  ``jax.device_put`` onto a sharding).

The token stream is learnable-but-nontrivial: each sequence is an affine
progression (random start/stride per sequence) XOR low-entropy noise, so
cross-entropy falls quickly from ln(V).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05


class SyntheticLM:
    """Deterministic synthetic next-token data."""

    def __init__(self, cfg: DataConfig, *, process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        if cfg.global_batch % process_count:
            raise ValueError("global_batch must divide across processes")
        self.local_batch = cfg.global_batch // process_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host): the resumability contract."""
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, self.process_index]))
        b, s = self.local_batch, c.seq_len
        start = rng.integers(0, c.vocab_size, (b, 1))
        stride = rng.integers(1, 17, (b, 1))
        seq = (start + stride * np.arange(s + 1)) % c.vocab_size
        flips = rng.random((b, s + 1)) < c.noise
        noise_tok = rng.integers(0, c.vocab_size, (b, s + 1))
        seq = np.where(flips, noise_tok, seq).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch of (step, batch) pairs; with
    ``device``, :meth:`next` returns the batch as tensors there."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2, device=None):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.device = None if device is None else resolve_device(device)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.batch_at(step)
            try:
                self.q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def next(self):
        step, batch = self.q.get()
        if self.device is not None:
            batch = make_batch_arrays(batch, device=self.device)
        return step, batch

    def stop(self):
        self._stop.set()


def make_batch_arrays(batch: Dict[str, np.ndarray], mesh=None, device=None) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (default: the mesh's device,
    else ``cuda``). Every rank of a mesh gets the whole host batch, over
    processes too: the steps take each data rank's rows themselves --
    ``make_train_step`` each microbatch's block of rows at the rank's
    ``('pod', 'data')`` coordinate (``train.step.microbatch_rows``), the
    compressed DDP step its block of the batch."""
    dev = resolve_device(device if device is not None or mesh is None else mesh.device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, non_blocking=True) for k, v in batch.items()}
