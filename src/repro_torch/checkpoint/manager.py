"""Fault-tolerant checkpointing, ported from ``repro.checkpoint.manager``:
atomic, async, keep-N, rank-count-agnostic.

A checkpoint is a tree of tensors -- nested dicts, lists, tuples and
namedtuples, tensors (or numpy arrays / Python numbers) at the leaves.
Leaves are named by their path, ``a/b/0``, dict keys in sorted order, as
``jax.tree_util`` names them in the reference, and the on-disk layout is
the reference's: ``step_<N>/proc<k>.npz`` plus ``manifest.json``. A
checkpoint written by either package therefore restores in the other.

- *atomic*: a checkpoint is staged into a unique same-dir temp directory
  (``step_<N>.tmp*`` via ``tempfile.mkdtemp``) with the manifest
  written LAST, then ``os.replace``d into place only when complete; a
  crash mid-save never corrupts the latest good checkpoint and never
  collides with a concurrent saver.
- *async*: the device -> host copy (a copy on the CPU too, which waits
  for the device) happens in the calling thread; only the disk write
  runs on a background thread (joined before the next save / restore),
  so a step that updates the state in place meanwhile cannot reach it.
- *keep-N*: bounded disk usage with the newest N checkpoints retained.
- *corrupt-skip restore*: ``latest_step``/``restore_latest`` consider
  only checkpoints whose manifest parses and whose shard file exists,
  and ``restore_latest`` falls back to the previous step when the
  newest one fails to load (truncated npz, bit rot) instead of raising.
- *mesh-agnostic restore*: leaves are stored as full logical arrays;
  ``restore(..., device=)`` places them on whatever device the restart
  runs on, and a ``ProcessGroupMesh`` cuts each rank's block with
  ``mesh.split`` (elastic re-scale).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("repro_torch.checkpoint")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of an inner tree node, in the reference's
    flattening order; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # namedtuple: field names
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_names(tree) -> Dict[str, Any]:
    """``{"a/b/0": leaf, ...}`` in flattening order (None is an empty
    subtree, as in jax)."""
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            flat["/".join(path)] = node
            return
        for name, child in kids:
            walk(child, path + (name,))

    walk(tree, ())
    return flat


def _map_leaves(tree, fn: Callable[[str, Any], Any], path=()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn("/".join(path), tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn, path + (str(k),)) for k in tree}
    mapped = [_map_leaves(child, fn, path + (name,)) for name, child in kids]
    if isinstance(tree, list):
        return mapped
    return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf``, never a view: the train steps update their
    state in place while the background thread writes it out."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().resolve_conj().resolve_neg().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten_with_names(tree).items()}  # device -> host now
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in host.items()},
        }

        def write():
            # unique same-dir tempdir: same filesystem (so os.replace is
            # atomic) and no collision if two savers race the same step;
            # the ".tmp" infix keeps it invisible to all_steps()
            tmp = tempfile.mkdtemp(prefix=f"step_{step:010d}.tmp", dir=self.dir)
            final = self._step_dir(step)
            try:
                np.savez(os.path.join(tmp, f"proc{self.process_index}.npz"), **host)
                # manifest last: its presence marks the payload complete
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """Every step directory present on disk, complete or not."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _is_valid(self, step: int) -> bool:
        """Cheap completeness check: the manifest parses, names this
        step, and this process's shard file exists. (Deeper corruption
        -- a truncated npz -- is caught at load time by
        :meth:`restore_latest`'s fallback.)"""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if not isinstance(manifest, dict) or manifest.get("step") != step:
            return False
        return os.path.exists(os.path.join(d, f"proc{self.process_index}.npz"))

    def valid_steps(self) -> List[int]:
        """Steps whose checkpoint passes the completeness check."""
        return [s for s in self.all_steps() if self._is_valid(s)]

    def latest_step(self) -> Optional[int]:
        """Newest *complete* checkpoint step (a partial or corrupt
        directory -- missing/unparseable manifest, missing shard -- is
        skipped rather than offered for restore)."""
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, *, device=None) -> Any:
        """Restore into the structure of ``target``: each leaf a tensor
        of the target leaf's dtype, on ``device`` (default: the target
        leaf's device; the CPU for a non-tensor leaf)."""
        self.wait()
        path = os.path.join(self._step_dir(step), f"proc{self.process_index}.npz")
        with np.load(path) as data:
            def leaf(name, tgt):
                arr = data[name]
                shape = tuple(tgt.shape) if hasattr(tgt, "shape") else np.shape(tgt)
                if tuple(arr.shape) != tuple(shape):
                    raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {shape}")
                if isinstance(tgt, torch.Tensor):
                    return torch.from_numpy(arr).to(device=device or tgt.device, dtype=tgt.dtype)
                arr = arr.astype(np.asarray(tgt).dtype)
                return torch.from_numpy(arr).to(device=device or "cpu")

            return _map_leaves(target, leaf)

    def restore_latest(self, target: Any, *, device=None) -> Tuple[Optional[int], Any]:
        """Restore the newest checkpoint that actually loads, walking
        back past corrupt/partial ones (one warning each) -- the
        recovery loop's entry point. Returns ``(None, None)`` when no
        checkpoint survives."""
        for step in reversed(self.valid_steps()):
            try:
                return step, self.restore(step, target, device=device)
            except Exception as e:  # noqa: BLE001 -- fall back to the previous step
                log.warning(
                    "checkpoint step %d unreadable (%s: %s); falling back",
                    step, type(e).__name__, e,
                )
        return None, None
