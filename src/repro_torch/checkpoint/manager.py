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
- *mesh-agnostic restore*: a checkpoint of whole leaves (one process, a
  ``SimMesh``, or the reference's) is ``proc0.npz`` of full logical
  arrays; ``restore(..., device=)`` places them on whatever device the
  restart runs on, and with ``layout=`` cuts each rank's block.
- *placed checkpoints* (a ``ProcessGroupMesh`` whose ranks hold blocks,
  the layout the reference's docstring foresees for multi-host): each
  rank writes its own blocks to ``step_<N>/proc<k>.npz`` (``k`` its rank
  in the mesh's group), and the manifest records every leaf's global
  shape and each process's block of it. Rank 0 writes the manifest
  last, once the ranks agree that every ``proc<k>`` file is complete
  (``mesh.host_max``, at the next :meth:`CheckpointManager.wait`); a
  step directory is valid only with every file its manifest names.
  ``restore`` builds each rank's block on the *current* layout from
  whichever files hold it, so a checkpoint of one mesh shape resumes on
  any other, on fewer ranks, or on one; the step ``restore_latest``
  picks is agreed across the ranks.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sharding import Cut, block_indices

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


#: a leaf's place in a placed checkpoint, by leaf name: (its global shape,
#: the cuts a rank keeps -- ``core.sharding.Cut``s -- or None for the whole
#: leaf); ``Model.state_layout`` makes them
Layout = Dict[str, Tuple[Tuple[int, ...], Optional[List[Cut]]]]


def _index(idx: List[np.ndarray]):
    """An index that takes ``idx[d]`` along each dim d: slices (a view)
    where every one is a run of consecutive indices, else ``np.ix_``."""
    if all(len(i) and i[-1] - i[0] == len(i) - 1 and np.all(np.diff(i) == 1) for i in idx):
        return tuple(slice(int(i[0]), int(i[0]) + len(i)) for i in idx)
    return np.ix_(*idx)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, process_index: int = 0, mesh=None):
        """``mesh``: a ``ProcessGroupMesh`` whose ranks write placed
        checkpoints together (``process_index`` is then the rank's; the
        ranks agree through ``mesh.host_max``), or None."""
        self.dir = directory
        self.keep = keep
        self.mesh = mesh if mesh is not None and mesh.caller_holds_block and mesh.p > 1 else None
        self.process_index = mesh.rank if self.mesh is not None else process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[Tuple[int, dict]] = None  # a placed save whose manifest is due
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _agree(self, values: List[float]) -> List[float]:
        return self.mesh.host_max(values) if self.mesh is not None else [float(v) for v in values]

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False, layout: Optional[Layout] = None) -> None:
        """Write ``tree`` as step ``step``. ``layout`` (by leaf name: the
        global shape and this rank's cuts) marks a placed tree: every rank
        of the manager's mesh calls ``save`` with its blocks."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten_with_names(tree).items()}  # device -> host now
        if self.mesh is not None and layout is not None and any(c for _, c in layout.values()):
            self._save_placed(step, host, layout, blocking)
            return
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in host.items()},
        }
        if self.mesh is not None:  # whole leaves on every rank: rank 0 writes them
            if self.mesh.rank != 0:
                return
            self.process_index = 0

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

    def _save_placed(self, step: int, host: Dict[str, np.ndarray], layout: Layout, blocking: bool) -> None:
        """Each rank its ``proc<k>.npz`` in the step's directory (written
        to a temporary name and renamed: a file present is complete);
        the manifest comes at :meth:`wait`, once every rank's is."""
        final, me = self._step_dir(step), self.mesh.rank
        if me == 0:  # a directory left by an earlier attempt at this step goes first
            shutil.rmtree(final, ignore_errors=True)
            os.makedirs(final)
        self._agree([0.0])  # the directory is there for every rank
        blocks = {k: [list(c) for c in cuts] if cuts else None for k, (_, cuts) in layout.items()}
        procs = self._gather_blocks(blocks)
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(layout[k][0]), "dtype": str(v.dtype)} for k, v in host.items()},
            "procs": procs,
        }

        def write():
            try:
                path = os.path.join(final, f"proc{me}.npz")
                with open(path + ".tmp", "wb") as f:
                    np.savez(f, **host)
                os.replace(path + ".tmp", path)
            except BaseException as e:  # noqa: BLE001 -- reported to the ranks' agreement
                self._error = e

        self._pending = (step, manifest)
        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _gather_blocks(self, blocks: dict) -> Dict[str, dict]:
        """Every rank's cuts, keyed by its ``proc<k>`` name (one
        ``all_gather_object`` over the mesh's group: rank 0's manifest
        names each file's blocks)."""
        import torch.distributed as dist

        out: List[Optional[dict]] = [None] * self.mesh.p
        dist.all_gather_object(out, blocks, group=self.mesh.group)
        return {f"proc{k}": b for k, b in enumerate(out)}

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is None:
            return
        (step, manifest), self._pending = self._pending, None
        error, self._error = self._error, None
        failed = self._agree([1.0 if error is not None else 0.0])[0]
        if failed:  # some rank's file is missing: the step stays without a manifest (invalid)
            if error is not None:
                raise error
            return
        if self.mesh.rank == 0:
            tmp = os.path.join(self._step_dir(step), "manifest.json.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(self._step_dir(step), "manifest.json"))
            self._gc()
        self._agree([0.0])  # the manifest is there for every rank

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

    def _manifest(self, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(manifest, dict) or manifest.get("step") != step:
            return None
        return manifest

    def _files(self, step: int, manifest: dict) -> List[str]:
        """The payload files a step needs: every ``proc<k>`` its manifest
        names (a placed checkpoint), else the one file of whole leaves --
        this process's, or ``proc0`` (a checkpoint of whole leaves read on
        any rank)."""
        if "procs" in manifest:
            return sorted(manifest["procs"])
        own = f"proc{self.process_index}"
        return [own if os.path.exists(os.path.join(self._step_dir(step), own + ".npz")) else "proc0"]

    def _is_valid(self, step: int) -> bool:
        """Cheap completeness check: the manifest parses, names this
        step, and every payload file it needs exists. (Deeper corruption
        -- a truncated npz -- is caught at load time by
        :meth:`restore_latest`'s fallback.)"""
        manifest = self._manifest(step)
        if manifest is None:
            return False
        d = self._step_dir(step)
        return all(os.path.exists(os.path.join(d, f + ".npz")) for f in self._files(step, manifest))

    def valid_steps(self) -> List[int]:
        """Steps whose checkpoint passes the completeness check."""
        return [s for s in self.all_steps() if self._is_valid(s)]

    def latest_step(self) -> Optional[int]:
        """Newest *complete* checkpoint step (a partial or corrupt
        directory -- missing/unparseable manifest, missing shard -- is
        skipped rather than offered for restore)."""
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, *, device=None, layout: Optional[Layout] = None) -> Any:
        """Restore into the structure of ``target``: each leaf a tensor
        of the target leaf's dtype, on ``device`` (default: the target
        leaf's device; the CPU for a non-tensor leaf). ``layout`` (by leaf
        name: the global shape and this rank's cuts on the current mesh)
        asks for blocks: each is built from whichever of the step's files
        hold it, whatever layout wrote them."""
        self.wait()
        d = self._step_dir(step)
        manifest = self._manifest(step) or {}
        files = self._files(step, manifest) if manifest else [f"proc{self.process_index}"]
        procs = manifest.get("procs")
        opened = {f: np.load(os.path.join(d, f + ".npz")) for f in files}
        try:
            def leaf(name, tgt):
                shape = tuple(tgt.shape) if hasattr(tgt, "shape") else np.shape(tgt)
                cuts = layout[name][1] if layout is not None and name in layout else None
                if procs is None and cuts is None:
                    arr = opened[files[0]][name]
                else:
                    arr = self._assemble(name, manifest, opened, procs, cuts)
                if tuple(arr.shape) != tuple(shape):
                    raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {shape}")
                if isinstance(tgt, torch.Tensor):
                    arr = arr if arr.flags.c_contiguous else arr.copy(order="C")
                    return torch.from_numpy(arr).to(device=device or tgt.device, dtype=tgt.dtype)
                arr = arr.astype(np.asarray(tgt).dtype)
                return torch.from_numpy(arr).to(device=device or "cpu")

            return _map_leaves(target, leaf)
        finally:
            for f in opened.values():
                f.close()

    @staticmethod
    def _assemble(name: str, manifest: dict, opened: dict, procs: Optional[dict], cuts) -> np.ndarray:
        """The block ``cuts`` of leaf ``name`` (the whole leaf for None)
        from the files that hold its parts: each file's block placed by
        the global indices it and the wanted block share. A block that
        several ranks wrote (a leaf replicated over an axis) is read from
        the first of them, and the reading stops once the wanted block is
        whole."""
        shape = tuple(manifest["leaves"][name]["shape"])
        want = block_indices(shape, cuts)
        need = math.prod(len(w) for w in want)
        out, filled, seen = None, 0, set()
        sources = procs.items() if procs is not None else [(f, None) for f in opened]
        for f, blocks in sources:
            mine = (blocks or {}).get(name)
            key = json.dumps(mine)
            if key in seen:
                continue
            seen.add(key)
            src, dst = [], []
            for w, h in zip(want, block_indices(shape, mine)):
                _, si, di = np.intersect1d(h, w, assume_unique=True, return_indices=True)
                src.append(si)
                dst.append(di)
            if any(len(i) == 0 for i in src):
                continue
            arr = opened[f][name]
            if out is None:
                out = np.empty([len(w) for w in want], dtype=arr.dtype)
            out[_index(dst)] = arr[_index(src)]
            filled += math.prod(len(i) for i in dst)
            if filled == need:
                break
        if out is None or filled < need:
            raise ValueError(f"the checkpoint's files do not hold all of {name}'s block")
        return out

    def restore_latest(self, target: Any, *, device=None, layout: Optional[Layout] = None
                       ) -> Tuple[Optional[int], Any]:
        """Restore the newest checkpoint that actually loads, walking
        back past corrupt/partial ones (one warning each) -- the
        recovery loop's entry point. Over a mesh the ranks agree on each
        step they try (the newest valid on every rank) and on whether it
        loaded everywhere. Returns ``(None, None)`` when no checkpoint
        survives."""
        self.wait()
        bound = math.inf
        while True:
            mine = [s for s in self.valid_steps() if s < bound]
            step = int(-self._agree([-(mine[-1] if mine else -1)])[0])
            if step < 0:
                return None, None
            try:
                tree, failed = self.restore(step, target, device=device, layout=layout), 0.0
            except Exception as e:  # noqa: BLE001 -- fall back to the previous step
                log.warning(
                    "checkpoint step %d unreadable (%s: %s); falling back",
                    step, type(e).__name__, e,
                )
                tree, failed = None, 1.0
            if not self._agree([failed])[0]:
                return step, tree
            bound = step
