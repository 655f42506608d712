"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same leaf names and files, a
checkpoint written by either package restoring bit for bit in the other,
and the corrupt-skip matrix of the reference's ``TestCheckpointRobustness``
(temp directories invisible, a corrupt manifest or missing shard skipped,
a truncated npz falling back at load, concurrent savers)."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_names
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((4, 8)).astype(np.float32),
        "nested": {
            "b": rng.integers(0, 10, (3,)).astype(np.int32),
            "spec": [(rng.standard_normal((2, 3)) + 1j * rng.standard_normal((2, 3))).astype(np.complex64),
                     np.float32(2.5)],
        },
        "step": np.int32(7),
        "pair": (rng.standard_normal((5,)).astype(np.float32), rng.integers(0, 2, (2, 2)).astype(np.int32)),
    }


def _tree(arrays, to):
    """``arrays`` with every leaf converted by ``to``."""
    if isinstance(arrays, dict):
        return {k: _tree(v, to) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(_tree(v, to) for v in arrays)
    return to(arrays)


def _torch_tree(arrays):
    return _tree(arrays, lambda a: torch.from_numpy(np.array(a)))


def _jax_tree(arrays):
    return _tree(arrays, jnp.asarray)


def _leaves(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _flatten_with_names(tree).items()}


def test_leaf_names_and_files_equal_the_references(tmp_path):
    arrays = _arrays()
    CheckpointManager(str(tmp_path / "port")).save(3, _torch_tree(arrays), blocking=True)
    RefManager(str(tmp_path / "ref")).save(3, _jax_tree(arrays), blocking=True)
    files = {}
    for name in ("port", "ref"):
        d = tmp_path / name / "step_0000000003"
        assert sorted(os.listdir(d)) == ["manifest.json", "proc0.npz"]
        with np.load(d / "proc0.npz") as z:
            files[name] = (json.loads((d / "manifest.json").read_text()), {k: z[k] for k in z.files})
    assert files["port"][0] == files["ref"][0]
    assert list(files["port"][1]) == list(files["ref"][1])
    assert list(files["port"][1]) == ["nested/b", "nested/spec/0", "nested/spec/1", "pair/0", "pair/1", "step", "w"]
    for k, v in files["ref"][1].items():
        np.testing.assert_array_equal(files["port"][1][k], v)
        assert files["port"][1][k].dtype == v.dtype


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_checkpoint_restores_bit_for_bit_in_the_other_package(writer, tmp_path):
    arrays = _arrays(seed=1)
    target = _arrays(seed=2)  # same structure, other values
    if writer == "ref":
        RefManager(str(tmp_path)).save(5, _jax_tree(arrays), blocking=True)
        step, restored = CheckpointManager(str(tmp_path)).restore_latest(_torch_tree(target))
        assert all(isinstance(v, torch.Tensor) for v in _flatten_with_names(restored).values())
        assert isinstance(restored["pair"], tuple) and isinstance(restored["nested"]["spec"], list)
    else:
        CheckpointManager(str(tmp_path)).save(5, _torch_tree(arrays), blocking=True)
        step, restored = RefManager(str(tmp_path)).restore_latest(_jax_tree(target))
    assert step == 5
    got, exp = _leaves(restored), _leaves(_torch_tree(arrays))
    assert list(got) == list(exp)
    for k in exp:
        np.testing.assert_array_equal(got[k], exp[k])
        assert got[k].dtype == exp[k].dtype, k


def test_roundtrip_async_keep_n_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _torch_tree(_arrays(seed=3))
    for s in (1, 2, 3, 4):
        mgr.save(s, t)  # background write; the next save joins it
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    restored = mgr.restore(4, t, device="cpu")
    for k, v in _leaves(restored).items():
        np.testing.assert_array_equal(v, _leaves(t)[k])
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_async_save_holds_a_copy_of_cpu_tensors(tmp_path, monkeypatch):
    """The train steps update their state in place while the background
    thread writes the last checkpoint: the write must hold the values of
    the moment ``save`` was called. The write is held until the tensors
    have been overwritten."""
    import threading

    from repro_torch.checkpoint import manager

    release, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert release.wait(30)
        savez(*args, **kwargs)

    monkeypatch.setattr(manager.np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path))
    t = _torch_tree(_arrays(seed=4))
    before = {k: np.array(v) for k, v in _leaves(t).items()}
    mgr.save(1, t)
    for v in _flatten_with_names(t).values():
        v.add_(1)
    release.set()
    mgr.wait()
    for k, v in _leaves(mgr.restore(1, t)).items():
        np.testing.assert_array_equal(v, before[k])


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(4)}, blocking=True)
    with pytest.raises(ValueError, match="shape mismatch for a"):
        mgr.restore(1, {"a": torch.zeros(5)})


# ------------------------------------------------- the corrupt-skip matrix
def _small():
    return {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3)}


def test_tmp_dirs_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _small(), blocking=True)
    (tmp_path / "step_0000000009.tmpabc123").mkdir()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_corrupt_manifest_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _small(), blocking=True)
    (tmp_path / "step_0000000003" / "manifest.json").write_text("{not json")
    assert mgr.all_steps() == [1, 2, 3]
    assert mgr.valid_steps() == [1, 2] and mgr.latest_step() == 2
    step, restored = mgr.restore_latest(_small())
    assert step == 2 and torch.equal(restored["x"], _small()["x"])


def test_missing_shard_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2):
        mgr.save(s, _small(), blocking=True)
    (tmp_path / "step_0000000002" / "proc0.npz").unlink()
    assert mgr.latest_step() == 1


def test_truncated_npz_falls_back_at_load(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2):
        mgr.save(s, _small(), blocking=True)
    npz = tmp_path / "step_0000000002" / "proc0.npz"
    npz.write_bytes(npz.read_bytes()[:20])  # valid-looking, unreadable
    assert mgr.latest_step() == 2  # the cheap check cannot see inside
    step, restored = mgr.restore_latest(_small())
    assert step == 1 and restored is not None


def test_no_survivor_returns_none(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore_latest(_small()) == (None, None)


def test_atomic_unique_staging(tmp_path):
    a, b = CheckpointManager(str(tmp_path)), CheckpointManager(str(tmp_path))
    a.save(1, _small(), blocking=True)
    b.save(1, {"x": torch.ones(2, 3)}, blocking=True)
    step, restored = a.restore_latest(_small())
    assert step == 1 and torch.equal(restored["x"], torch.ones(2, 3))
    assert not [f for f in tmp_path.iterdir() if ".tmp" in f.name]
