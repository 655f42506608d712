"""The compressed data-parallel step (``make_ddp_compressed_step``) and the
int8 all-gather under it: on ``SimMesh(4)`` against the reference's
shard_map step on 4 forced host devices (one subprocess runs both
compression modes), ``"none"`` at 1e-5, ``"int8"`` losses at 1e-5 and
parameters within 1e-4; then over gloo at P = 2 in one spawn, every
rank's parameters bitwise equal to the other's and within 1e-6 of
``SimMesh(2)``'s on the same global batches."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import SimMesh
from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train import ddp_state_from_numpy, make_ddp_compressed_step
from torch_train_common import assert_params_match, grad_noise, near_tie
from torch_train_common import flat as _flat

ARCH = "phi3-medium-14b"  # the reference's own DDP test's (tests/test_elastic.py)
P = 4
N_STEPS = 3
BATCH, SEQ = 8, 16
MODES = ("none", "int8")

REF_CODE = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.configs import TrainConfig, get_config
from repro.data import DataConfig, SyntheticLM
from repro.models import Model
from repro.optim import compress
from repro.train import init_ddp_state, make_ddp_compressed_step


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


mesh = make_mesh((P,), ("data",))
cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
model = Model(cfg)
ds = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))
requant = jax.jit(lambda x: jax.tree.map(lambda v: v - compress.dequantize_int8(*compress.quantize_int8(v)), x))
out = {}
for comp in MODES:
    tcfg = TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=12, grad_compression=comp)
    state = jax.jit(lambda k: init_ddp_state(model, k, tcfg))(jax.random.PRNGKey(0))
    if comp == MODES[0]:
        out["init"] = jax.tree.map(np.asarray, state)
    step = make_ddp_compressed_step(model, tcfg, mesh)
    err = [state.err] * P
    for s in range(N_STEPS):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}
        # each rank's gradient of its block, as the shard_map step takes them:
        # their mean, and with int8 each rank's quantizer input g + err
        n = BATCH // P
        gs = [grad(state.params, {k: v[r * n:(r + 1) * n] for k, v in batch.items()}) for r in range(P)]
        out[("grad", comp, s)] = flat(jax.tree.map(lambda *g: sum(g) / P, *gs))
        if comp == "int8":
            xs = [jax.tree.map(jnp.add, g, e) for g, e in zip(gs, err)]
            out[("x", s)] = [flat(x) for x in xs]
            err = [requant(x) for x in xs]
        state, m = step(state, batch)
        out[(comp, s)] = {k: float(v) for k, v in m.items()}
    out[comp] = jax.tree.map(np.asarray, state)
import pickle
with open(OUT, "wb") as fh:
    pickle.dump(out, fh)
print("PASS")
"""


def _cfg():
    return dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")


def _tcfg(comp):
    return TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=12, grad_compression=comp)


def _run(mesh, init, comp, ranks=None):
    """N_STEPS of the port's step from the reference's initial state;
    returns (state, per-step metrics as floats)."""
    cfg = _cfg()
    model = Model(cfg, device="cpu")
    state = ddp_state_from_numpy(init, "cpu", ranks=len(mesh.local_ranks()) if ranks is None else ranks)
    step = make_ddp_compressed_step(model, _tcfg(comp), mesh)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
    metrics = []
    for s in range(N_STEPS):
        state, m = step(state, make_batch_arrays(ds.batch_at(s), device="cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import pickle

    path = str(tmp_path_factory.mktemp("ddp_ref") / "ref.pkl")
    head = f"OUT = {path!r}\nARCH = {ARCH!r}\nP = {P}\nN_STEPS = {N_STEPS}\nBATCH, SEQ = {BATCH}, {SEQ}\nMODES = {MODES!r}\n"
    assert "PASS" in run_subprocess(head + REF_CODE, devices=P)
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("comp", MODES)
def test_ddp_step_on_sim_mesh_matches_reference(reference, comp):
    state, metrics = _run(SimMesh(P, "data", device="cpu"), reference["init"], comp)
    lrs = []
    for s in range(N_STEPS):
        exp = reference[(comp, s)]
        assert sorted(metrics[s]) == sorted(exp)
        for k in ("loss", "grad_norm"):
            assert abs(metrics[s][k] - exp[k]) <= 1e-5 * abs(exp[k]), (s, k, metrics[s][k], exp[k])
        lrs.append(2e-3 * s / 2 if s < 2 else 2e-3)
    ref = reference[comp]
    rho = grad_noise([reference[("grad", comp, s)] for s in range(N_STEPS)])
    ties = near_tie([x for s in range(N_STEPS) for x in reference[("x", s)]]) if comp == "int8" else None
    assert_params_match(state.params, ref.params, 1e-5 if comp == "none" else 1e-4, lrs, rho, ties)
    assert int(state.step) == int(ref.step) == N_STEPS
    assert len(state.err) == P
    if comp == "none":
        assert all(float(e.abs().max()) == 0 for tree in state.err for e in adamw.leaves(tree))
    else:  # rank 0's residual is what the reference's replicated out spec hands back
        xs = [reference[("x", s)][0] for s in range(N_STEPS)]
        ties = near_tie(xs)
        for name, e in _flat(ref.err).items():
            d = np.abs(_flat(state.err[0])[name].numpy() - e)
            # the residual is at most half a quantum, max|x| / 254: the gradients' agreement
            # (1e-5 of their largest) is 254e-5 of that, and 1e-2 of it bounds every element
            # but those at a .5 tie on this rank in some step, which may round either way
            # and move by up to one quantum
            quantum = max(np.abs(x[name]).max() for x in xs) / 127.0
            bound = np.where(ties[name], 1.01 * quantum, 1e-2 * np.abs(e).max())
            assert (d <= bound).all(), (name, int((d > bound).sum()), float(d.max()))


def _gloo_worker(rank, world, init_method, out_dir, init):
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, axis_name="data", device="cpu")
    try:
        out = {}
        for comp in MODES:
            state, metrics = _run(mesh, init, comp)
            out[comp] = ({k: v.numpy() for k, v in _flat(state.params).items()}, metrics)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.array(out, dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


def test_ddp_step_over_gloo_keeps_replicas_equal(reference, tmp_path):
    """P = 2 over gloo: the int8 payload moves by all_gather_into_tensor,
    the plain mean by all_reduce; every rank updates the same replicated
    weights."""
    import torch.multiprocessing as mp

    world = 2
    mp.spawn(_gloo_worker, args=(world, f"file://{tmp_path / 'rendezvous'}", str(tmp_path), reference["init"]),
             nprocs=world, join=True)
    ranks = [np.load(tmp_path / f"rank{r}.npy", allow_pickle=True).item() for r in range(world)]
    for comp in MODES:
        sim, sim_metrics = _run(SimMesh(world, "data", device="cpu"), reference["init"], comp)
        for name, e in _flat(sim.params).items():
            e = e.numpy()
            assert np.array_equal(ranks[0][comp][0][name], ranks[1][comp][0][name]), (comp, name)
            assert np.abs(ranks[0][comp][0][name] - e).max() <= 1e-6 * max(np.abs(e).max(), 1e-30), (comp, name)
        for s in range(N_STEPS):
            assert ranks[0][comp][1][s] == ranks[1][comp][1][s]
            assert abs(ranks[0][comp][1][s]["loss"] - sim_metrics[s]["loss"]) <= 1e-6 * sim_metrics[s]["loss"]
