"""The compressed data-parallel step (``make_ddp_compressed_step``) and the
int8 all-gather under it: on ``SimMesh(4)`` against the reference's
shard_map step on 4 forced host devices (one subprocess runs both
compression modes), ``"none"`` at 1e-5, ``"int8"`` losses at 1e-5 and
parameters within 1e-4; then over gloo at P = 2 in one spawn, every
rank's parameters bitwise equal to the other's and within 1e-6 of
``SimMesh(2)``'s on the same global batches.

The same spawn trains over a ``model`` axis of the two processes
(``make_train_step`` SPMD, each rank its blocks cut from one initial
state): every rank's block of every leaf's gradient and parameters
against the same block of the one-rank step (DeepSeek-V3's ring
dispatch against ``SimMesh((1, 2))``'s), the leaves kept whole, the
loss and the gradient norm bitwise equal on both ranks; each
differentiable collective's gradient against ``SimMesh(2)``'s; and the
step over the two processes as a ``data`` axis (each rank its rows,
FSDP) against ``SimMesh(2, "data")``'s."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import SimMesh
from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train import (ddp_state_from_numpy, make_ddp_compressed_step, make_train_step,
                               train_state_from_numpy)
from torch_train_common import (DDP_ARCH, DDP_BATCH, DDP_MODES, DDP_N_STEPS, DDP_P, DDP_SEQ, SPLIT_ARCHS,
                                assert_params_match, assert_split_matches, blocks_of, grad_noise, leaf_names, near_tie,
                                one_thread, split_batches, split_cfg, split_init, split_run, split_tcfg,
                                train_reference)
from torch_train_common import flat as _flat
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

ARCH, P, N_STEPS, BATCH, SEQ, MODES = DDP_ARCH, DDP_P, DDP_N_STEPS, DDP_BATCH, DDP_SEQ, DDP_MODES
#: the step over a model axis of the two gloo processes: SPLIT_ARCHS held to
#: the one-rank step, and DeepSeek-V3's ring dispatch (split experts, MLA,
#: MTP, the shared expert; capacity E / k) held to SimMesh((1, 2)): the
#: ring's aux loss is the mean of each rank's island's, not one rank's
RING_ARCH = "deepseek-v3-671b"
SPLIT_CASES = tuple(SPLIT_ARCHS) + (RING_ARCH,)
COLLECTIVES = ("psum", "gather", "all_gather", "all_to_all", "pvary")



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
    """The training tests' one reference subprocess over 4 host devices
    (``torch_train_common.train_reference``: run once per test run)."""
    return train_reference(tmp_path_factory)


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


def _split_oracle(arch):
    """(the initial numpy state, its specs, ``split_run``'s results on one
    rank -- on ``SimMesh((1, 2))`` for RING_ARCH)."""
    cfg = split_cfg(arch)
    state_np, specs = split_init(arch)
    mesh = SimMesh((1, 2), axis_names=("data", "model"), device="cpu") if arch == RING_ARCH else None
    return state_np, specs, split_run(Model(cfg, mesh, device="cpu"), state_np, split_batches(cfg), split_tcfg())


def _collective_loss(op, mesh, xs, t):
    """A loss of ``op`` over the ``model`` axis on the local blocks ``xs``
    (``pvary``: on ``t``, the same on every rank): of an output the same on
    every rank, one readout; of the ranks' own outputs (``all_to_all``),
    each rank's readout, summed over the local ranks."""
    ranks = mesh.local_ranks()

    def readout(y, scale=1.0):
        return (y * torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape) * scale).sum()

    if op == "psum":
        return readout(mesh.psum(xs, "model")[0])
    if op == "gather":
        return readout(mesh.gather(xs, ("model", None)))
    if op == "all_gather":
        return readout(mesh.all_gather(xs, "model")[0])
    if op == "all_to_all":
        return sum(readout(y, r + 1.5) for y, r in zip(mesh.all_to_all(xs, 1, 0), ranks))
    zs = [v * (r + 1.5) for v, r in zip(mesh.pvary([t] * len(ranks), "model"), ranks)]  # pvary
    return readout(mesh.psum(zs, "model")[0] ** 2)


def _collective_grads(op, mesh):
    """The gradients of :func:`_collective_loss` with respect to the local
    blocks (rank r's block drawn from seed r) and to ``t``."""
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal((4, 6)).astype(np.float32)).requires_grad_()
          for r in mesh.local_ranks()]
    t = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 6)).astype(np.float32)).requires_grad_()
    grads = torch.autograd.grad(_collective_loss(op, mesh, xs, t), xs + [t], allow_unused=True)
    return [None if g is None else g.numpy() for g in grads]


def _data_split_run(model):
    """SPLIT_STEPS of ``make_train_step`` over ``model``'s mesh from
    ``split_init(ARCH)``'s state (each rank its rows of every batch):
    (the metrics, floats a step; the weights after the steps, flat
    numpy)."""
    from repro_torch.core.sharding import block_indices

    state_np, specs = split_init(ARCH)
    state = train_state_from_numpy(state_np, "cpu", mesh=model.mesh, specs=specs, cfg=model.cfg)
    step = make_train_step(model, split_tcfg(), model.mesh)
    metrics = []
    for batch in split_batches(model.cfg):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    layout = model.state_layout()
    return metrics, {k: (v.detach().numpy().copy(), block_indices(*layout["params" + k]))
                     for k, v in _flat(state.params).items()}


def _gloo_worker(rank, world, init_method, out_dir, init, oracles):
    import torch.distributed as dist

    from repro_torch.core import ProcessGroupMesh, init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, axis_name="data", device="cpu")
    try:
        out = {}
        for comp in MODES:
            state, metrics = _run(mesh, init, comp)
            out[comp] = ({k: v.numpy() for k, v in _flat(state.params).items()}, metrics)
        out["data_split"] = _data_split_run(Model(split_cfg(ARCH), mesh, device="cpu"))
        tmesh = ProcessGroupMesh("model", device="cpu")  # the same two processes as a model axis
        out["collectives"] = {op: _collective_grads(op, tmesh) for op in COLLECTIVES}
        out["split"] = {}
        for arch, (state_np, specs, one) in oracles.items():
            cfg = split_cfg(arch)
            model = Model(cfg, tmesh, device="cpu")
            place = dict(mesh=tmesh, specs=specs, cfg=cfg)
            got = split_run(model, state_np, split_batches(cfg), split_tcfg(), **place)
            sharded = dict(zip(leaf_names(state_np.params), model.sharded_leaves()))
            out["split"][arch] = (got, blocks_of(one, **place), sharded)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.array(out, dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(reference, tmp_path_factory):
    """The one spawn of P = 2 gloo processes: each rank's results."""
    import torch.multiprocessing as mp

    world, tmp = 2, tmp_path_factory.mktemp("gloo")
    with one_thread():
        oracles = {arch: _split_oracle(arch) for arch in SPLIT_CASES}
    mp.spawn(_gloo_worker, args=(world, f"file://{tmp / 'rendezvous'}", str(tmp), reference["init"], oracles),
             nprocs=world, join=True)
    return [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item() for r in range(world)]


def test_ddp_step_over_gloo_keeps_replicas_equal(reference, gloo):
    """P = 2 over gloo: the int8 payload moves by all_gather_into_tensor,
    the plain mean by all_reduce; every rank updates the same replicated
    weights."""
    ranks, world = gloo, len(gloo)
    for comp in MODES:
        sim, sim_metrics = _run(SimMesh(world, "data", device="cpu"), reference["init"], comp)
        for name, e in _flat(sim.params).items():
            e = e.numpy()
            assert np.array_equal(ranks[0][comp][0][name], ranks[1][comp][0][name]), (comp, name)
            assert np.abs(ranks[0][comp][0][name] - e).max() <= 1e-6 * max(np.abs(e).max(), 1e-30), (comp, name)
        for s in range(N_STEPS):
            assert ranks[0][comp][1][s] == ranks[1][comp][1][s]
            assert abs(ranks[0][comp][1][s]["loss"] - sim_metrics[s]["loss"]) <= 1e-6 * sim_metrics[s]["loss"]


@pytest.mark.parametrize("arch", SPLIT_CASES)
def test_split_step_over_gloo_matches_one_rank(gloo, arch):
    """``make_train_step`` SPMD over a ``model`` axis of the two processes,
    2 steps in float32 from the one-rank state cut to each rank's blocks
    (``train_state_from_numpy(mesh=, specs=, cfg=)``): each rank's block
    of every leaf's gradient within 1e-5 of that block's largest entry of
    the one-rank step at every step -- so no leaf's gradient is all zeros
    where one rank's is not (a graph cut at a collective) -- the loss and
    the gradient norm within 1e-6, the parameters within 1e-5 (and Adam's
    amplification of the gradients' disagreement); the leaves kept whole,
    the losses and the gradient norms bitwise equal on both ranks."""
    runs = [rank["split"][arch] for rank in gloo]
    for got, exp, _ in runs:
        assert_split_matches(got, exp, [m["lr"] for m in exp[1]])
    (got0, _, sharded), (got1, _, _) = runs
    assert any(sharded.values()) and not all(sharded.values())
    assert got0[1] == got1[1]  # loss, grad_norm, lr: every step, bitwise
    for name in (n for n, s in sharded.items() if not s):
        assert np.array_equal(got0[2][name], got1[2][name]), name
        assert all(np.array_equal(a[name], b[name]) for a, b in zip(got0[0], got1[0])), name


@pytest.mark.parametrize("op", COLLECTIVES)
def test_collectives_over_gloo_match_sim_mesh(gloo, op):
    """Each differentiable collective of ``ProcessGroupMesh`` (psum's
    identity backward, the gathers' own block, the inverse all-to-all,
    pvary's all-reduce) gives each rank the gradient ``SimMesh(2)``'s one
    autograd graph gives that rank's block."""
    with one_thread():
        sim = _collective_grads(op, SimMesh(2, "model", device="cpu"))
    for r, rank in enumerate(gloo):
        got = rank["collectives"][op]
        exp = sim[r] if op != "pvary" else sim[-1]
        g = got[0] if op != "pvary" else got[-1]
        assert np.abs(g - exp).max() <= 1e-6 * np.abs(exp).max(), (op, r)


def test_train_step_over_gloo_splits_a_data_axis(gloo):
    """``make_train_step`` over the two processes as a ``data`` axis: each
    rank trains on its rows of every batch (the loss the global masked
    mean, the gradients summed over the axis), the weights replicated
    (phi3's reduced dims, whose ``"fsdp"`` dims the axis divides, are
    placed over it and gathered before each layer). Both ranks' metrics
    equal, within 1e-6 of ``SimMesh(2, "data")``'s (every rank in one
    process, the whole batch), the weights within 1e-5."""
    with one_thread():
        exp_m, exp_p = _data_split_run(Model(split_cfg(ARCH), SimMesh(2, "data", device="cpu"), device="cpu"))
    for rank in gloo:
        got_m, got_p = rank["data_split"]
        assert got_m == gloo[0]["data_split"][0]
        for a, b in zip(got_m, exp_m):
            for k in ("loss", "grad_norm"):
                assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (k, a[k], b[k])
        assert sorted(got_p) == sorted(exp_p)
        assert any(len(i) < n for name, (_, idx) in got_p.items()  # FSDP placed some of them
                   for i, n in zip(idx, exp_p[name][0].shape))
        for name, (block, idx) in got_p.items():
            e = exp_p[name][0][np.ix_(*idx)]
            assert np.abs(block - e).max() <= 1e-5 * np.abs(exp_p[name][0]).max(), name
