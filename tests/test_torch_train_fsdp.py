"""FSDP x TP training over a data x model grid of gloo processes: the
step (``make_train_step`` over a ``ProcessGroupMesh`` with ``data`` and
``model`` axes), its placed state, the collectives under it, checkpoints
of the placed state and the train launcher over processes.

One gloo spawn at P = 4 runs every case (on one torch thread), and the
reference's side comes from the training tests' one subprocess over 4
host devices (``torch_train_common.train_reference``, shared with
``tests/test_torch_train_ddp.py``):

- each rank's block of every leaf against the reference's shard on the
  device of the same mesh coordinates, under ``state_shardings(mesh,
  specs, abstract_state)`` on (2, 2), (4, 1) and (2, 1, 2) host meshes;
- one step (microbatch 2, float32) of qwen, mixtral (MoE capacity groups
  at the stock capacity factor), hymba (meta tokens, Mamba) and
  DeepSeek-V3 (MLA, MTP, the ring dispatch's aux under a data axis) on
  (2, 2) and (4, 1) against ``jit_train_step`` on the same mesh shape,
  on a plain batch and on one whose labels hold -1 in one data block
  only (the global masked mean); the (2, 1, 2) ``('pod', 'data',
  'model')`` grid against (2, 2);
- ``psum_scatter`` and the FSDP gather's gradients against ``SimMesh``'s;
- the state collectives each step, prefill and decode step counted
  (``core.mesh.FSDP_BYTES`` / ``FSDP_CALLS``) against the dry run's
  prediction (``launch.dryrun.cell_report``), also for one step of four
  more families on (2, 2), and a psum's count against ``SimMesh``'s;
- every other collective of the same runs (``core.mesh.collectives``:
  the activation collectives over ``model``, the MoE ring's aux) against
  the dry run's ``activation`` entry, and ``SimMesh((1, 2))`` on a
  rank's rows counting what a (2, 2) rank counts over ``model``;
- a placed checkpoint written on (2, 2) restored bitwise on (4, 1), on
  (1, 2) (the survivors of an elastic shrink) and on one rank; a
  reference checkpoint restored onto (2, 2); a step directory missing
  one ``proc<k>.npz`` skipped by every rank alike;
- the launcher over the P = 4 world with ``--fail-at`` ending bitwise
  where the same run without a failure ends.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core.sharding import block_indices
from torch_train_common import (FSDP_ARCHS, FSDP_BATCH, FSDP_GRIDS, FSDP_SEQ, POD_GRID, assert_flat_params_match,
                                fsdp_batches, fsdp_cfg, fsdp_init, fsdp_tcfg, flat, grad_noise, one_thread,
                                train_reference)

P = 4
GRIDS = {**FSDP_GRIDS, POD_GRID[0]: POD_GRID[1]}
#: the leaves whose block the port cuts otherwise than the reference's
#: shard, by design: heads placed whole (hymba's 5 / 1 heads on a model
#: axis of 2; the reference splits the flattened head columns) and
#: Mamba's ``[x | z]`` packed projection, a rank holding each part's
#: block (``ssm.MESH_LAYOUT``)
DEPARTURES = {
    "hymba-1.5b": {"/hymba/attn/wq", "/hymba/attn/wk", "/hymba/attn/wv", "/hymba/attn/wo", "/hymba/mamba/win"},
}
#: the gradient tolerance of a cell, 1e-5 of each leaf's largest entry but
#: for DeepSeek-V3's ring dispatch on (2, 2): at this seed its MoE layer's
#: MLA query projections (wdq, wuq) land 1.04-1.09e-5 from the reference's
#: there. The rounding is the reference's: against the reference's own step
#: in float64 (x64) the port's float32 step lies within 3.4e-6 on every
#: leaf, the reference's float32 step 9.5e-6 (wuq) / 8.9e-6 (wdq); other
#: seeds and (4, 1) keep both under 6.7e-6 (tools/ring_gap_probe.py
#: --float64; ROADMAP queue C). The port on SimMesh((2, 2)) lands where it
#: lands over gloo (test_ring_cell_is_sim_mesh_s holds the two at 1e-5)
GRAD_TOL = {("deepseek-v3-671b", (2, 2)): 2e-5}
RING_ARCH = "deepseek-v3-671b"
CKPT_ARCH = "qwen2.5-32b"
COLLECTIVES = [("all_gather_fsdp", "data"), ("all_gather_fsdp", ("data", "model")), ("psum_scatter", "data"),
               ("psum_scatter", ("data", "model"))]


def _ranges(idx):
    """Each dim's (start, stop) of a block's indices, or None for a dim
    whose indices are not one run (a packed dim's parts)."""
    out = []
    for i in idx:
        run = len(i) == 0 or np.array_equal(i, np.arange(i[0], i[0] + len(i)))
        out.append((int(i[0]), int(i[0]) + len(i)) if run else None)
    return tuple(out)


def _blocks(mesh, model, state_np, specs, cfg):
    """The global indices of the placed state's block of every weight on
    this rank, one array a dim (``Model.state_layout``'s cuts), checked against
    the whole leaf; and the moments placed as the weights."""
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import place_train_state, train_state_from_numpy

    state = train_state_from_numpy(state_np, "cpu", mesh=mesh, specs=specs, cfg=cfg)
    cut = place_train_state(train_state_from_numpy(state_np, "cpu"), mesh=mesh, specs=specs, cfg=cfg)
    trees = [leaves({"p": st.params, "m": st.opt.mu, "v": st.opt.nu}) for st in (cut, state)]
    assert all(torch.equal(a, b) for a, b in zip(*trees))
    layout = model.state_layout()
    whole = flat(state_np.params)
    out = {}
    for name, block in flat(state.params).items():
        shape, cuts = layout["params" + name]
        idx = block_indices(shape, cuts)
        assert np.array_equal(block.numpy(), whole[name][np.ix_(*idx)]), name
        assert torch.equal(flat(state.opt.mu)[name], torch.zeros_like(block)), name
        out[name] = idx
    return out


def _step(model, state_np, specs, cfg, batch):
    """One step from the numpy state cut to this rank's blocks: (the
    metrics, the new weights' and first moments' blocks, flat numpy)."""
    from repro_torch.data import make_batch_arrays
    from repro_torch.train import make_train_step, train_state_from_numpy

    state = train_state_from_numpy(state_np, "cpu", mesh=model.mesh, specs=specs, cfg=cfg)
    state, m = make_train_step(model, fsdp_tcfg(), model.mesh)(state, make_batch_arrays(batch, device="cpu"))
    as_np = lambda t: {k: v.detach().numpy().copy() for k, v in flat(t).items()}  # noqa: E731
    return {k: float(v) for k, v in m.items()}, as_np(state.params), as_np(state.opt.mu)


def _readout(y, scale):
    return (y * torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape) * scale).sum()


def _collective_grads(op, axes, mesh):
    """The gradients with respect to the local blocks (rank r's drawn from
    seed r) of a loss in which each rank uses the collective's output its
    own way (scaled by r + 1.5)."""
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal((4, 6)).astype(np.float32)).requires_grad_()
          for r in mesh.local_ranks()]
    ys = mesh.all_gather_fsdp(xs, axes, dim=1) if op == "all_gather_fsdp" else mesh.psum_scatter(xs, axes, dim=0)
    loss = sum(_readout(y, r + 1.5) for y, r in zip(ys, mesh.local_ranks()))
    return [g.numpy() for g in torch.autograd.grad(loss, xs)], [y.detach().numpy() for y in ys]


#: the serving calls whose weight gathers are counted: a prefill of
#: SERVE_BATCH x SERVE_PROMPT tokens into a cache of SERVE_CACHE, one decode step
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE = 2, 8, 12


def _counted():
    """``core.mesh.collectives`` of each scope, and of the activation
    collectives over ``model`` alone, as counted since the last reset."""
    from repro_torch.core.mesh import collectives

    return {"state": collectives("state"), "activation": collectives("activation"),
            "model": collectives("activation", ("model",))}


def _serve_moved(model, state_np, specs, cfg):
    """What ``core.mesh.FSDP_BYTES`` / ``FSDP_CALLS`` and every collective
    (:func:`_counted`) count on this rank in one prefill and in one decode
    step of the placed weights (every rank on SERVE_BATCH rows)."""
    from repro_torch.core.mesh import FSDP_BYTES, FSDP_CALLS, reset_collectives
    from repro_torch.models.model import params_from_numpy

    params = params_from_numpy(state_np.params, "cpu", mesh=model.mesh, specs=specs, cfg=cfg)
    tokens = torch.arange(SERVE_BATCH * SERVE_PROMPT).reshape(SERVE_BATCH, SERVE_PROMPT) % cfg.vocab_size
    state = model.init_decode_state(SERVE_BATCH, SERVE_CACHE)
    out = {}
    for kind in ("prefill", "decode"):
        reset_collectives()
        if kind == "prefill":
            state, _ = model.prefill(params, {"tokens": tokens}, state)
        else:
            model.decode_step(params, tokens[:, :1], state)
        out[kind] = (dict(FSDP_BYTES), dict(FSDP_CALLS), _counted())
    return out


#: the families FSDP_ARCHS leave out, each one step on (2, 2) against the dry
#: run's collectives (no reference step): tied embeddings and alternating
#: windows (gemma2), the encoder-decoder (whisper), embeddings in (the
#: vision stub) and xLSTM's layouts (ssm.MESH_LAYOUT)
MORE_ARCHS = ("gemma2-9b", "whisper-medium", "phi-3-vision-4.2b", "xlstm-1.3b")


def _more_batch(cfg):
    """FSDP_BATCH x FSDP_SEQ of the inputs ``cfg`` takes (whisper: frames and
    FSDP_SEQ / decoder_ratio decoder tokens), seeded."""
    rng = np.random.default_rng(0)
    rows, seq = FSDP_BATCH, max(FSDP_SEQ // cfg.decoder_ratio, 1) if cfg.is_encdec else FSDP_SEQ
    ids = lambda: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)))  # noqa: E731
    out = {}
    if cfg.is_encdec or cfg.input_kind == "embeddings":
        key = "enc_embeds" if cfg.is_encdec else "embeds"
        out[key] = torch.from_numpy(rng.standard_normal((rows, FSDP_SEQ, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec or cfg.input_kind != "embeddings":
        out["tokens"] = ids()
    out["labels"] = ids()
    return out


def _moved_more(arch, mesh):
    """``FSDP_BYTES`` / ``FSDP_CALLS`` and every collective (:func:`_counted`)
    of one step of ``arch`` (reduced, float32) over ``mesh`` from its own
    init."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import FSDP_BYTES, FSDP_CALLS, reset_collectives
    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    model = Model(cfg, mesh, device="cpu")
    state, _ = init_train_state(model, torch.Generator().manual_seed(0), fsdp_tcfg())
    step = make_train_step(model, fsdp_tcfg(), mesh)
    reset_collectives()
    step(state._replace(step=torch.ones((), dtype=torch.int32)), _more_batch(cfg))
    return dict(FSDP_BYTES), dict(FSDP_CALLS), _counted()


#: the psums whose all-reduce ``FSDP_BYTES`` counts: those over a batch axis
PSUM_AXES = ["data", ("data", "model"), "model"]


def _psum_counted(mesh):
    """``FSDP_BYTES`` / ``FSDP_CALLS`` after one psum of a (3, 5) float32
    block over each of PSUM_AXES."""
    from repro_torch.core.mesh import FSDP_BYTES, FSDP_CALLS

    out = {}
    for axes in PSUM_AXES:
        FSDP_BYTES.clear()
        FSDP_CALLS.clear()
        mesh.psum([torch.ones((3, 5)) for _ in mesh.local_ranks()], axes)
        out[axes] = (dict(FSDP_BYTES), dict(FSDP_CALLS))
    return out


def _ckpt_cases(rank, mesh22, inputs, tmp):
    """The checkpoint cases: (each case's restored blocks equal to the
    whole state's blocks on its mesh, bitwise; the step every rank
    restores after step 5 lost one file)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ProcessGroupMesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic_mesh
    from repro_torch.train import train_state_from_numpy

    cfg = fsdp_cfg(CKPT_ARCH)
    state_np, specs = inputs["init"][CKPT_ARCH]
    # a state whose every leaf differs from the initial one's (the moments are not zeros)
    state_np = state_np._replace(opt=state_np.opt._replace(mu=adamw.tree_map(lambda a: a + 0.5, state_np.params),
                                                           nu=adamw.tree_map(lambda a: a * a, state_np.params)))
    zero = lambda st: st._replace(params=adamw.tree_map(torch.zeros_like, st.params))  # noqa: E731

    def placed(mesh):
        model = Model(cfg, mesh, device="cpu")
        return train_state_from_numpy(state_np, "cpu", mesh=mesh, specs=specs, cfg=cfg), model.state_layout()

    def same(a, b):
        fa, fb = flat({"p": a.params, "m": a.opt.mu, "v": a.opt.nu}), flat({"p": b.params, "m": b.opt.mu,
                                                                           "v": b.opt.nu})
        return all(torch.equal(fa[k], fb[k]) for k in fb) and int(a.step) == int(b.step)

    out = {}
    ck = os.path.join(tmp, "placed")
    state, layout = placed(mesh22)
    mgr = CheckpointManager(ck, keep=5, mesh=mesh22)
    mgr.save(3, state, layout=layout)
    mgr.wait()
    mesh41 = ProcessGroupMesh(device="cpu", grid=(4, 1), axis_names=("data", "model"))
    exp, lay = placed(mesh41)
    step, got = CheckpointManager(ck, mesh=mesh41).restore_latest(zero(exp), layout=lay)
    out["(4, 1)"] = step == 3 and same(got, exp)
    small = elastic_mesh(("data", "model"), model_parallel=2, devices=[0, 1], device="cpu")
    if small is not None:  # the survivors of a shrink to (1, 2)
        exp, lay = placed(small)
        step, got = CheckpointManager(ck, mesh=small).restore_latest(zero(exp), layout=lay)
        out["(1, 2)"] = step == 3 and small.shape == {"data": 1, "model": 2} and same(got, exp)
    exp = train_state_from_numpy(state_np, "cpu")
    step, got = CheckpointManager(ck).restore_latest(zero(exp), layout=Model(cfg, device="cpu").state_layout())
    out["one rank"] = step == 3 and same(got, exp)
    step, got = CheckpointManager(inputs["ref_ckpt"], mesh=mesh22).restore_latest(zero(state), layout=layout)
    out["reference onto (2, 2)"] = step == 2 and same(got, train_state_from_numpy(
        inputs["ref_state"], "cpu", mesh=mesh22, specs=specs, cfg=cfg))
    mgr.save(4, state, layout=layout)
    mgr.save(5, state, layout=layout)
    mgr.wait()
    if rank == 0:
        os.remove(os.path.join(ck, "step_0000000005", "proc3.npz"))
    mesh22.host_max([0.0])  # the file is gone for every rank
    step, _ = CheckpointManager(ck, mesh=mesh22).restore_latest(zero(state), layout=layout)
    return out, step


def _launcher_cases(tmp):
    """The train launcher over the P = 4 world ((2, 2) at
    ``--model-parallel 2``): a run with a failure injected at step 3 under
    ``--elastic`` (each attempt joins ``elastic_mesh``'s survivors: all
    four) and one without either. Returns (their histories, whether this
    rank's final checkpoint file is bitwise the same)."""
    from repro_torch.launch.train import build_argparser, train

    def run(name, *extra):
        args = build_argparser().parse_args([
            "--arch", CKPT_ARCH, "--reduced", "--steps", "4", "--batch", "8", "--seq", "16", "--model-parallel",
            "2", "--ckpt-dir", os.path.join(tmp, name), "--ckpt-every", "2", "--device", "cpu", *extra])
        return train(args)

    failed, clean = run("failed", "--fail-at", "3", "--elastic"), run("clean")
    import torch.distributed as dist

    me = dist.get_rank()
    a, b = (np.load(os.path.join(tmp, n, "step_0000000004", f"proc{me}.npz")) for n in ("failed", "clean"))
    same = sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in b.files)
    return (failed, clean), same


def _gloo_worker(rank, world, init_method, out_dir, inputs):
    import torch.distributed as dist

    from repro_torch.core import ProcessGroupMesh, init_process_mesh
    from repro_torch.core.mesh import FSDP_BYTES, FSDP_CALLS, reset_collectives
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    init_process_mesh(rank, world, init_method, device="cpu")
    try:
        meshes = {grid: ProcessGroupMesh(device="cpu", grid=grid, axis_names=names) for grid, names in GRIDS.items()}
        out = {"coords": {g: tuple(m.coords(rank)[a] for a in m.axis_names) for g, m in meshes.items()},
               "blocks": {}, "step": {}, "moved": {}, "counted": {}}
        for arch in FSDP_ARCHS:
            state_np, specs = inputs["init"][arch]
            cfg = fsdp_cfg(arch)
            for grid, mesh in meshes.items():
                model = Model(cfg, mesh, device="cpu")
                out["blocks"][(arch, grid)] = _blocks(mesh, model, state_np, specs, cfg)
                kinds = ("plain", "masked") if grid in FSDP_GRIDS else ("plain",)
                for kind in kinds:
                    reset_collectives()
                    out["step"][(arch, grid, kind)] = _step(model, state_np, specs, cfg, fsdp_batches(cfg)[kind])
                    out["moved"][(arch, grid, kind)] = (dict(FSDP_BYTES), dict(FSDP_CALLS))
                    out["counted"][(arch, grid, kind)] = _counted()
                if grid in FSDP_GRIDS:
                    out["moved"][(arch, grid, "serve")] = _serve_moved(model, state_np, specs, cfg)
        out["collectives"] = {case: _collective_grads(*case, meshes[(2, 2)]) for case in COLLECTIVES}
        out["psum"] = _psum_counted(meshes[(2, 2)])
        out["moved_more"] = {arch: _moved_more(arch, meshes[(2, 2)]) for arch in MORE_ARCHS}
        out["ckpt"] = _ckpt_cases(rank, meshes[(2, 2)], inputs, out_dir)
        out["launcher"] = _launcher_cases(out_dir)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.array(out, dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return train_reference(tmp_path_factory)["fsdp"]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The one spawn of P = 4 gloo processes: each rank's results."""
    import torch.multiprocessing as mp

    from repro.checkpoint import CheckpointManager as RCheckpointManager
    from repro.optim import adamw as radamw
    from repro.train import TrainState as RTrainState
    from repro_torch.optim.adamw import tree_map

    tmp = tmp_path_factory.mktemp("fsdp")
    with one_thread():
        init = {arch: fsdp_init(arch) for arch in FSDP_ARCHS}
    # a reference checkpoint (whole leaves in proc0.npz) of a state unlike the initial one
    ref_state = init[CKPT_ARCH][0]
    ref_state = ref_state._replace(params=tree_map(lambda a: a * 2.0, ref_state.params),
                                   step=np.array(2, np.int32))
    RCheckpointManager(str(tmp / "ref_ckpt")).save(2, RTrainState(ref_state.params, radamw.AdamWState(
        ref_state.opt.count, ref_state.opt.mu, ref_state.opt.nu), ref_state.step), blocking=True)
    inputs = {"init": init, "ref_ckpt": str(tmp / "ref_ckpt"), "ref_state": ref_state}
    mp.spawn(_gloo_worker, args=(P, f"file://{tmp / 'rendezvous'}", str(tmp), inputs), nprocs=P, join=True)
    return [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item() for r in range(P)]


def _axes(entry, shape):
    """A spec entry's axes of more than one rank (an axis of one places
    nothing)."""
    axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in axes if shape[a] > 1)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_rank_blocks_are_the_reference_shards(reference, gloo, arch):
    """``train.state_placement`` (FSDP over ``('pod', 'data')``, row major,
    x TP over ``model``) is ``state_shardings(mesh, specs,
    abstract_state)``'s spec for every leaf, and each rank's block of
    every leaf (``train_state_from_numpy(mesh=)``, and
    ``place_train_state`` of the whole state) the reference's shard on the
    device of the same mesh coordinates: on (2, 2), (4, 1) and (2, 1, 2).
    DEPARTURES lists the leaves the port places otherwise by design; on
    one of the meshes each of them does differ."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.train import state_placement

    state_np, specs = fsdp_init(arch)
    differ = set()
    for grid, names in GRIDS.items():
        mesh = MeshShape(grid, names)
        placed = flat(state_placement(mesh, specs, state_np, fsdp_cfg(arch)).params)
        for name, spec in reference[("specs", arch, grid)].items():
            spec = spec + (None,) * (len(placed[name]) - len(spec))
            if [_axes(e, mesh.shape) for e in placed[name]] != [_axes(e, mesh.shape) for e in spec]:
                differ.add(name)
        ref = reference[("blocks", arch, grid)]
        for rank in gloo:
            got = rank["blocks"][(arch, grid)]
            assert sorted(got) == sorted(ref)
            for name, idx in got.items():
                if _ranges(idx) != ref[name][rank["coords"][grid]]:
                    differ.add(name)
    assert differ == DEPARTURES.get(arch, set())


@pytest.mark.parametrize("grid", list(FSDP_GRIDS))
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_step_over_the_grid_matches_the_reference(reference, gloo, arch, grid):
    """One step over the grid of processes, FSDP x TP with microbatch 2 in
    float32, against the reference's ``jit_train_step`` on a host mesh of
    the same shape, on the plain batch and on the one with -1 labels in
    one data block: each rank's block of every leaf's gradient (the first
    moment, ``(1 - b1)`` times the clipped gradient) within 1e-5 of the
    leaf's largest entry (the port's blocks: heads whole, DEPARTURES), the
    updated weights within 1e-5 (and Adam's
    amplification of the gradients' disagreement), the loss and the
    gradient norm within 1e-6 and the same on every rank."""
    for kind in ("plain", "masked"):
        params, mu, metrics = reference[("step", arch, grid, kind)]
        b1 = fsdp_tcfg().b1
        rho = grad_noise([{k: v / (1 - b1) for k, v in mu.items()}])
        runs = [rank["step"][(arch, grid, kind)] for rank in gloo]
        for got_m, got_p, got_mu in runs:
            for k in ("loss", "grad_norm"):
                assert abs(got_m[k] - metrics[k]) <= 1e-6 * abs(metrics[k]), (kind, k, got_m[k], metrics[k])
            assert got_m == runs[0][0], kind  # every rank's metrics, bitwise
        for rank, (_, got_p, got_mu) in zip(gloo, runs):
            idx = rank["blocks"][(arch, grid)]
            own = lambda tree: {n: tree[n][np.ix_(*idx[n])] for n in tree}  # noqa: E731
            exp_mu = own(mu)
            tol = GRAD_TOL.get((arch, grid), 1e-5)
            for name, e in exp_mu.items():
                err, top = np.abs(got_mu[name] - e).max(), np.abs(mu[name]).max()
                assert err <= tol * top, (kind, name, float(err), float(top))
            assert_flat_params_match(got_p, own(params), 1e-5, [metrics["lr"]], own(rho))


def test_ring_cell_is_sim_mesh_s(gloo):
    """DeepSeek-V3's ring dispatch over the (2, 2) grid of processes
    against ``SimMesh((2, 2))`` (every rank in one autograd graph, every
    weight whole, no FSDP gather) from the same state: each rank's block
    of every leaf's first moment within 1e-5 of the leaf's largest entry,
    the metrics within 1e-6."""
    from repro_torch.core import SimMesh
    from repro_torch.models.model import Model

    state_np, specs = fsdp_init(RING_ARCH)
    cfg = fsdp_cfg(RING_ARCH)
    for kind in ("plain", "masked"):
        with one_thread():
            model = Model(cfg, SimMesh((2, 2), axis_names=("data", "model"), device="cpu"), device="cpu")
            metrics, _, mu = _step(model, state_np, specs, cfg, fsdp_batches(cfg)[kind])
        for rank in gloo:
            got_m, _, got_mu = rank["step"][(RING_ARCH, (2, 2), kind)]
            for k in ("loss", "grad_norm"):
                assert abs(got_m[k] - metrics[k]) <= 1e-6 * abs(metrics[k]), (kind, k)
            idx = rank["blocks"][(RING_ARCH, (2, 2))]
            for name, e in mu.items():
                err = np.abs(got_mu[name] - e[np.ix_(*idx[name])]).max()
                assert err <= 1e-5 * np.abs(e).max(), (kind, name, float(err))


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_pod_data_model_grid_matches_the_data_model_grid(gloo, arch):
    """A three-axis ``('pod', 'data', 'model')`` grid of (2, 1, 2): the
    batch and the FSDP blocks over ``('pod', 'data')``, row major. Its
    step is the (2, 2) grid's (the same data groups, the same rings):
    every rank's metrics and blocks bitwise equal."""
    for rank in gloo:
        a, b = rank["step"][(arch, POD_GRID[0], "plain")], rank["step"][(arch, (2, 2), "plain")]
        assert a[0] == b[0]
        for got, exp in zip(a[1:], b[1:]):
            assert sorted(got) == sorted(exp)
            assert all(np.array_equal(got[n], exp[n]) for n in exp)


@pytest.mark.parametrize("grid", list(FSDP_GRIDS))
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_state_collectives_are_the_dry_runs(gloo, arch, grid):
    """What ``core.mesh.FSDP_BYTES`` and ``FSDP_CALLS`` counted on every
    rank in each step over the grid (FSDP's all-gathers and
    reduce-scatters, the all-reduces over the batch axes) and in one
    prefill and one decode step of the placed weights (their gathers) is
    ``launch.dryrun.cell_report``'s prediction at the same config,
    batch, microbatch and grid, bytes and counts of each kind, exactly."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    mesh, cfg = MeshShape(grid, FSDP_GRIDS[grid]), fsdp_cfg(arch)
    shapes = {"train": ShapeConfig("train", FSDP_SEQ, FSDP_BATCH, "train"),
              "prefill": ShapeConfig("prefill", SERVE_PROMPT, SERVE_BATCH, "prefill"),
              "decode": ShapeConfig("decode", SERVE_CACHE, SERVE_BATCH, "decode")}
    walk = {k: dryrun.cell_report(cfg, shape, mesh, tcfg=fsdp_tcfg())["collectives"]["state"]
            for k, shape in shapes.items()}
    for rank in gloo:
        for kind in ("plain", "masked"):
            moved, calls = rank["moved"][(arch, grid, kind)]
            assert (moved, calls) == (_fsdp_names(walk["train"]["bytes"]), _fsdp_names(walk["train"]["counts"])), kind
            assert _entry(rank["counted"][(arch, grid, kind)]["state"]) == _entry(walk["train"]), kind
        for kind, (moved, calls, counted) in rank["moved"][(arch, grid, "serve")].items():
            assert (moved, calls) == (_fsdp_names(walk[kind]["bytes"]), _fsdp_names(walk[kind]["counts"])), kind
            assert _entry(counted["state"]) == _entry(walk[kind]), kind
    assert all(_fsdp_names(walk["train"]["bytes"]).get(k) for k in STATE_KINDS.values())
    assert walk["prefill"]["bytes"]["all-gather"]


@pytest.mark.parametrize("arch", MORE_ARCHS)
def test_state_collectives_of_more_families_are_the_dry_runs(gloo, arch):
    """One step over the (2, 2) grid of the families FSDP_ARCHS leave out:
    what every rank counted is ``launch.dryrun.cell_report``'s
    prediction, bytes and counts of each kind, exactly."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    walk = dryrun.cell_report(cfg, ShapeConfig("train", FSDP_SEQ, FSDP_BATCH, "train"),
                              MeshShape((2, 2), FSDP_GRIDS[(2, 2)]), tcfg=fsdp_tcfg())["collectives"]
    expected = tuple(_fsdp_names(walk["state"][part]) for part in ("bytes", "counts"))
    assert expected[0]["all_gather"] and expected[0]["all_reduce"]
    for rank in gloo:
        assert rank["moved_more"][arch][:2] == expected
        assert _entry(rank["moved_more"][arch][2]["state"]) == _entry(walk["state"])


#: ``FSDP_BYTES``' kind names, by the reference's names the dry run reports
STATE_KINDS = {"all-gather": "all_gather", "reduce-scatter": "reduce_scatter", "all-reduce": "all_reduce"}


def _fsdp_names(by_kind):
    """A state entry's nonzero kinds under ``FSDP_BYTES``' names (the state
    collectives are of those three kinds only)."""
    assert all(not v for k, v in by_kind.items() if k not in STATE_KINDS), by_kind
    return {STATE_KINDS[k]: v for k, v in by_kind.items() if v}


def _entry(d):
    """(counts, bytes) of a ``collectives`` entry, without its scope."""
    return d["counts"], d["bytes"]


def _serve_shape(kind, grid):
    """The serving cell whose rank rows are SERVE_BATCH (every rank of the
    spawn serves the same SERVE_BATCH rows): the walk splits a cell's
    batch over ``data``."""
    from repro_torch.configs import ShapeConfig

    seq = SERVE_PROMPT if kind == "prefill" else SERVE_CACHE
    return ShapeConfig(kind, seq, SERVE_BATCH * grid[0], kind)


@pytest.mark.parametrize("grid", list(FSDP_GRIDS))
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_activation_collectives_are_the_dry_runs(gloo, arch, grid):
    """Every collective beside the state's that a rank issued
    (``core.mesh.collectives("activation")``: the tensor-parallel psums
    and Megatron "f" all-reduces, the sequence-parallel rings' hops, the
    vocabulary's and the context partition's gathers, the MoE dispatch's
    gathers and ring hops and its aux over ``data``, the SSM split's
    psums, the clip's norm over ``model``) in the plain and the masked
    step (microbatch 2, remat's recompute and the backward included) and
    in one prefill and one decode step is ``launch.dryrun``'s
    ``activation`` entry at the same config, rows and grid, bytes and
    counts of each kind, exactly, on every rank; on (4, 1) there is none."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    mesh, cfg = MeshShape(grid, FSDP_GRIDS[grid]), fsdp_cfg(arch)
    walk = {"train": dryrun.cell_report(cfg, ShapeConfig("train", FSDP_SEQ, FSDP_BATCH, "train"), mesh,
                                        tcfg=fsdp_tcfg())["collectives"]["activation"]}
    for kind in ("prefill", "decode"):
        walk[kind] = dryrun.cell_report(cfg, _serve_shape(kind, grid), mesh)["collectives"]["activation"]
    for rank in gloo:
        for kind in ("plain", "masked"):
            assert _entry(rank["counted"][(arch, grid, kind)]["activation"]) == _entry(walk["train"]), kind
        for kind, (_, _, counted) in rank["moved"][(arch, grid, "serve")].items():
            assert _entry(counted["activation"]) == _entry(walk[kind]), kind
    if grid[1] == 1:
        assert not any(v for w in walk.values() for v in w["counts"].values())
    else:
        assert walk["train"]["counts"]["all-reduce"] and walk["prefill"]["bytes"]["all-reduce"]


@pytest.mark.parametrize("arch", MORE_ARCHS)
def test_activation_collectives_of_more_families_are_the_dry_runs(gloo, arch):
    """The step over the (2, 2) grid of the families FSDP_ARCHS leave out
    (gemma2's post-norms, whisper's encoder and cross K / V, the vision
    stub's embeddings in, xLSTM's heads and sLSTM): every rank's
    activation collectives are the dry run's ``activation`` entry,
    exactly."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    walk = dryrun.cell_report(cfg, ShapeConfig("train", FSDP_SEQ, FSDP_BATCH, "train"),
                              MeshShape((2, 2), FSDP_GRIDS[(2, 2)]), tcfg=fsdp_tcfg())["collectives"]["activation"]
    assert walk["counts"]["all-reduce"]
    for rank in gloo:
        assert _entry(rank["moved_more"][arch][2]["activation"]) == _entry(walk)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_sim_mesh_counts_what_a_process_rank_counts(gloo, arch):
    """``SimMesh((1, 2))`` -- both ``model`` ranks in one process, on one
    (2, 2) rank's rows (half the batch) -- counts over ``model`` what
    each gloo rank of the (2, 2) grid counted there (its rings', psums',
    gathers' and "f" all-reduces' one rank's share), in the plain step and
    in one prefill and one decode step, but for the train step's clip
    norm over ``model``, which only a process holding its blocks takes;
    and what it counts is the walk's with ``one_process``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import SimMesh, sharding
    from repro_torch.core.mesh import collectives, reset_collectives
    from repro_torch.data import make_batch_arrays
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.model import Model, params_from_numpy
    from repro_torch.train import make_train_step, train_state_from_numpy

    state_np, _ = fsdp_init(arch)
    cfg = fsdp_cfg(arch)
    sim = SimMesh((1, 2), axis_names=("data", "model"), device="cpu")
    model = Model(cfg, sim, device="cpu")
    rows = {k: v[: FSDP_BATCH // 2] for k, v in fsdp_batches(cfg)["plain"].items()}
    got = {}
    with one_thread():
        reset_collectives()
        make_train_step(model, fsdp_tcfg(), sim)(train_state_from_numpy(state_np, "cpu"),
                                                 make_batch_arrays(rows, device="cpu"))
        got["train"] = collectives("activation")
        params = params_from_numpy(state_np.params, "cpu")
        tokens = torch.arange(SERVE_BATCH * SERVE_PROMPT).reshape(SERVE_BATCH, SERVE_PROMPT) % cfg.vocab_size
        state = model.init_decode_state(SERVE_BATCH, SERVE_CACHE)
        reset_collectives()
        state, _ = model.prefill(params, {"tokens": tokens}, state)
        got["prefill"] = collectives("activation")
        reset_collectives()
        model.decode_step(params, tokens[:, :1], state)
        got["decode"] = collectives("activation")
    shapes = {"train": ShapeConfig("train", FSDP_SEQ, FSDP_BATCH // 2, "train"),
              "prefill": _serve_shape("prefill", (1, 2)), "decode": _serve_shape("decode", (1, 2))}
    for kind, shape in shapes.items():
        assert _entry(got[kind]) == _entry(dryrun.cell_report(cfg, shape, sim, tcfg=fsdp_tcfg(), one_process=True)
                                           ["collectives"]["activation"]), kind
    # the clip's norm: one float32 all-reduce a set of leaves placed on model alone
    grid = MeshShape((2, 2), FSDP_GRIDS[(2, 2)])
    clip = sum(1 for p in {sharding.placed_axes(leaf.where) for leaf in dryrun.weight_leaves(cfg, grid)}
               if p == ("model",))
    got["train"]["counts"]["all-reduce"] += clip
    got["train"]["bytes"]["all-reduce"] += 4 * clip
    for rank in gloo:
        counted = {"train": rank["counted"][(arch, (2, 2), "plain")]["model"],
                   **{k: v[2]["model"] for k, v in rank["moved"][(arch, (2, 2), "serve")].items()}}
        for kind, entry in counted.items():
            assert _entry(entry) == _entry(got[kind]), kind


def test_psum_is_counted_over_batch_axes_alike(gloo):
    """A psum over a batch axis counts its block once in ``FSDP_BYTES``
    (one all-reduce in ``FSDP_CALLS``) on a rank of the gloo grid and on
    ``SimMesh((2, 2))`` alike; one over ``model`` alone is no state
    collective and counts nothing."""
    from repro_torch.core import SimMesh

    sim = SimMesh((2, 2), axis_names=("data", "model"), device="cpu")
    expected = _psum_counted(sim)
    assert expected["data"] == ({"all_reduce": 60}, {"all_reduce": 1}) and expected["model"] == ({}, {})
    for rank in gloo:
        assert rank["psum"] == expected


@pytest.mark.parametrize("op,axes", COLLECTIVES)
def test_fsdp_collectives_over_gloo_match_sim_mesh(gloo, op, axes):
    """``all_gather_fsdp`` (forward: the ring's blocks along a dim;
    backward: a reduce-scatter, since each rank uses the gathered tensor
    on its own rows) and ``psum_scatter`` (backward: the all-gather of the
    slices' gradients) over one axis and over a tuple of axes of the
    (2, 2) grid: each rank's output and its block's gradient are
    ``SimMesh((2, 2))``'s one autograd graph's."""
    from repro_torch.core import SimMesh

    with one_thread():
        grads, outs = _collective_grads(op, axes, SimMesh((2, 2), axis_names=("data", "model"), device="cpu"))
    for r, rank in enumerate(gloo):
        g, y = rank["collectives"][(op, axes)]
        assert np.abs(y[0] - outs[r]).max() <= 1e-6 * np.abs(outs[r]).max(), (op, axes, r)
        assert np.abs(g[0] - grads[r]).max() <= 1e-6 * np.abs(grads[r]).max(), (op, axes, r)


def test_placed_checkpoint_restores_on_any_mesh(gloo):
    """A checkpoint of the placed state written on (2, 2) -- each rank its
    ``proc<k>.npz``, rank 0's manifest last -- restores bitwise onto
    (4, 1), onto (1, 2) (the survivors of an elastic shrink) and onto one
    rank (whole leaves); the reference's checkpoint of whole leaves
    restores onto (2, 2)."""
    for r, rank in enumerate(gloo):
        cases, _ = rank["ckpt"]
        expected = {"(4, 1)", "one rank", "reference onto (2, 2)"} | ({"(1, 2)"} if r < 2 else set())
        assert set(cases) == expected and all(cases.values()), (r, cases)


def test_step_missing_one_rank_file_is_skipped_by_every_rank(gloo):
    """Step 5's directory lost ``proc3.npz``: every rank, rank 3's peers
    too, skips it and restores step 4."""
    assert [rank["ckpt"][1] for rank in gloo] == [4] * P


def test_launcher_over_processes_recovers_bitwise(gloo):
    """``launch.train`` over the P = 4 world, ``--model-parallel 2``:
    FSDP x TP on the (2, 2) grid with per-rank checkpoints. A failure
    injected at step 3 restarts (under ``--elastic``, on the grid of the
    survivors ``elastic_mesh`` joins) from step 2's placed checkpoint,
    and the run ends bitwise where the plain run without a failure ends
    (every rank's final ``proc<k>.npz``); the loss history is the same on
    every rank."""
    for rank in gloo:
        (failed, clean), same = rank["launcher"]
        assert same
        assert failed["restarts"] == 1 and clean["restarts"] == 0
        assert len(failed["loss"]) == 5 and len(clean["loss"]) == 4  # steps 0-2, then 2-3 from step 2's checkpoint
        assert failed["loss"][-2:] == clean["loss"][-2:] and np.isfinite(clean["loss"]).all()
        assert failed["loss"] == gloo[0]["launcher"][0][0]["loss"]
        assert clean["loss"] == gloo[0]["launcher"][0][1]["loss"]


# ------------------------------------------------------------- launch/specs.py

#: the reference's dry-run cells (``repro/launch/dryrun.py`` ``cells``:
#: every arch x shape, long_500k only for its LONG_OK archs); the module
#: itself is not imported, since it sets a 512-device XLA_FLAGS on import
LONG_OK = ("xlstm-1.3b", "hymba-1.5b")


def _dryrun_cells():
    from repro.configs import SHAPES, _MODULES

    return [(arch, s) for arch in _MODULES for s in SHAPES if s != "long_500k" or arch in LONG_OK]


def _spec_tuple(spec, ndim):
    out = tuple(spec)
    return out + (None,) * (ndim - len(out))


def _flat_specs(tree, path=()):
    """``{dotted path: spec}`` of the port's spec tree (dicts and
    NamedTuples), as the reference names its pytree's paths."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat_specs(tree[key], path + (str(key),)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f, sub in zip(tree._fields, tree) for k, v in _flat_specs(sub, path + (f,)).items()}
    return {".".join(path): tree}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_launch_specs_match_the_reference(multi_pod):
    """``launch.specs`` against ``repro.launch.specs`` for every arch x
    shape cell of the reference's dry run, on the single and the
    multi-pod production mesh (the port's shape-only
    ``make_production_mesh``, the reference's as an ``AbstractMesh`` of
    the same axes): every input's shape, dtype and spec
    (``batch_input_specs``), and every decode-state leaf's spec
    (``decode_state_shardings`` of the reference's ``_leaf_spec`` +
    ``sanitize_spec`` on ``jax.eval_shape`` of its state, the port's on
    its ``meta``-device state); ``core.sharding.batch_placement`` against
    ``batch_sharding``. Pure: no device."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    from repro.launch import specs as rspecs
    from repro.models.model import Model as RModel
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import Model

    from repro.core.sharding import batch_sharding
    from repro_torch.core.sharding import batch_placement

    mesh = make_production_mesh(multi_pod)
    assert mesh.dims == ((2, 16, 16) if multi_pod else (16, 16)) and mesh.size == (512 if multi_pod else 256)
    rmesh = AbstractMesh(mesh.dims, mesh.axis_names)
    assert batch_placement(mesh, 2) == tuple(batch_sharding(rmesh, 2).spec)
    for arch, sname in _dryrun_cells():
        cfg, shape = get_config(arch), SHAPES[sname]
        rcfg, rshape = rget(arch), RSHAPES[sname]
        b, s = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            got = specs.batch_input_specs(cfg, shape, mesh)
            exp = rspecs.batch_input_specs(rcfg, rshape, rmesh)
            assert sorted(got) == sorted(exp), (arch, sname)
            for k, (shp, dtype, spec) in got.items():
                e = exp[k]
                assert (shp, dtype, spec) == (tuple(e.shape), str(e.dtype), _spec_tuple(e.sharding.spec, len(shp))), \
                    (arch, sname, k)
        if shape.kind in ("prefill", "decode"):
            kw = dict(replicate_batch=(b == 1), seq_shard=(sname == "long_500k"))
            state = specs.abstract_decode_state(Model(cfg, device="meta"), b, s)
            got = _flat_specs(specs.decode_state_shardings(state, mesh, **kw))
            rstate = rspecs.abstract_decode_state(RModel(rcfg), b, s)
            rsh = rspecs.decode_state_shardings(rstate, rmesh, **kw)
            exp = {}
            for path, sh in jax.tree_util.tree_flatten_with_path(rsh)[0]:
                name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path)
                exp[name] = sh.spec
            shapes = {n: np.shape(a) for n, a in _flat_specs(state).items()}
            assert sorted(got) == sorted(exp), (arch, sname, sorted(got), sorted(exp))
            for name, spec in got.items():
                assert spec == _spec_tuple(exp[name], len(shapes[name])), (arch, sname, name, spec, exp[name])
