"""Train-step factory, ported from ``repro.train.step``: loss -> grads ->
clip -> AdamW, with microbatch accumulation.

Two step flavors:

- :func:`make_train_step`: the reference's ``jit_train_step`` -- the
  batch over ``('pod', 'data')``, the weights FSDP x TP -- with the
  collectives GSPMD would insert made explicit. On one rank; on a
  ``SimMesh`` of any shape (its ranks sit in this process, one autograd
  graph, the whole batch, every weight whole); or SPMD on a
  ``ProcessGroupMesh``: every rank passes the same whole batch and the
  state holds the rank's blocks (:func:`state_placement`). Over the
  ``model`` axis the layers are tensor-parallel (``models.common.TP``).
  Over the ``('pod', 'data')`` axes a rank takes, in each microbatch,
  that microbatch's block of rows at its (row-major) coordinate -- the
  reference splits the microbatches first and the jit then groups each
  by data-parallel shard, which decides the MoE capacity groups; the
  model gathers each layer's FSDP blocks whole just before the layer
  (the gather's backward reduce-scatters their gradients), the loss is
  the global masked mean (``Model.loss``), and a leaf replicated over a
  batch axis gets its gradient summed over it (one all-reduce a set of
  axes). Then one clip by the norm over the whole mesh
  (``optim.adamw.global_norm`` by ``Model.sharded_leaves``) and AdamW in
  place on the blocks.
- :func:`make_ddp_compressed_step`: the explicit data-parallel step whose
  gradient all-reduce is the int8 error-feedback all-gather
  (``optim.compress``) -- the paper's decomposed-collective idea applied
  to the optimizer's traffic. The weights are replicated; each data rank
  takes its block of the batch, and every rank clips and updates the
  same reduced gradient, so the replicas stay equal bit for bit.

Both steps update the state's tensors in place (``adamw.update(...,
inplace=True)``: the reference donates its state buffers to the jitted
step) and return the state with ``step + 1``. The gradients come from
``torch.autograd.grad`` on detached aliases of the float32 master
weights; a leaf the loss does not reach gets a zero gradient, as
``jax.grad`` gives.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import sharding
from repro_torch.core.mesh import resolve_device
from repro_torch.models.model import Model, placements, rank_blocks
from repro_torch.optim import adamw, compress, schedule
from repro_torch.optim.adamw import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor  # () int32


def init_train_state(model: Model, generator: torch.Generator, tcfg: TrainConfig) -> Tuple[TrainState, Any]:
    """Float32 master weights from ``generator`` (on the model's device)
    and a zero AdamW state in ``tcfg.opt_state_dtype``. On a
    ``ProcessGroupMesh`` the weights and both moments are the rank's
    blocks (``Model.init`` draws every leaf as one rank does and keeps
    its block)."""
    params, specs = model.init(generator)
    opt = adamw.init(params, tcfg.opt_state_dtype)
    return TrainState(params=params, opt=opt, step=torch.zeros((), dtype=torch.int32, device=model.device)), specs


def state_placement(mesh, specs, abstract_state: TrainState, cfg=None) -> TrainState:
    """The reference's ``state_shardings(mesh, specs, abstract_state)``:
    each leaf's partition spec on ``mesh`` (``core.sharding.placement``
    of its logical spec and whole shape -- FSDP x TP, heads whole where
    ``cfg``'s head counts place them), the moments as the weights, the
    scalars replicated. ``abstract_state``: the whole state, or its
    shapes (the ``meta`` device)."""
    p = placements(abstract_state.params, mesh=mesh, specs=specs, cfg=cfg)
    return TrainState(params=p, opt=adamw.AdamWState(count=(), mu=p, nu=p), step=())


def place_train_state(state: TrainState, *, mesh, specs, cfg=None) -> TrainState:
    """A whole ``TrainState`` (tensors) cut to this rank's blocks on
    ``mesh`` under :func:`state_placement` -- ``jit_train_step``'s
    ``in_shardings`` as explicit copies; the whole state itself on a
    ``SimMesh`` or without a mesh."""
    place = dict(mesh=mesh, specs=specs, cfg=cfg)
    return TrainState(rank_blocks(state.params, **place),
                      adamw.AdamWState(state.opt.count, rank_blocks(state.opt.mu, **place),
                                       rank_blocks(state.opt.nu, **place)), state.step)


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])) for k, v in batch.items()}


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        return model.loss(params, batch)

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)``, the metrics detached."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def _lr(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    return schedule.warmup_cosine(step, peak=tcfg.learning_rate, warmup=tcfg.warmup_steps, total=tcfg.total_steps)


def _step_mesh(model: Model, mesh):
    """The mesh the step runs over: the model's own (``mesh``, where
    given, must be it)."""
    if mesh is not None and mesh is not model.mesh:
        raise ValueError(f"the step runs over the model's mesh ({model.mesh}), not {mesh}: build Model(cfg, mesh)")
    return model.mesh


def _rows(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """Block ``i`` of ``n`` of every input's rows."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k!r} has {v.shape[0]} rows, which the {n} ranks of the batch axes do not split")
        m = v.shape[0] // n
        out[k] = v[i * m:(i + 1) * m]
    return out


def microbatch_rows(batch: Dict[str, torch.Tensor], microbatch: int, index: int = 0,
                    count: int = 1) -> List[Dict[str, torch.Tensor]]:
    """The rows a rank at ``index`` of ``count`` on the batch axes trains
    on, one dict a microbatch: the reference's ``_split_micro`` first
    (microbatch ``i`` is the ``i``-th block of rows), then each
    microbatch's ``index``-th block of rows, as the jit shards each
    microbatch over ``('pod', 'data')`` -- so a rank's rows of a
    microbatch are the data group the MoE dispatch counts capacity on."""
    if not microbatch or microbatch <= 1:
        return [_rows(batch, index, count)]
    micro = _split_micro(batch, microbatch)
    return [_rows({k: v[i] for k, v in micro.items()}, index, count) for i in range(microbatch)]


def _sum_over_batch(model: Model, grads, placed: List[Tuple[str, ...]]):
    """Each gradient summed over the batch axes its leaf is replicated
    on (an FSDP leaf's own axes were summed by its gather's
    reduce-scatter): one all-reduce of the leaves side by side a set of
    axes."""
    flat = leaves(grads)
    out = list(flat)
    missing = [tuple(a for a in model.batch_axes if a not in axes) for axes in placed]
    for axes in dict.fromkeys(m for m in missing if m):
        idx = [i for i, m in enumerate(missing) if m == axes]
        for dtype in dict.fromkeys(flat[i].dtype for i in idx):
            part = [i for i in idx if flat[i].dtype == dtype]
            buf = torch.cat([flat[i].reshape(-1) for i in part])
            buf = model.mesh.psum([buf], axes)[0]
            at = 0
            for i in part:
                out[i] = buf[at:at + flat[i].numel()].view(flat[i].shape)
                at += flat[i].numel()
    return unflatten(grads, out)


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``: the lr from
    ``warmup_cosine`` at ``state.step``, the loss and its gradients (with
    ``tcfg.microbatch > 1``: float32 gradients accumulated over the
    microbatches, then divided), ``clip_by_global_norm``, the AdamW
    update in place, ``step + 1``. Metrics: the loss's own, ``grad_norm``
    and ``lr``, the same on every rank. ``mesh`` is the model's
    (``Model(cfg, mesh)``) or None; on a ``ProcessGroupMesh`` every rank
    passes the same whole batch and the state holds the rank's blocks
    (``init_train_state``, ``train_state_from_numpy(mesh=, specs=,
    cfg=)``, :func:`place_train_state`)."""
    mesh = _step_mesh(model, mesh)
    loss_fn = make_loss_fn(model)
    placed = model.sharded_leaves() if mesh is not None and mesh.caller_holds_block else None
    me, ranks = (mesh.axis_index(model.batch_axes), mesh.axis_size(model.batch_axes)) if model.batch_axes else (0, 1)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        lr = _lr(tcfg, state.step)
        rows = microbatch_rows(batch, tcfg.microbatch, me, ranks)
        if len(rows) > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), state.params)
            ltot = torch.zeros((), dtype=torch.float32, device=lr.device)
            for mb in rows:
                _, m, g = _value_and_grad(loss_fn, state.params, mb)
                grads = tree_map(torch.add, grads, g)
                ltot = ltot + m["loss"]
            grads = tree_map(lambda g: g / tcfg.microbatch, grads)
            metrics = {"loss": ltot / tcfg.microbatch}
        else:
            _, metrics, grads = _value_and_grad(loss_fn, state.params, rows[0])
        if model.batch_axes:
            grads = _sum_over_batch(model, grads, placed)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip, mesh, placed)
        params, opt = adamw.update(grads, state.opt, state.params, lr=lr, cfg=tcfg, inplace=True)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params, opt, state.step + 1), metrics

    return step


# ---------------------------------------------------------------------------
# explicit-DP step with the compressed all-gather (the paper's technique on
# the optimizer's collective)
# ---------------------------------------------------------------------------


class DDPState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    err: List[Any]  # one float32 residual tree per local rank of the data axis
    step: torch.Tensor


def init_ddp_state(model: Model, generator: torch.Generator, tcfg: TrainConfig, mesh=None) -> DDPState:
    """The weights, a zero AdamW state and zero error residuals: one
    residual tree per ``mesh.local_ranks()`` entry (each rank carries its
    own; one without a mesh, or on a ``ProcessGroupMesh``)."""
    params, _ = model.init(generator)
    ranks = 1 if mesh is None else len(mesh.local_ranks())
    return DDPState(
        params=params,
        opt=adamw.init(params, tcfg.opt_state_dtype),
        err=[compress.init_error_state(params) for _ in range(ranks)],
        step=torch.zeros((), dtype=torch.int32, device=model.device),
    )


def make_ddp_compressed_step(model: Model, tcfg: TrainConfig, mesh, axis_name: str = "data"):
    """Returns ``step(state, batch) -> (state, {"loss", "grad_norm"})``.
    ``batch`` is the global batch (every rank passes the same); each
    local rank takes its ``1/P`` block of the rows by its coordinate on
    ``axis_name`` and gets its gradients; then either
    ``compressed_psum_tree`` (``grad_compression="int8"``) or a mean over
    the axis (one ``psum`` a leaf), the loss's mean over the axis, then
    clip and update on the replicated weights."""
    loss_fn = make_loss_fn(model)
    n = mesh.axis_size(axis_name)
    ranks = mesh.local_ranks()

    def step(state: DDPState, batch):
        grads, losses = [], []
        for r in ranks:
            i = mesh.coords(r)[axis_name]
            rows = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for k, v in batch.items()}
            loss, _, g = _value_and_grad(loss_fn, state.params, rows)
            grads.append(g)
            losses.append(loss)
        if tcfg.grad_compression == "int8":
            reduced, new_err = compress.compressed_psum_tree(grads, mesh, axis_name, state.err)
            grads = reduced[0]  # the same on every local rank
        else:
            flat = [leaves(g) for g in grads]
            grads = unflatten(grads[0], [mesh.psum([f[j] for f in flat], axis_name)[0] / n
                                         for j in range(len(flat[0]))])
            new_err = state.err
        loss = mesh.psum(losses, axis_name)[0] / n
        lr = _lr(tcfg, state.step)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt = adamw.update(grads, state.opt, state.params, lr=lr, cfg=tcfg, inplace=True)
        return DDPState(params, opt, new_err, state.step + 1), {"loss": loss, "grad_norm": gnorm}

    return step


# ---------------------------------------------------------------------------
# carrying the reference's states across
# ---------------------------------------------------------------------------


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16: through float32, exactly
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree(tree, device, **place):
    """A tree's leaves as tensors on ``device``; with ``place`` (``mesh=,
    specs=, cfg=``) each leaf's block a process-group rank keeps
    (``models.model.rank_blocks``)."""
    if place:
        tree = rank_blocks(tree, **place)
    return {k: _tree(v, device) for k, v in tree.items()} if isinstance(tree, dict) else _tensor(tree, device)


def _opt(opt, device, **place) -> adamw.AdamWState:
    return adamw.AdamWState(count=_tensor(opt.count, device), mu=_tree(opt.mu, device, **place),
                            nu=_tree(opt.nu, device, **place))


def train_state_from_numpy(state, device=None, *, mesh=None, specs=None, cfg=None) -> TrainState:
    """The reference's ``TrainState`` (numpy or JAX leaves: weights,
    moments, count, step) as the port's, on ``device`` (default
    ``cuda``). On a ``ProcessGroupMesh`` of several ranks pass the
    weights' ``specs`` and the model's ``cfg``, as to
    ``params_from_numpy``: the weights and both AdamW moments keep this
    rank's blocks."""
    dev = resolve_device(device)
    place = dict(mesh=mesh, specs=specs, cfg=cfg) if mesh is not None else {}
    return TrainState(_tree(state.params, dev, **place), _opt(state.opt, dev, **place), _tensor(state.step, dev))


def ddp_state_from_numpy(state, device=None, ranks: int = 1) -> DDPState:
    """The reference's ``DDPState`` as the port's, its one residual tree
    copied to each of ``ranks`` local ranks."""
    dev = resolve_device(device)
    return DDPState(_tree(state.params, dev), _opt(state.opt, dev), [_tree(state.err, dev) for _ in range(ranks)],
                    _tensor(state.step, dev))
