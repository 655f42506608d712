"""Model assembly: embeddings -> layer groups -> head, ported from
``repro.models.model`` for the decoder LMs, dense or MoE (DeepSeek-V3's
dense prefix then its MoE group), with GQA or MLA attention, the SSM
and hybrid families: xLSTM (mLSTM + sLSTM pairs, or mLSTM layers alone
at ``slstm_every=0``) and hymba (attention beside Mamba heads in every
layer, behind the meta tokens), and the encoder-decoder (whisper: an
encoder group over frame embeddings, then a decoder group whose layers
cross-attend to the encoder's output).

Params of structurally identical layers are stacked along a leading
``(L, ...)`` axis, as in the reference (its ``lax.scan`` layout), so the
reference's parameter tree carries across unchanged
(:func:`params_from_numpy`); here a Python loop walks the layers, and a
per-layer Python ``bool`` from ``Group.flags`` picks the attention mask.

Public surface (on ``device``, default ``cuda``; tests pass ``"cpu"``):
    Model(cfg).init(generator, dtype=None) -> (params, specs)
    .loss(params, batch)                      train forward + CE (+MTP)
    .hidden(params, batch)                    (trunk (B, S, d), aux loss)
    .logits(params, batch)                    full logits (small shapes)
    .init_decode_state(b, s_max) / .prefill / .decode_step

The encoder-decoder's batch is ``{"enc_embeds": (B, S_enc, d), "tokens":
(B, S)}`` (the reference's stub of the conv front end: frame
embeddings); both streams get sinusoidal positions. Its prefill runs the
encoder once, keeps every decoder layer's cross K / V in
``state["cross"]`` (a ``blocks.CrossKV`` of (L, B, S_enc, KVH, hd), in
the model's dtype, unlike the bfloat16 self-attention cache) and fills
the decoder's cache from the prompt; ``decode_step`` reads them.

The decode state is one stacked tree a group: a ``KVCache`` /
``MLACache``, or for the SSM and hybrid groups the reference's
``HymbaState`` / ``XLSTMPairState`` / ``MLSTMBlockState`` of (L, B, ...)
tensors. Each layer works on views of its slice and its new state is
written back in place. ``init`` makes the MTP
head's weights when ``cfg.mtp_depth`` asks for them (the reference's
tree); ``loss`` runs them.

Training (``loss``): ``hidden`` records the autograd graph (serving's
``logits``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode``), each layer under ``_remat(cfg.remat)`` as the
reference's scan body; the cross-entropy is chunked
(``models.losses``), and the attention and Mamba scans have the
reference's custom backward passes.

On a mesh of several ranks (``SimMesh`` or, SPMD, one
``ProcessGroupMesh`` rank per process) every decoder runs
tensor-parallel over the ``model`` axis (``common.TP``): the attention
heads, the dense ``d_ff`` (the MLP, DeepSeek-V3's dense prefix, the
shared expert) and the vocabulary (embedding and unembedding) are split
by their specs through ``core.sharding.placement`` (heads whole: a
count the axis does not divide stays whole); the router and the norms
are whole; a MoE model's routed experts keep their ``"experts"``
placement, and ``models.moe.apply_moe`` moves the tokens between the
ranks. The activations are replicated after every psum; ``logits``,
``prefill`` and ``decode_step`` return the whole (gathered) logits.
``hidden`` runs the reference's Megatron sequence parallelism where
``cfg.seq_parallel`` and the axis divides the sequence: the residual
stream between the layers is each rank's sequence block, gathered into
each column-parallel projection by the ring all-gather
(``core.overlap``) and returned from each row-parallel one by the ring
reduce-scatter (whisper's encoder and decoder each decide on their own
length). The SSM and hybrid models keep the residual stream whole on
every rank (their recurrences need the whole sequence; the reference
constrains it back to whole, or batch-only, inside their blocks): their
mixers split by channel over the axis (``models.ssm``), hymba's
attention and FFN as the decoders'.

FSDP over the ``('pod', 'data')`` axes of a ``ProcessGroupMesh``
(``batch_axes``): a rank keeps its block of every ``"fsdp"`` dim
(``core.sharding.placement``) and the model gathers a layer's blocks
whole just before the layer runs -- inside the function ``_remat``
checkpoints, so the recompute gathers again and only the blocks live
between the layers -- and the embedding, the unembedding, the meta
tokens and the MTP module just before theirs (``mesh.gather_many``: one
all-gather, whose backward reduce-scatters the gradients; the norms have
no ``"fsdp"`` dim and stay whole). The process
computes on its own rows of the batch (``train.step``) through its
``model`` ring, and ``loss`` returns its share of the global masked
mean, its metrics the global values. On a ``SimMesh`` the ``data`` axis
holds the whole batch and every weight whole; the MoE dispatch counts
its capacity per data group either way.

Training over the ``model`` axis (``loss``): on a ``SimMesh`` every
rank's part lies in one autograd graph; on a ``ProcessGroupMesh`` each
rank's graph holds its own part, the collectives carry Megatron's
backward passes and ``common.TP.vary`` marks where a tensor the same on
every rank enters a rank's own compute (``core.mesh``), so each rank's
gradient of a leaf is that leaf's gradient of the one-rank model: the
whole leaf's for a leaf kept whole, its block's for a placed one
(:meth:`Model.sharded_leaves` names which).

On a ``ProcessGroupMesh`` a rank holds only its blocks, of the
``model`` and the ``('pod', 'data')`` axes (``init`` draws every leaf in
the one-rank order, one layer at a time, and keeps the rank's;
``params_from_numpy(mesh=, specs=, cfg=)`` cuts the reference's arrays;
a leaf of ``ssm.MESH_LAYOUT`` is placed as that table says), its
block of the KV caches (``attention.cache_block``: KV heads or head dim,
and with ``seq_shard`` its sequence block), its KV heads of the cross K
/ V and its channel blocks of the conv windows and Mamba states; on a
``SimMesh`` the stacks and the states stay whole and a rank's block is a
view.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sharding
from repro_torch.core.mesh import SimMesh, resolve_device
from repro_torch.models import attention, blocks, common, losses, ssm
from repro_torch.models.common import Deferred, Params, Specs


def _map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of dicts (specs: of name tuples)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_specs(specs, extra=(None,)):
    return _map(lambda t: tuple(extra) + tuple(t), specs)


def _layer(tree, i: int):
    """Layer ``i``'s params: views into the stacked ``(L, ...)`` leaves."""
    return _map(lambda a: a[i], tree)


def _unstack(tree, count: int) -> List[Any]:
    """Every layer's params of the stacked ``(L, ...)`` leaves: one
    ``unbind`` a leaf, whose backward stacks the layers' gradients once.
    (:func:`_layer`'s view a layer makes each layer's backward fill a zero
    gradient of the whole stack and add it: bytes in the square of the
    depth.)"""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(count)]
    return list(tree.unbind(0))


def _state_layer(state, i: int):
    """Layer ``i``'s views of a stacked decode state (``NamedTuple`` s of
    (L, ...) tensors, nested any way)."""
    if isinstance(state, tuple):
        return type(state)(*(_state_layer(s, i) for s in state))
    return state[i]


def _write_back(view, new) -> None:
    """A layer's new state into its views, leaf by leaf; a leaf the layer
    updated in place (the same tensor) is left as it is."""
    if isinstance(view, tuple):
        for v, n in zip(view, new):
            _write_back(v, n)
    elif new is not view:
        view.copy_(new)


def _stack_state(one, count: int):
    """``count`` copies of one layer's state, stacked along a new leading
    axis (every leaf a tensor of its own: the layers write in place)."""
    if isinstance(one, tuple):
        return type(one)(*(_stack_state(a, count) for a in one))
    out = one.new_empty((count,) + tuple(one.shape))
    out[:] = one
    return out


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    kind: str  # dec | dec_moe | hymba | xlstm_pair | enc
    count: int
    flags: Optional[Tuple[bool, ...]]  # per-layer is_global; None -> static
    static_global: bool = True
    cross: bool = False  # whisper decoder


def build_groups(cfg: ModelConfig) -> List[Group]:
    """Every family's layer groups, as the reference builds them."""
    L = cfg.num_layers
    if cfg.family == "ssm":  # xlstm
        every = cfg.ssm.slstm_every
        if every and every != 2:
            raise NotImplementedError("xlstm grouping implemented for slstm_every in (0, 2)")
        if every == 2:
            return [Group("pairs", "xlstm_pair", L // 2, None)]
        return [Group("mlstm", "xlstm_m", L, None)]

    def flags_for(pattern: str) -> Optional[Tuple[bool, ...]]:
        if cfg.window_size <= 0:
            return None  # full attention everywhere -> static global
        if pattern == "alternate":
            return tuple(i % 2 == 1 for i in range(L))
        if pattern == "ends":
            return tuple(i in (0, L // 2, L - 1) for i in range(L))
        return tuple(False for _ in range(L))  # SWA everywhere

    flags = flags_for(cfg.global_pattern)
    static = cfg.window_size <= 0
    groups: List[Group] = []
    if cfg.is_encdec:
        groups.append(Group("encoder", "enc", cfg.encoder_layers, None))
        groups.append(Group("decoder", "dec", L, None, static_global=True, cross=True))
        return groups
    if cfg.family == "hybrid":
        return [Group("hymba", "hymba", L, flags, static_global=static)]
    if cfg.moe is not None:
        fk = cfg.moe.first_k_dense
        if fk:
            groups.append(Group("dense_prefix", "dec", fk, None, static_global=static))
        gflags = None if flags is None else flags[fk:]
        groups.append(Group("moe", "dec_moe", L - fk, gflags, static_global=static))
        return groups
    return [Group("layers", "dec", L, flags, static_global=static)]


def _group_init_fn(g: Group, cfg: ModelConfig, generator: torch.Generator, device) -> Callable:
    """One layer's ``(params, specs)`` draw for group ``g``."""
    if g.kind in ("dec", "dec_moe"):
        return lambda: blocks.init_decoder_block(generator, cfg, device, use_moe=g.kind == "dec_moe", cross=g.cross)
    init = {"hymba": blocks.init_hymba_block, "xlstm_pair": blocks.init_xlstm_pair,
            "xlstm_m": blocks.init_xlstm_m, "enc": blocks.init_encoder_block}[g.kind]
    return lambda: init(generator, cfg, device)


#: the matrix products ``_remat(mode="dots")`` saves (``checkpoint_dots``)
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    name = getattr(op, "__name__", "").split(".")[0]
    return CheckpointPolicy.MUST_SAVE if name in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` under the reference's rematerialization ``mode``: "none" as
    it is, "full" recomputed in the backward from its inputs
    (``torch.utils.checkpoint``, non-reentrant), "dots" recomputed but
    for the matrix products' outputs, which are saved (a selective
    checkpoint policy: ``jax.checkpoint_policies.checkpoint_dots``)."""
    if mode == "none":
        return fn
    if mode == "full":
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False)
    if mode == "dots":
        if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
            raise NotImplementedError("remat='dots' needs torch.utils.checkpoint's selective checkpoint policies")
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    raise ValueError(f"unknown remat mode {mode!r}")


def head_units(cfg: ModelConfig) -> Dict[str, int]:
    """The head counts ``core.sharding.placement`` places whole."""
    return {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}


def _layout(path: str, spec) -> Tuple[tuple, int]:
    """(the spec a leaf at ``path`` is placed by over a mesh, the parts its
    split dim packs): its own spec and one part, but where
    ``ssm.MESH_LAYOUT`` names the leaf by its last two keys."""
    spec = tuple(spec)
    over = ssm.MESH_LAYOUT.get("/".join(path.split("/")[-2:]))
    if over is None:
        return spec, 1
    new, parts = over
    return (spec if new is None else (None,) * (len(spec) - len(new)) + tuple(new)), parts


def _where(mesh, spec, shape, units, path: str) -> Optional[List[sharding.Cut]]:
    """The cuts of the leaf at ``path`` a process keeps
    (``core.sharding.block`` of its :func:`_layout`), None where it keeps
    the whole leaf."""
    spec, parts = _layout(path, spec)
    return sharding.block(mesh, spec, shape, units, parts)


def _fsdp_dim(mesh, spec, shape, units, path: str) -> Optional[Tuple[int, Any]]:
    """(dim, axes) of the leaf at ``path`` placed over the ``('pod',
    'data')`` axes (FSDP: gathered whole along ``dim`` before use), None
    where no dim of it is."""
    if mesh is None or not mesh.caller_holds_block:
        return None
    spec, parts = _layout(path, spec)
    for dim, entry in enumerate(sharding.placement(mesh, spec, shape, units, parts)):
        if entry is not None and entry != "model":
            return dim, entry
    return None


def _keep(a: torch.Tensor, where: Optional[List[sharding.Cut]]) -> torch.Tensor:
    """``a``, or a copy of its block (a view would keep the whole leaf
    alive)."""
    if where is None:
        return a
    return sharding.take(a, where).clone(memory_format=torch.contiguous_format)


def _float_to(dtype):
    return lambda a: a.to(dtype) if a.is_floating_point() else a


def batch_axes(mesh) -> Tuple[str, ...]:
    """The ``('pod', 'data')`` axes of more than one rank of a mesh whose
    process holds its own blocks (a ``ProcessGroupMesh``): the axes the
    batch is split over between the processes and FSDP places the
    weights over. () on a ``SimMesh`` (one process holds every rank and
    the whole batch) and without a mesh."""
    if mesh is None or not mesh.caller_holds_block:
        return ()
    entry = sharding.batch_placement(mesh, 1)[0]
    axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
    return tuple(a for a in axes if mesh.shape[a] > 1)


@functools.lru_cache(maxsize=64)
def abstract(cfg: ModelConfig):
    """(the one-rank model's leaves on the ``meta`` device, its specs):
    the shapes and specs of ``cfg``'s parameter tree, no weight drawn;
    made once a config."""
    return Model(cfg, device="meta").init(torch.Generator())


class Model:
    """``cfg``'s model on ``mesh`` (or one device). ``groups``: the layer
    groups it holds (default :func:`build_groups`; the dry run traces a
    model of fewer layers of the same patterns). ``on_layer``: called with
    a group's name as a serving step takes each of its layers (the dry
    run's phases)."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, attn_impl: str = "chunked", device=None,
                 groups: Optional[List["Group"]] = None, on_layer: Optional[Callable[[str], None]] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's ranks are on {mesh.device}, the model on {self.device}")
        self.groups = build_groups(cfg) if groups is None else groups
        self.on_layer = on_layer
        self.dtype = getattr(torch, cfg.dtype)
        self.units = head_units(cfg)
        #: the ``('pod', 'data')`` axes of more than one rank of a
        #: ``ProcessGroupMesh``: the process trains on its rows of the batch
        #: and keeps its FSDP blocks; () where it holds the whole batch
        self.batch_axes = batch_axes(mesh)
        if self.batch_axes:  # the layers see the rank's ``model`` ring; the rows are the rank's own
            ring = mesh.rings("model")[0][0] if "model" in mesh.shape else SimMesh(1, "model", mesh.device)
            self.tp = common.TP(ring, batch=(mesh, self.batch_axes))
        else:
            self.tp = common.TP(mesh)
        #: the ``model`` axis as ``prefill`` and ``decode_step`` see it: with
        #: the cache's sequence over ``data`` where the last
        #: ``init_decode_state`` put it there (``seq_shard``)
        self.serve_tp = self.tp
        #: the tree of :func:`_fsdp_dim` of every leaf, where the process keeps FSDP blocks
        self._placed = None
        if self.batch_axes:
            shapes, specs = abstract(self.cfg)
            self._placed = _map2(lambda a, spec, path: _fsdp_dim(mesh, spec, a.shape, self.units, path), shapes, specs)

    def _cast(self, params):
        """Float params in the compute dtype. Idempotent: on a tree already
        cast (``init(dtype=)``, ``params_from_numpy(dtype=)``) it returns
        the same tensors, so the port casts once, at load."""
        if self.dtype == torch.float32:
            return params
        return _map(_float_to(self.dtype), params)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, *, dtype=None) -> Tuple[Params, Specs]:
        """Random weights from ``generator`` (on the model's device),
        float32 as the reference makes them, or cast into ``dtype``. The
        stacked layer leaves are made one layer at a time in float32 and
        copied into the ``(L, ...)`` stack, the MoE experts one expert at
        a time (``common.Deferred``), so a bfloat16 model never holds a
        float32 copy of more than one layer's dense leaves or one
        expert's matrix. On a ``ProcessGroupMesh`` every leaf is drawn
        as on one rank and the rank keeps its block
        (``core.sharding.block``): bitwise the one-rank model's slice."""
        cfg, dev = self.cfg, self.device
        cast = _float_to(dtype) if dtype is not None else (lambda a: a)

        def where(spec, shape, path):
            return _where(self.mesh, spec, shape, self.units, path)

        def keep(tree, specs, prefix=""):
            return _map2(lambda a, spec, path: cast(_keep(a, where(spec, a.shape, path))), tree, specs, prefix)

        def empty_stack(a, spec, path, count):
            src = torch.float32 if isinstance(a, Deferred) else a.dtype
            out_dtype = dtype if dtype is not None and src.is_floating_point else src
            shape = list(a.shape)
            for dim, _, n, parts in where(spec, shape, path) or ():
                shape[dim] = n * parts
            return torch.empty([count] + shape, dtype=out_dtype, device=dev)

        def stacked_blocks(count: int, draw: Callable):
            """``count`` blocks' params in (count, ...) stacks, drawn one
            layer at a time by ``draw``, and one block's specs."""
            layer, s = draw()  # its leaves give the stacks' shapes (a group may have no layer)
            out = _map2(lambda a, spec, path: empty_stack(a, spec, path, count), layer, s)
            for i in range(count):
                _copy_into(out, layer if i == 0 else draw()[0], s, i, generator, where)
                layer = None  # one layer's float32 draw at a time
            return out, s

        pe, se = common.init_embed(generator, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings, dev)
        params: Dict[str, Any] = {"embed": keep(pe, se)}
        specs: Dict[str, Any] = {"embed": se}
        del pe  # the float32 tables, before the layer stacks are made
        pn, sn = common.init_norm(cfg.d_model, cfg.norm_kind, dev)
        params["final_norm"], specs["final_norm"] = keep(pn, sn), sn
        if cfg.meta_tokens:
            meta = common.trunc_normal((cfg.meta_tokens, cfg.d_model), 1.0, generator=generator, device=dev)
            params["meta"], specs["meta"] = cast(_keep(meta, where((None, "fsdp"), meta.shape, "/meta"))), \
                (None, "fsdp")
        for g in self.groups:
            params[g.name], s = stacked_blocks(g.count, _group_init_fn(g, cfg, generator, dev))
            specs[g.name] = _stack_specs(s)
        if cfg.mtp_depth > 0:
            use_moe = cfg.moe is not None and cfg.moe.first_k_dense < cfg.num_layers
            block, sb = stacked_blocks(1, lambda: blocks.init_decoder_block(generator, cfg, dev, use_moe=use_moe))
            proj = common.dense_init((2 * cfg.d_model, cfg.d_model), generator=generator, device=dev)
            params["mtp"] = {
                "proj": cast(_keep(proj, where(("fsdp", None), proj.shape, "/mtp/proj"))),
                "block": _layer(block, 0),
                "norm_h": keep(*common.init_norm(cfg.d_model, cfg.norm_kind, dev)),
                "norm_e": keep(*common.init_norm(cfg.d_model, cfg.norm_kind, dev)),
            }
            specs["mtp"] = {"proj": ("fsdp", None), "block": sb, "norm_h": sn, "norm_e": sn}
        return params, specs

    def sharded_leaves(self) -> List[Tuple[str, ...]]:
        """The mesh axes each leaf of the model's parameter tree, in
        ``optim.adamw.leaves`` order, is placed over on this model's mesh
        -- a rank holds its block (``core.sharding.block`` through
        :func:`_where`, as :meth:`init` and :func:`params_from_numpy` place
        it) -- () for a leaf a rank holds whole: ``("model",)``, the
        ``('pod', 'data')`` axes of its FSDP dim, or both. All () without
        a mesh and on a ``SimMesh`` (every rank's block is a view of the
        whole leaf)."""
        from repro_torch.optim.adamw import leaves

        shapes, specs = abstract(self.cfg)

        def axes(a, spec, path):
            if _where(self.mesh, spec, a.shape, self.units, path) is None:
                return ()
            lay, parts = _layout(path, spec)
            return sharding.placed_axes(sharding.placement(self.mesh, lay, a.shape, self.units, parts))

        return leaves(_map2(axes, shapes, specs))

    def state_layout(self) -> Dict[str, Tuple[Tuple[int, ...], Optional[List[sharding.Cut]]]]:
        """Where a ``train.TrainState`` of this model lies on its mesh, by
        the checkpoint's leaf names (``params/...``, ``opt/mu/...``,
        ``opt/nu/...``, ``opt/count``, ``step``): each leaf's global shape
        and the cuts this process keeps (None for a whole leaf) -- what
        ``CheckpointManager.save`` / ``restore`` take as ``layout=``."""
        shapes, specs = abstract(self.cfg)
        layout: Dict[str, Tuple[Tuple[int, ...], Optional[List[sharding.Cut]]]] = {
            "opt/count": ((), None), "step": ((), None)}

        def put(a, spec, path):
            cuts = _where(self.mesh, spec, tuple(a.shape), self.units, path)
            for prefix in ("params", "opt/mu", "opt/nu"):
                layout[prefix + path] = (tuple(a.shape), cuts)

        _map2(put, shapes, specs)
        return layout

    def _whole(self, params, key: str):
        """``params[key]`` with its FSDP leaves gathered whole over their
        ``('pod', 'data')`` axes (``mesh.gather_many``: one all-gather, whose
        backward reduce-scatters the gradients); ``params[key]`` itself
        where the process holds its whole batch."""
        return self._gather(params[key], self._placed[key]) if self.batch_axes else params[key]

    def _embed_leaf(self, params, name: str) -> Params:
        """``{name: the embedding's leaf name}`` ("table" or "unembed"),
        its FSDP blocks gathered whole: only the leaf a lookup or the
        unembedding uses moves (in its dtype: the loss's unembedding takes
        the float32 masters and casts each chunk's product, as one rank
        does)."""
        leaf = params["embed"][name]
        if self.batch_axes:
            leaf = self._gather({name: leaf}, {name: self._placed["embed"][name]})[name]
        return {name: leaf}

    def _unembed_leaf(self, params) -> Params:
        """The unembedding's leaf (:meth:`_embed_leaf`): the table where the
        embeddings are tied."""
        return self._embed_leaf(params, "table" if self.cfg.tie_embeddings else "unembed")

    def _layer_whole(self, params, g: "Group", i: int):
        """Layer ``i`` of group ``g``: views of the stacks, its FSDP leaves
        gathered whole (:meth:`_gather`)."""
        if self.on_layer is not None:
            self.on_layer(g.name)
        p = _layer(params[g.name], i)
        return self._gather(p, self._placed[g.name], lead=1) if self.batch_axes else p

    def _gather(self, tree, placed, lead: int = 0):
        """``tree`` with each leaf that ``placed`` (``self._placed``'s
        subtree; ``lead``: the leading dims ``tree``'s leaves lack, 1 for a
        layer's views) puts on ``('pod', 'data')`` axes gathered whole
        along its dim: one ``gather_many`` a group of axes."""
        flat: List[Tuple[str, torch.Tensor, Any]] = []
        _collect_placed(tree, placed, "", flat)
        done: Dict[str, torch.Tensor] = {}
        for axes in dict.fromkeys(pl[1] for _, _, pl in flat):
            group = [(path, t, pl[0] - lead) for path, t, pl in flat if pl[1] == axes]
            whole = self.mesh.gather_many([t for _, t, _ in group], [d for _, _, d in group], axes)
            done.update((path, w) for (path, _, _), w in zip(group, whole))
        return _map2(lambda t, _, path: done.get(path, t), tree, tree) if done else tree

    def _batch_total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the batch's ranks (no gradient): a loss's
        global masked count, a metric's global value."""
        return self.mesh.psum([t.detach()], self.batch_axes)[0]

    # ------------------------------------------------------------- embedding
    def _embed_in(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(self.device, self.dtype)
        else:
            x = common.embed_tokens(self._embed_leaf(params, "table"), batch["tokens"].to(self.device), self.dtype,
                                    self.tp, cfg.vocab_size)
        x = self._scale_tied(x)
        if cfg.rope_theta <= 0:
            x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model, self.dtype, self.device)
        if cfg.meta_tokens:
            meta = self._whole(params, "meta")
            x = torch.cat([meta.to(self.dtype).expand((x.shape[0],) + meta.shape), x], dim=1)
        return x

    def _embed_dec(self, params, tokens) -> torch.Tensor:
        """The encoder-decoder's decoder tokens, with their sinusoidal
        positions (the reference scales no tied table there)."""
        cfg = self.cfg
        x = common.embed_tokens(self._embed_leaf(params, "table"), tokens.to(self.device), self.dtype, self.tp,
                                cfg.vocab_size)
        return x + common.sinusoidal_positions(x.shape[1], cfg.d_model, self.dtype, self.device)

    def _encode(self, params, embeds) -> torch.Tensor:
        """The encoder group over the frame embeddings (sinusoidal
        positions added), as ``hidden`` runs a trunk: Megatron sequence
        parallelism where the axis divides the frames. Returns the whole
        (B, S_enc, d) output on every rank (the reference applies no
        norm after the encoder)."""
        g = self.groups[0]
        x = self._embed_in(params, {"embeds": embeds})
        tp = self.tp.with_seq(self.seq_parallel(x.shape[1]))
        if tp.seq:
            x = tp.scatter_seq(x)
        for i in range(g.count):
            x = blocks.apply_encoder_block(self._layer_whole(params, g, i), x, self.cfg, impl=self.attn_impl, tp=tp)
        return tp.whole(x)

    def _scale_tied(self, x) -> torch.Tensor:
        """Tied embeddings (gemma2) scale by sqrt(d_model), rounded to the
        compute dtype first."""
        if not self.cfg.tie_embeddings:
            return x
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype, device=self.device)

    def _through_caches(self, params, x, state, block) -> torch.Tensor:
        """``x`` through every decoding layer, ``block(g, p, x, state,
        is_global, cross_kv) -> (x, state)`` on layer views of the stacked
        params, of the group's state tree, whatever its type (``KVCache``,
        ``MLACache``, the SSM and hybrid states), and of the cross K / V
        (None but in whisper's decoder); each layer's new state is written
        back into the stacks in place (``_write_back``)."""
        for g in self.groups:
            if g.kind == "enc":
                continue
            for i in range(g.count):
                view = _state_layer(state[g.name], i)
                cross = _state_layer(state["cross"], i) if g.cross else None
                x, new = block(g, self._layer_whole(params, g, i), x, view, self._flag(g, i), cross)
                _write_back(view, new)
        return x

    def _logits(self, params, x) -> torch.Tensor:
        """Float32 logits, softcapped on each rank's vocabulary block (it
        is elementwise), then gathered whole over the ``model`` axis."""
        cfg = self.cfg
        parts = common.unembed(self._unembed_leaf(params), x, cfg.tie_embeddings, self.tp, cfg.vocab_size)
        parts = [common.softcap(o.float(), cfg.final_logit_softcap) for o in parts]
        return self.tp.gather(parts, -1) if self.tp.splits(cfg.vocab_size) else parts[0]

    def _flag(self, g: Group, i: int) -> bool:
        return g.static_global if g.flags is None else g.flags[i]

    # ---------------------------------------------------------------- trunk
    def seq_parallel(self, s: int) -> bool:
        """Whether ``hidden`` runs Megatron sequence parallelism on ``s``
        positions: ``cfg.seq_parallel``, the ``model`` axis divides them,
        and the model is no SSM or hybrid (else the psum form, as prefill
        and decode)."""
        cfg = self.cfg
        return cfg.seq_parallel and cfg.family not in ("ssm", "hybrid") and self.tp.p > 1 and s % self.tp.p == 0

    def hidden(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the final hidden states (B, S, d), normalized, meta tokens cut,
        whole on every rank; aux, the sum of the MoE blocks' router
        losses, a float32 scalar). The encoder-decoder's are its
        decoder's, over ``batch["tokens"]``. Where autograd records (grad
        enabled, a leaf of ``params`` requiring it), each layer runs under
        ``_remat(cfg.remat)``."""
        cfg = self.cfg
        params = self._cast(params)
        enc = None
        if cfg.is_encdec:
            enc = self._encode(params, batch["enc_embeds"])
            x = self._embed_dec(params, batch["tokens"])
        else:
            x = self._embed_in(params, batch)
        tp = self.tp.with_seq(self.seq_parallel(x.shape[1]))
        if tp.seq:
            x = tp.scatter_seq(x)
        aux = torch.zeros((), device=self.device)
        remat = self.cfg.remat if torch.is_grad_enabled() and _records(params) else "none"
        for g in self.groups:
            if g.kind == "enc":
                continue
            placed = self._placed[g.name] if self.batch_axes else None
            layers = _unstack(params[g.name], g.count)
            for i in range(g.count):
                # FSDP: the layer's blocks gathered inside the remat'd function, so its
                # recompute gathers again and only the blocks live between layers
                block = _remat(lambda x, p, enc, g=g, flag=self._flag(g, i), placed=placed: self._trunk_block(
                    g, p if placed is None else self._gather(p, placed, lead=1), x, flag, tp, enc), remat)
                x, a = block(x, layers[i], enc)
                if a is not None:
                    aux = aux + a
        x = tp.whole(tp.norm(params["final_norm"], x, cfg.norm_kind))
        return (x[:, cfg.meta_tokens:] if cfg.meta_tokens else x), aux

    @torch.inference_mode()
    def logits(self, params, batch) -> torch.Tensor:
        """Full float32 logits -- small shapes only (tests / serving)."""
        return self._logits(self._cast(params), self.hidden(params, batch)[0])

    def _unemb_fn(self, params) -> Callable[[torch.Tensor], torch.Tensor]:
        """The loss's unembedding: ``_logits`` without the softcap and the
        float32 cast (``chunked_xent`` applies both), gathered whole over
        the ``model`` axis."""
        cfg = self.cfg
        emb = self._unembed_leaf(params)

        def f(x):
            parts = common.unembed(emb, x, cfg.tie_embeddings, self.tp, cfg.vocab_size)
            return self.tp.gather(parts, -1) if self.tp.splits(cfg.vocab_size) else parts[0]

        return f

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss and its metrics, the reference's: the chunked
        cross-entropy with z-loss 1e-4 and the final softcap, plus the MoE
        router's aux loss (``router_aux_weight``) and DeepSeek's MTP loss
        (weight 0.3, under a checkpoint). Records the autograd graph."""
        cfg = self.cfg
        x, aux = self.hidden(params, batch)
        nll, zl = losses.chunked_xent(x, batch["labels"], self._unemb_fn(params), z_loss=1e-4,
                                      final_softcap=cfg.final_logit_softcap,
                                      count_sum=self._batch_total if self.batch_axes else None)
        total = nll + zl
        metrics = {"nll": nll, "z_loss": zl}
        if cfg.moe is not None:
            if self.batch_axes:  # the mean over the capacity groups: each rank's rows are one
                aux = aux / self.mesh.axis_size(self.batch_axes)
            total = total + cfg.moe.router_aux_weight * aux
            metrics["moe_aux"] = aux
        if cfg.mtp_depth > 0 and "tokens" in batch:
            mtp_nll = ckpt.checkpoint(self._mtp_loss, params, x, batch, use_reentrant=False)
            total = total + 0.3 * mtp_nll
            metrics["mtp_nll"] = mtp_nll
        metrics["loss"] = total
        if self.batch_axes:  # the rank's share, and every metric's global value
            metrics = {k: self._batch_total(v) for k, v in metrics.items()}
        return total, metrics

    def _mtp_loss(self, params, h, batch) -> torch.Tensor:
        """DeepSeek MTP (depth 1): predict token t+2 from [h_t; emb(t+1)]."""
        cfg = self.cfg
        p = self._whole(params, "mtp")
        tokens, labels = batch["tokens"].to(self.device), batch["labels"]
        emb_next = common.embed_tokens(self._embed_leaf(params, "table"), tokens[:, 1:], self.dtype, self.tp,
                                       cfg.vocab_size)
        hh = common.apply_norm(p["norm_h"], h[:, :-1], cfg.norm_kind)
        ee = common.apply_norm(p["norm_e"], emb_next, cfg.norm_kind)
        z = torch.cat([hh, ee], dim=-1) @ p["proj"].to(self.dtype)
        use_moe = cfg.moe is not None and cfg.moe.first_k_dense < cfg.num_layers
        z, _ = blocks.apply_decoder_block(p["block"], z, cfg, is_global=True, use_moe=use_moe, impl=self.attn_impl,
                                          tp=self.tp)
        nll, _ = losses.chunked_xent(z, labels[:, 1:], self._unemb_fn(params),  # label t+1 predicts token t+2
                                     count_sum=self._batch_total if self.batch_axes else None)
        return nll

    # --------------------------------------------------------------- decode
    def init_decode_state(self, b: int, s_max: int, cache_dtype=torch.bfloat16, *,
                          seq_shard: bool = False) -> Dict[str, Any]:
        """``{"pos": int, <group>: state}``, each leaf stacked (L, ...): a
        ``KVCache`` of (L, B, S, KVH, D) K and V, or for MLA an
        ``MLACache`` of (L, B, S, kv_lora_rank) latents and (L, B, S,
        rope_head_dim) rope keys, with (L, B) lengths; hymba a
        ``HymbaState`` (its KV cache over the meta tokens too, and the
        Mamba heads' float32 (B, di, N) state and (B, conv_dim - 1, di)
        conv window); xLSTM an ``XLSTMPairState`` (or for mLSTM layers
        alone an ``MLSTMBlockState``) of float32 mLSTM (C, n, m), the
        width-4 conv window and the sLSTM (h, c, n, m). The KV cache is
        bfloat16 by default even for a float32 model, as the reference's
        is. No state for whisper's encoder; its decoder's cross K / V come
        with ``prefill``. The KV cache lies as the reference's
        ``decode_state_shardings`` places it (``attention.cache_block``):
        its KV heads over ``model`` where the axis divides them, else its
        head dim where the axis divides that; ``seq_shard`` (the
        reference's ``long_500k``: a batch every ``data`` rank holds) puts
        its sequence, meta tokens included, in blocks over ``data`` where
        that axis divides it (``common.seq_blocks``), the latent cache's
        as the KV cache's (``attention.mla_cache_block``); ``prefill`` and
        ``decode_step`` read the cache so (``serve_tp``) until the next
        call makes a state without it. On a ``ProcessGroupMesh`` those blocks, the mLSTM heads
        and the ``di`` channels of the conv windows and the Mamba state
        are the rank's."""
        s_tot = s_max + self.cfg.meta_tokens
        tp = self.tp.with_kv_seq(seq_shard, s_tot)
        self.serve_tp = tp
        state: Dict[str, Any] = {"pos": 0}
        for g in self.groups:
            if g.kind != "enc":
                state[g.name] = _stack_state(self._layer_state(g, b, s_tot, cache_dtype, tp), g.count)
        return state

    def _layer_state(self, g: Group, b: int, s_tot: int, cache_dtype, tp: common.TP):
        """One layer's initial decode state for group ``g``."""
        cfg, dev = self.cfg, self.device
        if g.kind in ("dec", "dec_moe"):
            return blocks.init_block_cache(cfg, b, s_tot, cache_dtype, dev, tp)
        di = int(cfg.ssm.expand * cfg.d_model)
        own = di // tp.p if tp.holds_block and tp.splits(di) else di  # the rank's channels
        if g.kind == "hymba":
            return blocks.HymbaState(
                kv=attention.init_kv_cache(*attention.cache_block(cfg, tp, b, s_tot), cache_dtype, dev),
                mamba=ssm.MambaState(h=torch.zeros((b, own, cfg.ssm.state_dim), device=dev),
                                     conv=torch.zeros((b, cfg.ssm.conv_dim - 1, own), device=dev)))
        h, dh = cfg.num_heads, di // cfg.num_heads
        heads = h // tp.p if tp.holds_block and tp.splits(h) else h  # the rank's mLSTM heads
        mb = ssm.MLSTMBlockState(cell=ssm.init_mlstm_state(b, heads, dh, dh, device=dev),
                                 conv=torch.zeros((b, ssm.MLSTM_CONV - 1, own), device=dev))
        return blocks.XLSTMPairState(m=mb, s=ssm.init_slstm_state(b, cfg.d_model, dev)) if g.kind == "xlstm_pair" else mb

    @torch.inference_mode()
    def prefill(self, params, batch, state) -> Tuple[Dict, torch.Tensor]:
        """Run the prompt through the model, filling ``state``'s caches in
        place (whisper: its encoder over ``batch["enc_embeds"]`` first,
        and ``state["cross"]`` made). Returns (state, last-position logits
        (B, V))."""
        cfg = self.cfg
        params = self._cast(params)
        if cfg.is_encdec:
            state["cross"] = self._cross_kv(params, self._encode(params, batch["enc_embeds"]))
            x = self._embed_dec(params, batch["tokens"])
        else:
            x = self._embed_in(params, batch)
        x = self._through_caches(params, x, state, functools.partial(self._prefill_block, tp=self.serve_tp))
        x = common.apply_norm(params["final_norm"], x, cfg.norm_kind)
        state["pos"] = x.shape[1]
        return state, self._logits(params, x[:, -1:])[:, 0]

    def _cross_kv(self, params, enc) -> blocks.CrossKV:
        """Every decoder layer's cross K / V of ``enc``, stacked (L, ...):
        each layer's written into the stacks as it is made."""
        g = self.groups[1]
        out = None
        for i in range(g.count):
            kv = blocks.cross_kv_proj(self._layer_whole(params, g, i), enc, self.cfg, self.tp)
            if out is None:
                out = blocks.CrossKV(*(t.new_empty((g.count,) + tuple(t.shape)) for t in kv))
            out.k[i], out.v[i] = kv
        return out

    @torch.inference_mode()
    def decode_step(self, params, tokens, state) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1) -> (logits (B, V), state advanced in place)."""
        cfg = self.cfg
        params = self._cast(params)
        x = self._scale_tied(common.embed_tokens(self._embed_leaf(params, "table"), tokens.to(self.device), self.dtype,
                                                 self.tp, cfg.vocab_size))
        if cfg.rope_theta <= 0:
            x = x + self._abs_pos(state["pos"])
        x = self._through_caches(params, x, state, functools.partial(self._decode_block, tp=self.serve_tp))
        x = common.apply_norm(params["final_norm"], x, cfg.norm_kind)
        state["pos"] = state["pos"] + 1
        return self._logits(params, x)[:, 0], state

    def _trunk_block(self, g: Group, p, x, flag: bool, tp=None, enc=None):
        """One layer of ``hidden``: (x, the MoE router's aux loss, or None
        where the block has no router); ``enc``: the encoder's output, for
        a decoder layer's cross-attention."""
        cfg, impl, tp = self.cfg, self.attn_impl, self.tp if tp is None else tp
        if g.kind == "hymba":
            return blocks.apply_hymba_block(p, x, cfg, is_global=flag, impl=impl, tp=tp)[0], None
        if g.kind == "xlstm_pair":
            return blocks.apply_xlstm_pair(p, x, cfg, tp=tp)[0], None
        if g.kind == "xlstm_m":
            return blocks.apply_xlstm_m(p, x, cfg, tp=tp)[0], None
        cross = blocks.cross_kv_proj(p, enc, cfg, self.tp) if g.cross else None
        return blocks.apply_decoder_block(p, x, cfg, is_global=flag, use_moe=g.kind == "dec_moe", impl=impl, tp=tp,
                                          cross_kv=cross)

    def _prefill_block(self, g: Group, p, x, st, flag: bool, cross=None, *, tp: common.TP):
        cfg, impl = self.cfg, self.attn_impl
        if g.kind == "hymba":
            return blocks.prefill_hymba_block(p, x, cfg, st, is_global=flag, impl=impl, tp=tp)
        if g.kind == "xlstm_pair":
            return blocks.apply_xlstm_pair(p, x, cfg, st, tp)
        if g.kind == "xlstm_m":
            return blocks.apply_xlstm_m(p, x, cfg, st, tp)
        return blocks.prefill_decoder_block(p, x, cfg, st, is_global=flag, use_moe=g.kind == "dec_moe", impl=impl,
                                            tp=tp, cross_kv=cross)

    def _decode_block(self, g: Group, p, x, st, flag: bool, cross=None, *, tp: common.TP):
        cfg = self.cfg
        if g.kind == "hymba":
            return blocks.decode_hymba_block(p, x, cfg, st, is_global=flag, tp=tp)
        if g.kind == "xlstm_pair":
            return blocks.decode_xlstm_pair(p, x, cfg, st, tp)
        if g.kind == "xlstm_m":
            return blocks.decode_xlstm_m(p, x, cfg, st, tp)
        return blocks.decode_decoder_block(p, x, cfg, st, is_global=flag, use_moe=g.kind == "dec_moe", tp=tp,
                                           cross_kv=cross)

    def _abs_pos(self, pos: int) -> torch.Tensor:
        half = self.cfg.d_model // 2
        dim = torch.arange(half, dtype=torch.float32, device=self.device)
        ang = float(pos) / torch.pow(10000.0, 2 * dim / self.cfg.d_model)
        return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :].to(self.dtype)


def _collect_placed(t, pl, path: str, out: List[Tuple[str, torch.Tensor, Any]]) -> None:
    """(path, leaf, placement) of each leaf of ``t`` that ``pl`` places
    (a module-level recursion: a closure calling itself would make a
    reference cycle keeping the leaves alive until the cycle collector
    runs)."""
    if isinstance(t, dict):
        for k, v in t.items():
            _collect_placed(v, pl[k], f"{path}/{k}", out)
    elif pl is not None:
        out.append((path, t, pl))


def _records(tree) -> bool:
    """Whether any leaf of a tree requires grad (autograd records through it)."""
    if isinstance(tree, dict):
        return any(_records(v) for v in tree.values())
    return tree.requires_grad


def _map2(fn: Callable, tree, specs, path: str = ""):
    """``fn(leaf, spec, path)`` on every leaf of a tree and its specs, the
    leaf's path of keys ("a/b/c", under ``path``) beside it."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k], f"{path}/{k}") for k, v in tree.items()}
    return fn(tree, specs, path)


def _copy_into(stacked, tree, specs, i: int, generator: torch.Generator, where: Callable, path: str = "") -> None:
    """Layer ``i`` of the stacks from ``tree``'s tensors, its ``Deferred``
    leaves drawn straight into the stack: every expert drawn in order, the
    ones this process keeps written; of the other leaves the block this
    process keeps (``where(spec, shape, path)``: ``_where``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_into(stacked[k], v, specs[k], i, generator, where, f"{path}/{k}")
        return
    cuts = where(specs, tree.shape, path)
    if isinstance(tree, Deferred):
        lead = [c for c in cuts or () if c[0] == 0]
        rest = [(dim - 1, first, count, parts) for dim, first, count, parts in cuts or () if dim > 0]
        tree.fill(stacked[i], generator, first=lead[0][1] if lead else 0,
                  cut=(lambda t: sharding.take(t, rest)) if rest else None)
    else:
        stacked[i].copy_(sharding.take(tree, cuts))


def placements(tree, *, mesh, specs, cfg: Optional[ModelConfig] = None):
    """Each leaf's ``core.sharding.placement`` on ``mesh`` (its partition
    spec: FSDP x TP, heads whole where ``cfg``'s head counts place them),
    for a tree of the model's layout (weights, moments, or their shapes
    on the ``meta`` device) and its ``specs``."""
    units = None if cfg is None else head_units(cfg)

    def spec_of(a, spec, path):
        lay, parts = _layout(path, spec)
        return sharding.placement(mesh, lay, tuple(a.shape), units, parts)

    return _map2(spec_of, tree, specs)


def rank_blocks(tree, *, mesh=None, specs=None, cfg: Optional[ModelConfig] = None):
    """A tree of the model's layout (weights, or AdamW moments or
    gradients, which mirror them; the reference's numpy or JAX arrays,
    or the port's whole tensors) with, on a ``ProcessGroupMesh`` of
    several ranks, each leaf cut to the block this rank keeps, as
    ``Model(cfg, mesh).init`` places it (``specs``: ``Model.init``'s, the
    reference's; ``cfg``: the head counts, where the specs place heads);
    elsewhere every leaf whole. Arrays come back as numpy arrays, tensors
    as tensors (a block a copy)."""
    units = None if cfg is None else head_units(cfg)

    def cut(a, spec=(), path=""):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        where = _where(mesh, spec, tuple(a.shape), units, path)
        if where is None:
            return a
        block = sharding.take(a, where)
        return block.clone() if isinstance(block, torch.Tensor) else block

    if mesh is not None and mesh.caller_holds_block and mesh.p > 1:
        if specs is None:
            raise ValueError("placing a tree on a ProcessGroupMesh needs its specs to cut its blocks")
        return _map2(cut, tree, specs)
    return _map(cut, tree)


def params_from_numpy(tree, device=None, dtype=None, *, mesh=None, specs=None, cfg: Optional[ModelConfig] = None):
    """The reference's parameter tree (numpy or JAX arrays, the same keys
    and stacked ``(L, ...)`` layout) as the port's tensors on ``device``
    (default ``cuda``); float leaves cast to ``dtype`` when given -- the
    reference's per-call ``_cast``, done once at load. On a
    ``ProcessGroupMesh`` of several ranks pass the tree's ``specs``
    (``Model.init``'s, the reference's) and, where they place heads, the
    model's ``cfg`` (its head counts): each leaf keeps this rank's block,
    as ``Model(cfg, mesh).init`` places it (:func:`rank_blocks`)."""
    dev = resolve_device(device)
    cast = _float_to(dtype) if dtype is not None else (lambda a: a)
    return _map(lambda a: cast(torch.from_numpy(np.array(a)).to(dev)),
                rank_blocks(tree, mesh=mesh, specs=specs, cfg=cfg))
