"""The dry run, ported from ``repro.launch.dryrun``: every arch x shape x
mesh cell's bytes a rank, FLOPs and collective bytes, as a walk over the
port's placement specs.

The reference lowers and compiles each cell's step over 512 forced host
devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
collectives of the compiled HLO. The port compiles no program: it walks
the specs its own code places by, on leaves that live on the ``meta``
device (shapes and dtypes, no memory), as the reference's abstract values
live on no device. It sets no environment variable, joins no process
group and allocates on no device; every mesh is read through its
``.shape`` mapping alone (a shape-only ``launch.mesh.MeshShape``, a
``SimMesh`` or a ``ProcessGroupMesh``), and each rank is taken to hold
its own blocks, as a ``ProcessGroupMesh`` rank does.

Per cell, as the reference's ``lower_cell`` builds it:

- **train**: the ``TrainState`` (float32 weights, AdamW moments in
  ``TrainConfig(microbatch=4, opt_state_dtype="bfloat16")``, the
  reference's production defaults, unless ``tcfg`` is given) placed by
  ``train.state_placement``, and the batch of ``launch.specs.
  batch_input_specs``; the state is donated.
- **prefill**: the weights as ``Model`` places them on the mesh (in the
  model's dtype: the port casts once, at load), the decode state of
  ``specs.abstract_decode_state`` under ``specs.decode_state_shardings``,
  the batch inputs; the state is donated.
- **decode**: the weights, ``(b, 1)`` int32 tokens over the batch axes,
  the decode state; the state is donated.

``memory``: ``argument_bytes`` sums this rank's block of every argument
(exact: the placement cuts only dims its axes divide), ``output_bytes``
the new state (plus the float32 ``(b, V)`` logits of prefill and decode,
or the train step's scalar metrics), ``alias_bytes`` the donated state.
No compiler plans the temporaries, so ``temp_bytes`` is null and
``peak_device_bytes`` (arguments + outputs - aliases) is a **floor**
(``peak_is_floor``): gradients, activations and the gathered weights come
on top of it.

``collectives`` are the ones the placement decides, as the port's code
issues them on a rank (``scope: "state collectives"``; what
``core.mesh.FSDP_BYTES`` counts on a run): FSDP's all-gathers of a
layer's blocks just before the layer (again in ``_remat``'s recompute),
the embedding's, the meta tokens' and the MTP module's before theirs,
each gradient's reduce-scatter, the all-reduces of the gradients of
leaves replicated over a batch axis and the step's scalar reductions
over the batch axes; in serving cells the weight gathers of ``prefill``
and ``decode_step``. A kind's bytes are what the collective assembles on
the rank: the gathered tensor, the whole gradient handed to the
reduce-scatter, the all-reduced buffer. Activation collectives over
``model`` and the expert dispatch (tensor-parallel psums, all-to-alls,
ring hops) are not counted.

The FLOPs are the reference's analytic ``6`` (train) or ``2`` x active
params x tokens; the roofline (``core.comm_model.Roofline``, H100
data-sheet constants) adds the attention's products a chip
(:func:`attention_flops`) and prices them at ``PEAK_FLOPS_BF16``. Its
``hbm_bytes`` are the arguments and outputs each moved once, a floor too.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both [--reduced] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import traceback
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import comm_model, sharding
from repro_torch.core.mesh import STATE_AXES
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models.model import Model, build_groups, placements

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun")

#: long_500k runs only for the sub-quadratic archs (the reference's rule)
LONG_OK = ("xlstm-1.3b", "hymba-1.5b")

#: the reference's production training defaults (``lower_cell``)
PRODUCTION_TCFG = TrainConfig(microbatch=4, opt_state_dtype="bfloat16")

KINDS = ("all_gather", "reduce_scatter", "all_reduce")
SCALAR_BYTES = 4  # a float32 scalar


def cells(arch_filter=None, shape_filter=None) -> Iterator[Tuple[str, str]]:
    from repro_torch.configs import _MODULES

    for arch in _MODULES:
        if arch_filter and arch != arch_filter:
            continue
        for sname in SHAPES:
            if shape_filter and sname != shape_filter:
                continue
            if sname == "long_500k" and arch not in LONG_OK:
                continue
            yield arch, sname


# ---------------------------------------------------------------------------
# the attention's products, closed form
# ---------------------------------------------------------------------------


def _capped_sum(n: int, cap: int) -> int:
    """sum over k = 1..n of min(k, cap)."""
    if n <= 0 or cap <= 0:
        return 0
    if n <= cap:
        return n * (n + 1) // 2
    return cap * (cap + 1) // 2 + (n - cap) * cap


def visible_pairs(positions: int, window: int = 0, meta: int = 0) -> int:
    """The (query, key) pairs a causal mask keeps over ``positions``
    positions: each query sees itself and the keys before it, within
    ``window`` of it (0: all), and the ``meta`` leading positions always
    (Hymba's meta tokens, seen past the window)."""
    if window <= 0:
        return positions * (positions + 1) // 2
    return _capped_sum(positions, window) + _capped_sum(positions - window, meta)


def attention_pairs(cfg: ModelConfig, positions: int) -> int:
    """The causal (query, key) pairs every self-attention layer of the
    decoder trunk keeps over ``positions`` positions (meta tokens
    included), summed over the layers: a windowed layer's within the
    window (plus the meta tokens), a global layer's all. Layers without
    attention (xLSTM) and whisper's encoder count none."""
    out = 0
    for g in build_groups(cfg):
        if g.kind not in ("dec", "dec_moe", "hymba"):
            continue
        for i in range(g.count):
            is_global = g.static_global if g.flags is None else g.flags[i]
            out += visible_pairs(positions, 0 if is_global else cfg.window_size, cfg.meta_tokens)
    return out


def _pair_flops(cfg: ModelConfig) -> int:
    """The forward FLOPs of one (query, key) pair over all heads: the
    score's and the value's multiply-adds."""
    if cfg.mla is not None:
        m = cfg.mla
        return 2 * cfg.num_heads * (m.nope_head_dim + m.rope_head_dim + m.v_head_dim)
    return 4 * cfg.num_heads * cfg.head_dim_


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The attention's products of one step over the whole batch, which
    the 6 N (2 N) count leaves out: forward and backward (3 x the
    forward) for train, the forward alone for serving; a decode step's
    one new query sees the ``seq_len`` cached positions. Whisper: the
    encoder's bidirectional self-attention and the decoder's
    cross-attention (prefill and train; the decode state holds no cross
    K / V, as the reference's)."""
    b, s = shape.global_batch, shape.seq_len
    pos = s + cfg.meta_tokens
    if shape.kind == "decode":
        pairs = attention_pairs(cfg, pos) - attention_pairs(cfg, pos - 1)
    else:
        pairs = attention_pairs(cfg, pos)
    if cfg.is_encdec:
        dec = max(s // cfg.decoder_ratio, 1)
        if shape.kind == "decode":
            pairs = cfg.num_layers * dec  # one query at the last of ``dec`` positions, every layer global
        else:
            pairs = cfg.num_layers * visible_pairs(dec) + cfg.encoder_layers * s * s + cfg.num_layers * dec * s
    return (3.0 if shape.kind == "train" else 1.0) * b * _pair_flops(cfg) * pairs


def train_model_flops(cfg: ModelConfig, n_params: int, tokens: int, positions: int, batch: int) -> float:
    """6 N tokens plus the attention's products, forward and backward,
    over ``batch`` rows of ``positions`` positions (meta tokens
    included): what a train step needs, remat's recompute not counted."""
    return 6.0 * n_params * tokens + 3.0 * batch * _pair_flops(cfg) * attention_pairs(cfg, positions)


# ---------------------------------------------------------------------------
# placed leaves
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _split(mesh, spec) -> int:
    """How many blocks a spec cuts a leaf into on ``mesh``."""
    return math.prod(mesh.shape[a] for entry in spec for a in _axes(entry))


def _itemsize(dtype) -> int:
    return (getattr(torch, dtype) if isinstance(dtype, str) else dtype).itemsize


def block_bytes(mesh, shape, dtype, spec) -> int:
    """The bytes of one rank's block of a leaf of global ``shape`` placed
    by ``spec`` on ``mesh`` (its axes divide the dims they cut)."""
    n = math.prod(shape)
    parts = _split(mesh, spec)
    if n % parts:
        raise ValueError(f"a leaf of {tuple(shape)} does not split into {parts} blocks under {spec}")
    return n // parts * _itemsize(dtype)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight: its path, global shape, placement on the mesh, the
    ``('pod', 'data')`` axes its FSDP dim lies on (() for none) and the
    stack's layer count (1 for a leaf outside a layer stack)."""

    path: str
    shape: Tuple[int, ...]
    where: Tuple
    fsdp: Tuple[str, ...]
    layers: int

    def numel(self, mesh) -> int:
        """Elements of the rank's block."""
        return math.prod(self.shape) // _split(mesh, self.where)

    def gathered(self, mesh) -> int:
        """Elements of one layer's block gathered whole over its FSDP axes."""
        return self.numel(mesh) * math.prod(mesh.shape[a] for a in self.fsdp) // self.layers


@functools.lru_cache(maxsize=64)
def _abstract(cfg: ModelConfig):
    """(the weights on the ``meta`` device, their specs): ``Model._abstract``."""
    return Model(cfg, device="meta")._abstract()


def _flat(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def weight_leaves(cfg: ModelConfig, mesh) -> List[Leaf]:
    """Every weight of ``cfg``'s model with its placement on ``mesh``
    (``models.model.placements``: FSDP x TP, heads whole), in
    ``optim.adamw.leaves`` order."""
    return _weight_leaves(cfg, MeshShape(tuple(mesh.shape.values()), tuple(mesh.shape)))


@functools.lru_cache(maxsize=256)
def _weight_leaves(cfg: ModelConfig, mesh: MeshShape) -> List[Leaf]:
    shapes, specs = _abstract(cfg)
    where = dict(_flat(placements(shapes, mesh=mesh, specs=specs, cfg=cfg)))
    stacks = {g.name for g in build_groups(cfg)}
    out = []
    for path, a in _flat(shapes):
        w = where[path]
        fsdp = next((_axes(e) for e in w if e is not None and e != "model"), ())
        layers = a.shape[0] if path.split("/")[1] in stacks else 1
        out.append(Leaf(path, tuple(a.shape), w, fsdp, layers))
    return out


def batch_axes(mesh) -> Tuple[str, ...]:
    """The ``('pod', 'data')`` axes of more than one rank: the batch's and
    FSDP's (``models.model.batch_axes`` of a rank holding its blocks)."""
    return tuple(a for a in STATE_AXES if mesh.shape.get(a, 1) > 1)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


class _Tally:
    def __init__(self):
        self.counts = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}

    def add(self, kind: str, n: int, nbytes: int) -> None:
        self.counts[kind] += n
        self.bytes[kind] += nbytes

    def as_dict(self) -> Dict[str, Any]:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes), "scope": "state collectives"}


def _gather(tally: _Tally, mesh, leaves: List[Leaf], dtype, times: int = 1, scatter: bool = False) -> None:
    """``Model._gather`` of ``leaves`` (one layer's, or one subtree's) in
    ``dtype``, ``times`` times: one all-gather a set of FSDP axes (their
    leaves side by side); with ``scatter`` its backward once, one
    reduce-scatter of the same bytes."""
    placed = [leaf for leaf in leaves if leaf.fsdp]
    groups = len({leaf.fsdp for leaf in placed})
    if not groups:
        return
    nbytes = sum(leaf.gathered(mesh) for leaf in placed) * _itemsize(dtype)
    tally.add("all_gather", times * groups, times * nbytes)
    if scatter:
        tally.add("reduce_scatter", groups, nbytes)


def _subtree(leaves: List[Leaf], prefix: str) -> List[Leaf]:
    return [leaf for leaf in leaves if leaf.path == prefix or leaf.path.startswith(prefix + "/")]


def _trunk_groups(cfg: ModelConfig):
    return [g for g in build_groups(cfg) if g.kind != "enc"]


def train_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig) -> Dict[str, Any]:
    """The state collectives of one ``train.make_train_step`` on a rank of
    ``mesh`` (see the module docstring), per microbatch: ``Model.hidden``'s
    gathers in the compute dtype (the encoder's layers once, the trunk's
    inside ``_remat`` -- again in the recompute unless ``remat="none"``),
    the loss's unembedding and the MTP module's in float32 (the masters;
    MTP under a checkpoint: twice), each with its backward's
    reduce-scatter, the global masked mean's counts and the metrics over
    the batch axes; per step the gradients' all-reduces over the batch
    axes a leaf is replicated on and the clip's norm over the axes of
    each set of placed leaves that spans a batch axis."""
    tally = _Tally()
    axes = batch_axes(mesh)
    if not axes:
        return tally.as_dict()
    leaves = weight_leaves(cfg, mesh)
    compute, master = cfg.dtype, "float32"
    micro = tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1
    again = 1 if cfg.remat == "none" else 2
    inputs = specs_lib.batch_input_specs(cfg, shape, mesh)
    unembed = "/embed/table" if cfg.tie_embeddings else "/embed/unembed"
    scalars = 0
    for _ in range(micro):
        if cfg.is_encdec:
            enc = build_groups(cfg)[0]
            for leaf_set in _layers(leaves, enc.name, enc.count):
                _gather(tally, mesh, leaf_set, compute, scatter=True)
        if "tokens" in inputs and (cfg.is_encdec or cfg.input_kind != "embeddings"):
            _gather(tally, mesh, _subtree(leaves, "/embed/table"), compute, scatter=True)
        if cfg.meta_tokens:
            _gather(tally, mesh, _subtree(leaves, "/meta"), compute, scatter=True)
        for g in _trunk_groups(cfg):
            for leaf_set in _layers(leaves, g.name, g.count):
                _gather(tally, mesh, leaf_set, compute, times=again, scatter=True)
        _gather(tally, mesh, _subtree(leaves, unembed), master, scatter=True)
        metrics = 3 + (cfg.moe is not None)  # nll, z_loss, loss (+ moe_aux)
        scalars += 1 + metrics  # the count of kept labels, then the metrics
        if cfg.mtp_depth > 0 and "tokens" in inputs:
            for sub in ("/mtp", "/embed/table", unembed):
                _gather(tally, mesh, _subtree(leaves, sub), master, times=2, scatter=True)
            scalars += 2 + 1  # its count, in the forward and the recompute; mtp_nll
    missing = {}
    for leaf in leaves:
        m = tuple(a for a in axes if a not in sharding.placed_axes(leaf.where))
        if m:
            missing[m] = missing.get(m, 0) + leaf.numel(mesh) * 4  # float32 gradients
    for nbytes in missing.values():
        tally.add("all_reduce", 1, nbytes)
    placed = {sharding.placed_axes(leaf.where) for leaf in leaves}
    scalars += sum(1 for p in placed if any(a in axes for a in p))
    tally.add("all_reduce", scalars, scalars * SCALAR_BYTES)
    return tally.as_dict()


def _layers(leaves: List[Leaf], group: str, count: int) -> List[List[Leaf]]:
    """The leaves of one layer of a stacked group, ``count`` times (every
    layer of a stack has the same blocks)."""
    return [_subtree(leaves, "/" + group)] * count


def serve_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """The weight gathers of one ``Model.prefill`` or ``decode_step`` on a
    rank of ``mesh``, in the model's dtype: the embedding (prefill: where
    the input is tokens; decode: always), the meta tokens (prefill), every
    layer of the trunk, the unembedding; whisper's prefill also gathers
    its encoder's layers and, for the cross K / V, its decoder's once
    more."""
    tally = _Tally()
    if not batch_axes(mesh):
        return tally.as_dict()
    leaves = weight_leaves(cfg, mesh)
    dt = cfg.dtype
    unembed = "/embed/table" if cfg.tie_embeddings else "/embed/unembed"
    prefill = shape.kind == "prefill"
    groups = build_groups(cfg)
    if prefill and cfg.is_encdec:
        for g in groups:  # the encoder's layers, then the decoder's for the cross K / V
            for leaf_set in _layers(leaves, g.name, g.count):
                _gather(tally, mesh, leaf_set, dt)
    if not prefill or cfg.is_encdec or cfg.input_kind != "embeddings":
        _gather(tally, mesh, _subtree(leaves, "/embed/table"), dt)
    if prefill and cfg.meta_tokens:
        _gather(tally, mesh, _subtree(leaves, "/meta"), dt)
    for g in _trunk_groups(cfg):
        for leaf_set in _layers(leaves, g.name, g.count):
            _gather(tally, mesh, leaf_set, dt)
    _gather(tally, mesh, _subtree(leaves, unembed), dt)
    return tally.as_dict()


# ---------------------------------------------------------------------------
# bytes a rank
# ---------------------------------------------------------------------------


def _state_blocks(mesh, tree, spec_tree, path: str) -> Iterator[Tuple[str, int]]:
    """(name, bytes of the rank's block) of every tensor of a state tree
    (dicts and NamedTuples, named by their keys and fields; a host int,
    the decode position, holds none)."""
    if isinstance(tree, torch.Tensor):
        yield path, block_bytes(mesh, tree.shape, tree.dtype, spec_tree)
    elif isinstance(tree, dict):
        for k in tree:
            yield from _state_blocks(mesh, tree[k], spec_tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, a, sp in zip(tree._fields, tree, spec_tree):
            yield from _state_blocks(mesh, a, sp, f"{path}/{f}")
    elif isinstance(tree, (tuple, list)):
        for i, (a, sp) in enumerate(zip(tree, spec_tree)):
            yield from _state_blocks(mesh, a, sp, f"{path}/{i}")
    elif isinstance(tree, int):
        yield path, 0


@functools.lru_cache(maxsize=64)
def _abstract_state(cfg: ModelConfig, b: int, s: int):
    return specs_lib.abstract_decode_state(Model(cfg, device="meta"), b, s)


def decode_state(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(the decode state on ``meta``, its specs): ``specs.abstract_decode_state``
    under ``decode_state_shardings``."""
    b, s = shape.global_batch, shape.seq_len
    state = _abstract_state(cfg, b, s)
    spec = specs_lib.decode_state_shardings(state, mesh, replicate_batch=(b == 1),
                                            seq_shard=shape.name == "long_500k")
    return state, spec


def _batch_spec(mesh, b: int, shape: Tuple[int, ...]):
    """Rows over the batch axes (replicated at batch 1), the rest whole."""
    ba = specs_lib._batch_axes(mesh, replicate_batch=(b == 1))
    return specs_lib.sanitize_spec(mesh, (ba,) + (None,) * (len(shape) - 1), shape)


def arguments(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig = PRODUCTION_TCFG) -> Dict[str, int]:
    """The bytes of this rank's block of every argument of the cell's step,
    by name: ``params/...``, ``opt/mu/...``, ``opt/nu/...``,
    ``opt/count``, ``step`` and ``batch/...`` for train (float32
    weights, moments in ``tcfg.opt_state_dtype``); ``params/...`` in the
    model's dtype, ``batch/...`` and ``state/...`` for prefill and
    decode."""
    b = shape.global_batch
    out: Dict[str, int] = {}
    weights = weight_leaves(cfg, mesh)
    if shape.kind == "train":
        for prefix, dtype in (("params", "float32"), ("opt/mu", tcfg.opt_state_dtype),
                              ("opt/nu", tcfg.opt_state_dtype)):
            out.update((prefix + leaf.path, leaf.numel(mesh) * _itemsize(dtype)) for leaf in weights)
        out.update({"opt/count": 4, "step": 4})
    else:
        out.update(("params" + leaf.path, leaf.numel(mesh) * _itemsize(cfg.dtype)) for leaf in weights)
        tree, spec = decode_state(cfg, shape, mesh)
        out.update(_state_blocks(mesh, tree, spec, "state"))
    if shape.kind == "decode":
        inputs = {"tokens": ((b, 1), "int32", _batch_spec(mesh, b, (b, 1)))}
    else:
        inputs = specs_lib.batch_input_specs(cfg, shape, mesh)
    out.update(("batch/" + k, block_bytes(mesh, shp, dtype, spec)) for k, (shp, dtype, spec) in inputs.items())
    return out


def donated(shape: ShapeConfig, name: str) -> bool:
    """Whether the argument ``name`` belongs to the donated state."""
    return not name.startswith("batch/") and (shape.kind == "train" or name.startswith("state/"))


def outputs(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig = PRODUCTION_TCFG) -> Dict[str, int]:
    """The bytes of this rank's block of every output, by name: the new
    state (the donated arguments, updated in place) and the train step's
    float32 scalar metrics (``metrics/...``: with microbatches ``loss``,
    ``grad_norm``, ``lr``; without, the loss's own too), or the
    ``logits`` of prefill and decode: float32 ``(b, V)``, the rows over
    the batch axes, the vocabulary whole (``Model._logits`` gathers it)."""
    out = {k: v for k, v in arguments(cfg, shape, mesh, tcfg).items() if donated(shape, k)}
    b = shape.global_batch
    if shape.kind == "train":
        names = ["loss"]
        if not (tcfg.microbatch and tcfg.microbatch > 1):
            names += ["nll", "z_loss"] + ["moe_aux"] * (cfg.moe is not None) + ["mtp_nll"] * (cfg.mtp_depth > 0)
        out.update((f"metrics/{k}", SCALAR_BYTES) for k in names + ["grad_norm", "lr"])
    else:
        out["logits"] = block_bytes(mesh, (b, cfg.vocab_size), "float32", _batch_spec(mesh, b, (b, cfg.vocab_size)))
    return out


def memory(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig = PRODUCTION_TCFG) -> Dict[str, Any]:
    """The cell's ``memory`` entry (see the module docstring)."""
    args = arguments(cfg, shape, mesh, tcfg)
    alias = sum(v for k, v in args.items() if donated(shape, k))
    total, outs = sum(args.values()), sum(outputs(cfg, shape, mesh, tcfg).values())
    return {
        "argument_bytes": total,
        "output_bytes": outs,
        "temp_bytes": None,
        "alias_bytes": alias,
        "peak_device_bytes": total + outs - alias,
        "peak_is_floor": True,
    }


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def cell_report(cfg: ModelConfig, shape: ShapeConfig, mesh, *, tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """One cell's report on ``mesh`` (anything with a ``.shape`` mapping of
    axis name to size): ``memory``, ``collectives``, the reference's
    analytic FLOPs and parameter counts, and the H100 roofline.
    ``tcfg``: the train step's config (default ``PRODUCTION_TCFG``). A
    shape named ``long_500k`` shards its caches' sequence (the
    reference's rule)."""
    tcfg = PRODUCTION_TCFG if tcfg is None else tcfg
    chips = math.prod(mesh.shape.values())
    mem = memory(cfg, shape, mesh, tcfg)
    if shape.kind == "train":
        coll = train_collectives(cfg, shape, mesh, tcfg)
    else:
        coll = serve_collectives(cfg, shape, mesh)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    # 6ND for train (fwd 2ND + bwd 4ND); forward-only passes are 2ND (the reference's)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    roof = comm_model.Roofline(
        flops=model_flops / chips + attention_flops(cfg, shape) / chips,
        hbm_bytes=float(mem["argument_bytes"] + mem["output_bytes"]),
        coll_bytes=float(sum(coll["bytes"].values())),
        chips=chips,
        peak_flops=comm_model.PEAK_FLOPS_BF16,
    )
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": dict(mesh.shape),
        "chips": chips,
        "memory": mem,
        "roofline": roof.as_dict(),
        "collectives": coll,
        "params": n_params,
        "active_params": n_active,
        "tokens_per_step": tokens,
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / chips,
        "useful_flops_frac": (model_flops / chips) / max(roof.flops, 1.0),
    }


def run_cell(arch: str, sname: str, mesh_kind: str, *, reduced: bool = False) -> Dict[str, Any]:
    """:func:`cell_report` of ``arch`` x ``sname`` on the single- or the
    multi-pod production mesh, tagged as the reference tags its cells."""
    res = cell_report(get_config(arch, reduced=reduced), SHAPES[sname],
                      make_production_mesh(multi_pod=(mesh_kind == "multi")))
    res.update(arch=arch, mesh=mesh_kind)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="reduced configs (CI sanity)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_dir = args.out or os.path.abspath(RESULT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = list(cells(args.arch, args.shape)) if (args.all or not args.arch or not args.shape) else [
        (args.arch, args.shape)
    ]
    failures = 0
    for arch, sname in todo:
        for mk in meshes:
            tag = f"{arch}_{sname}_{mk}" + ("_reduced" if args.reduced else "") + "_torch"
            path = os.path.join(out_dir, tag + ".json")
            try:
                res = run_cell(arch, sname, mk, reduced=args.reduced)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                r = res["roofline"]
                print(
                    f"[OK] {tag}: mem/dev={res['memory']['peak_device_bytes'] / 2**30:.2f}GiB "
                    f"bottleneck={r['bottleneck']} "
                    f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},{r['t_collective_s']:.2e})s"
                )
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
                with open(os.path.join(out_dir, tag + ".FAILED"), "w") as f:
                    f.write(traceback.format_exc())
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
