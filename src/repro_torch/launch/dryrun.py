"""The dry run, ported from ``repro.launch.dryrun``: every arch x shape x
mesh cell's bytes a rank, FLOPs and collective bytes, as a walk over the
port's placement specs and as one rank's step run on the ``meta`` device.

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
or the train step's scalar metrics), ``alias_bytes`` the donated state;
``temp_bytes`` is the executed peak (below) less ``floor_bytes``
(arguments + outputs - aliases), so that ``peak_device_bytes`` is the
reference's arguments + temporaries + outputs - aliases. The serving
cache a traced rank holds is the spec's (``Model.init_decode_state``
cuts it as ``decode_state_shardings`` does, ``seq_shard`` in a
``long_500k`` cell). Where the port's own step holds more state than the
reference's spec gives a rank (whisper's decode keeps its cross K / V;
xLSTM's sLSTM ``m``, which the reference's name rule places over
``model``, stays whole), that state counts in the temporaries:
``executed.args_bytes`` says what the trace held.

``executed`` (:func:`executed`) is one rank's step -- the cell's own entry
point, ``train.make_train_step``'s step, ``Model.prefill`` or
``Model.decode_step`` -- run on the ``meta`` device over a
``core.mesh.MetaRankMesh`` of the cell's mesh (``ProcessGroupMesh``'s
transports, no wire), under :class:`StepTally`: the FLOPs as executed
(``torch.utils.flop_counter``'s registry: remat's recompute, every masked
KV chunk, every expert's slots), the HBM bytes an eager program moves
(every kernel reads its operands and writes its outputs once: a
departure from the reference's fused matmul-boundary rule, ROADMAP queue
C) and the bytes alive at the peak, traced at a few depths and loop
lengths and extended (:func:`executed`); ``trace_s`` in place of the
reference's ``lower_s`` / ``compile_s``. A loop whose trips the host
would read back raises on ``meta``; the step has none since
``models.moe._one_hot`` (one program on every device).

``collectives`` are every collective one rank issues, as the port's code
issues them (what ``core.mesh.COLLECTIVE_BYTES`` counts on a run), in
the reference's five kinds. At the top, ``counts`` and ``bytes`` as the
reference's ``hlo_analysis`` reports them: the bytes **shipped**, each
collective's assembled bytes times its kind's ring factor at its group
size (``comm_model.shipped_bytes``); the roofline's ``coll_bytes`` is
their sum. Under them two entries of counts and bytes **assembled** on
the rank (the gathered tensor, the whole operand of a reduce-scatter,
the all-reduced block, a permute's piece):

- ``state`` (what ``core.mesh.FSDP_BYTES`` counts): FSDP's all-gathers
  of a layer's blocks just before the layer (again in ``_remat``'s
  recompute), the embedding's, the meta tokens' and the MTP module's
  before theirs, each gradient's reduce-scatter, the all-reduces of the
  gradients of leaves replicated over a batch axis and the step's scalar
  reductions over the batch axes; in serving cells the weight gathers of
  ``prefill`` and ``decode_step``;
- ``activation`` (:func:`activation_collectives`): the model code's
  collectives over ``model`` -- the tensor-parallel psums and their
  backward's Megatron "f" all-reduces, the sequence-parallel rings'
  hops, the vocabulary's psum and logit gathers, the context
  partition's gathers and all-to-alls, the MoE dispatches' gathers and
  hops, the SSM splits' psums and gathers -- in the forward, again in
  remat's recompute (which stops after a layer's last saved tensor) and
  the checkpointed loss chunks, and in the backward; the MoE ring's aux
  over the batch axes; the clip's norm over ``model``.

The model FLOPs are the reference's analytic ``6`` (train) or ``2`` x
active params x tokens (``useful_flops_frac`` their share of the executed
ones); the roofline (``core.comm_model.Roofline``, H100 data-sheet
constants) prices the executed FLOPs at ``PEAK_FLOPS_BF16``, the moved
bytes at the HBM rate and the shipped collective bytes at NVLink's.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --shape long_500k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both [--reduced] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import sys
import traceback
import weakref
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import comm_model, sharding
from repro_torch.core.mesh import STATE_AXES
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import MeshShape, make_production_mesh, process_state, touched
from repro_torch.models import common
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import cache_model_dim
from repro_torch.models.model import Model, abstract, build_groups, placements

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun")

#: the archs ``--all`` runs long_500k for, the sub-quadratic ones (the reference's rule); a named ``--arch`` and
#: ``--shape`` run any cell, as the reference's CLI does
LONG_OK = ("xlstm-1.3b", "hymba-1.5b")

#: the reference's production training defaults (``lower_cell``)
PRODUCTION_TCFG = TrainConfig(microbatch=4, opt_state_dtype="bfloat16")

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
    shapes, specs = abstract(cfg)
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

KINDS = comm_model.COLLECTIVE_KINDS


class _Tally:
    """Collectives by ``(kind, axes)``: a count and the bytes each
    assembles on the rank (``core.mesh.COLLECTIVE_BYTES``' convention)."""

    def __init__(self):
        self.counts: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self.bytes: Dict[Tuple[str, Tuple[str, ...]], int] = {}

    def add(self, kind: str, n: int, nbytes: int, axes: Tuple[str, ...]) -> None:
        if n:
            key = (kind, tuple(axes))
            self.counts[key] = self.counts.get(key, 0) + n
            self.bytes[key] = self.bytes.get(key, 0) + nbytes

    def as_dict(self, scope: str) -> Dict[str, Any]:
        counts, nbytes = dict.fromkeys(KINDS, 0), dict.fromkeys(KINDS, 0)
        for (kind, _), n in self.counts.items():
            counts[kind] += n
        for (kind, _), b in self.bytes.items():
            nbytes[kind] += b
        return {"counts": counts, "bytes": nbytes, "scope": scope}

    def shipped(self, mesh) -> Dict[str, float]:
        """Per kind, the bytes the rank ships (``comm_model.shipped_bytes``
        at each collective's group size)."""
        out = dict.fromkeys(KINDS, 0.0)
        for (kind, axes), b in self.bytes.items():
            out[kind] += comm_model.shipped_bytes(kind, b, math.prod(mesh.shape[a] for a in axes))
        return out


def _gather(tally: _Tally, mesh, leaves: List[Leaf], dtype, times: int = 1, scatter: bool = False) -> None:
    """``Model._gather`` of ``leaves`` (one layer's, or one subtree's) in
    ``dtype``, ``times`` times: one all-gather a set of FSDP axes (their
    leaves side by side); with ``scatter`` its backward once, one
    reduce-scatter of the same bytes."""
    by_axes: Dict[Tuple[str, ...], int] = {}
    for leaf in leaves:
        if leaf.fsdp:
            by_axes[leaf.fsdp] = by_axes.get(leaf.fsdp, 0) + leaf.gathered(mesh) * _itemsize(dtype)
    for axes, nbytes in by_axes.items():
        tally.add("all-gather", times, times * nbytes, axes)
        if scatter:
            tally.add("reduce-scatter", 1, nbytes, axes)


def _subtree(leaves: List[Leaf], prefix: str) -> List[Leaf]:
    return [leaf for leaf in leaves if leaf.path == prefix or leaf.path.startswith(prefix + "/")]


def _trunk_groups(cfg: ModelConfig):
    return [g for g in build_groups(cfg) if g.kind != "enc"]


def train_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig,
                      one_process: bool = False) -> _Tally:
    """The state collectives of one ``train.make_train_step`` on a rank of
    ``mesh`` (see the module docstring), per microbatch: ``Model.hidden``'s
    gathers in the compute dtype (the encoder's layers once, the trunk's
    inside ``_remat`` -- again in the recompute unless ``remat="none"``),
    the loss's unembedding and the MTP module's in float32 (the masters;
    MTP under a checkpoint: twice), each with its backward's
    reduce-scatter, the global masked mean's counts and the metrics over
    the batch axes; per step the gradients' all-reduces over the batch
    axes a leaf is replicated on and the clip's norm over the axes of
    each set of placed leaves that spans a batch axis. None where
    ``one_process`` runs every rank (a ``SimMesh``)."""
    tally = _Tally()
    axes = () if one_process else batch_axes(mesh)
    if not axes:
        return tally
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
    missing: Dict[Tuple[str, ...], int] = {}
    for leaf in leaves:
        m = tuple(a for a in axes if a not in sharding.placed_axes(leaf.where))
        if m:
            missing[m] = missing.get(m, 0) + leaf.numel(mesh) * 4  # float32 gradients
    for m, nbytes in missing.items():
        tally.add("all-reduce", 1, nbytes, m)
    tally.add("all-reduce", scalars, scalars * SCALAR_BYTES, axes)
    for p in {sharding.placed_axes(leaf.where) for leaf in leaves}:
        if any(a in axes for a in p):  # the clip's norm over the axes of a set of placed leaves
            tally.add("all-reduce", 1, SCALAR_BYTES, _live(mesh, p))
    return tally


def _live(mesh, axes) -> Tuple[str, ...]:
    """``axes`` of more than one rank, in the mesh's order."""
    return tuple(a for a in mesh.shape if a in axes and mesh.shape[a] > 1)


def _layers(leaves: List[Leaf], group: str, count: int) -> List[List[Leaf]]:
    """The leaves of one layer of a stacked group, ``count`` times (every
    layer of a stack has the same blocks)."""
    return [_subtree(leaves, "/" + group)] * count


def serve_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, one_process: bool = False) -> _Tally:
    """The weight gathers of one ``Model.prefill`` or ``decode_step`` on a
    rank of ``mesh``, in the model's dtype: the embedding (prefill: where
    the input is tokens; decode: always), the meta tokens (prefill), every
    layer of the trunk, the unembedding; whisper's prefill also gathers
    its encoder's layers and, for the cross K / V, its decoder's once
    more. None where ``one_process`` runs every rank."""
    tally = _Tally()
    if one_process or not batch_axes(mesh):
        return tally
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
    return tally


# -- the activation collectives ------------------------------------------------


class _TP:
    """``models.common.TP`` as the walk sees it: the ``model`` axis's
    size and the activations' layout (``seq``: sequence blocks)."""

    def __init__(self, p: int, seq: bool = False):
        self.p, self.seq = p, seq and p > 1

    def splits(self, units: Optional[int]) -> bool:
        return self.p > 1 and units is not None and units % self.p == 0

    def with_seq(self, seq: bool) -> "_TP":
        return _TP(self.p, seq)


class _Acts:
    """The collectives one rank's model code issues over ``model`` (and
    the MoE ring's aux over the batch axes), following ``models``' call
    sites shape by shape: each forward collective ``fm`` times (2 inside
    ``_remat`` and the checkpointed loss chunks: the recompute issues it
    again), each backward one (Megatron's "f" all-reduce of
    ``TP.vary``, the inverse all-to-all, the ring hops' reverse sends)
    once where autograd records (``train``) and the tensor requires a
    gradient (``g``)."""

    def __init__(self, cfg: ModelConfig, mesh, train: bool, one_process: bool = False):
        self.cfg, self.mesh, self.train = cfg, mesh, train
        self.tally = _Tally()
        self.fm = 1
        self.it = _itemsize(cfg.dtype)
        self.wit = self.it  # the weights' dtype (the MTP module runs on the float32 masters)
        self.shapes = abstract(cfg)[0]
        self.batch = () if one_process else batch_axes(mesh)
        #: the mesh ``models.moe`` runs over: the rank's ``model`` ring where it holds its rows of a
        #: batch split over processes, else the whole mesh
        self.moe_mesh = (MeshShape((mesh.shape.get("model", 1),), ("model",)) if self.batch
                         else MeshShape(tuple(mesh.shape.values()), tuple(mesh.shape)))

    # -- counting ----------------------------------------------------------------
    def fwd(self, kind: str, nbytes: int, axes=("model",)) -> None:
        self.tally.add(kind, self.fm, self.fm * nbytes, _live(self.mesh, axes))

    def bwd(self, kind: str, nbytes: int, g: bool = True, axes=("model",)) -> None:
        if self.train and g:
            self.tally.add(kind, 1, nbytes, _live(self.mesh, axes))

    def leaf(self, *path) -> int:
        """The bytes of one layer's leaf at ``path`` (a stacked group's
        layer, the leading dim dropped) in the weights' dtype."""
        a = _dig(self.shapes, path)
        n = math.prod(a.shape[1:]) if path[0] in {g.name for g in build_groups(self.cfg)} else a.numel()
        return n * self.wit

    def norm_leaves(self, *path) -> List[int]:
        return [self.leaf(*path, k) for k in sorted(_dig(self.shapes, path))]

    # -- common.TP ---------------------------------------------------------------
    def vary(self, tp: _TP, nbytes: int, when: bool = True, g: bool = True) -> None:
        if when and tp.p > 1:
            self.bwd("all-reduce", nbytes, g)

    def psum(self, tp: _TP, nbytes: int) -> None:
        if tp.p > 1:
            self.fwd("all-reduce", nbytes)

    def gather(self, tp: _TP, whole: int) -> None:
        if tp.p > 1:
            self.fwd("all-gather", whole)

    def a2a(self, nbytes: int, g: bool = True) -> None:
        self.fwd("all-to-all", nbytes)
        self.bwd("all-to-all", nbytes, g)

    def hops(self, n: int, nbytes: int, g: bool = True) -> None:
        for _ in range(n):
            self.fwd("collective-permute", nbytes)
            self.bwd("collective-permute", nbytes, g)

    def col(self, tp: _TP, xb: int, split: bool, whole_varied: Sequence[int] = (), g: bool = True) -> None:
        """``TP.col`` of activations of ``xb`` bytes over the whole
        sequence; ``whole_varied``: the leaves kept whole that ``ws_of``
        passes through ``TP.vary`` (once a call of ``ws_of``: once on
        replicated activations, once a chunk of the ring on sequence
        blocks)."""
        if not tp.seq:
            self.vary(tp, xb, split, g)
            calls = 1
        else:
            self.hops(tp.p - 1, xb // tp.p, g)
            calls = tp.p
        for _ in range(calls):
            for w in whole_varied:
                self.vary(tp, w)

    @contextlib.contextmanager
    def last(self, on: bool = True):
        """A layer's collectives after its last tensor saved for the
        backward: the remat'd layer's recompute stops before them
        (``torch.utils.checkpoint``'s early stop), so they run once."""
        fm = self.fm
        if on:
            self.fm = 1
        try:
            yield
        finally:
            self.fm = fm

    def reduce(self, tp: _TP, kind: str, whole: int, g: bool = True) -> None:
        if kind == "seq":
            if not tp.seq:
                self.gather(tp, whole)
        elif not tp.seq:
            if kind == "partial":
                self.psum(tp, whole)
        elif kind == "partial":
            self.hops(tp.p - 1, whole // tp.p, g)

    def norm(self, tp: _TP, *path) -> None:
        if tp.seq:
            for w in self.norm_leaves(*path):
                self.vary(tp, w)

    # -- the layers ----------------------------------------------------------------
    def attention(self, tp: _TP, pre: tuple, b: int, s: int, *, cache: bool = False, g: bool = True) -> None:
        """``attention._full_attention`` (train, prefill, the encoder's)
        over ``s`` positions."""
        cfg, it = self.cfg, self.it
        h, kvh, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.d_model
        heads, kv = tp.splits(h), tp.splits(kvh)
        context = _context(cfg, tp) and s % tp.p == 0
        rs = heads or tp.seq
        whole = [self.leaf(*pre, n) for n, u in (("wq", h), ("wk", kvh), ("wv", kvh)) if not tp.splits(u) and rs]
        self.col(tp, b * s * d * it, heads, whole, g)
        if cfg.qkv_bias:
            for n, u in (("bq", h), ("bk", kvh), ("bv", kvh)):
                if not tp.splits(u) and rs:
                    self.vary(tp, self.leaf(*pre, n))
        kvb = b * s * kvh * hd * it
        if context and kv:  # a cache takes the rank's KV heads, or its slices of the whole K / V
            self.gather(tp, kvb)
            self.gather(tp, kvb)
        if not context:
            if not heads and rs:
                self.vary(tp, self.leaf(*pre, "wo"))
            self.reduce(tp, "partial" if heads else "whole", b * s * d * it, g)
            return
        if heads:
            self.a2a(b * s * (h // tp.p) * hd * it)
        elif not rs:
            self.vary(tp, b * s * h * hd * it)
        if kv or not rs:
            self.vary(tp, kvb)
            self.vary(tp, kvb)
        if heads:
            self.a2a(b * s * (h // tp.p) * hd * it)
            self.reduce(tp, "partial", b * s * d * it, g)
        else:
            self.vary(tp, self.leaf(*pre, "wo"))
            self.reduce(tp, "seq", b * s * d * it, g)

    def combine(self, b: int, nh: int, dv: int) -> None:
        """``attention.flash_decode_combine`` over ``data``: the pmax of
        the float32 (B, H') maxima, the psums of the (B, 1, H', Dv)
        outputs and of the (B, H') sums, for ``nh`` heads a rank."""
        for nbytes in (b * nh * 4, b * nh * dv * 4, b * nh * 4):
            self.fwd("all-reduce", nbytes, axes=("data",))

    def decode_attention(self, tp: _TP, b: int, s_kv: int, blocks: int) -> None:
        """``attention.decode_attention`` over a cache of ``s_kv``
        positions in ``blocks`` sequence blocks over ``data``: on a
        head-dim cut the step's queries gathered (head blocks), one psum
        of the float32 scores of every head against the rank's block, the
        output's all-to-all back to the head blocks (or a whole ``wo``'s
        partial sums); over ``data`` the combine's pmax and two psums, of
        float32 (B, H') and (B, 1, H', Dv); the psum of the output."""
        cfg, it = self.cfg, self.it
        h, hd = cfg.num_heads, cfg.head_dim_
        heads = tp.splits(h)
        cut = cache_model_dim(cfg.num_kv_heads, hd, tp.p) if tp.p > 1 else None
        if cut == 3:
            if heads:
                self.gather(tp, b * h * hd * it)
            self.psum(tp, b * h * (s_kv // blocks) * 4)
            if heads:
                self.a2a(b * h * (hd // tp.p) * it)
        if blocks > 1:
            self.combine(b, h // tp.p if heads and cut != 3 else h, hd // tp.p if cut == 3 else hd)
        self.reduce(tp, "partial" if heads or cut == 3 else "whole", b * cfg.d_model * it)

    def mla(self, tp: _TP, pre: tuple, b: int, s: int, g: bool = True) -> None:
        """``attention._mla_expanded`` (train and prefill); decode
        (``s == 1`` under ``decode``) reduces alone."""
        cfg, it, m = self.cfg, self.it, self.cfg.mla
        seq, split = tp.seq, tp.splits(cfg.num_heads)
        enter = split and not seq
        self.norm(tp, *pre, "q_norm")
        self.norm(tp, *pre, "kv_norm")
        self.col(tp, b * s * cfg.d_model * it, False,
                 [self.leaf(*pre, "wdq"), self.leaf(*pre, "wdkv")] if seq else [], g)
        if enter:
            self.vary(tp, b * s * m.q_lora_rank * it)
        if not split and seq:
            self.vary(tp, self.leaf(*pre, "wuq"))
        if enter:
            self.vary(tp, b * s * m.kv_lora_rank * it)
            self.vary(tp, b * s * m.rope_head_dim * it)
        if not split and seq:
            self.vary(tp, self.leaf(*pre, "wukv"))
            self.vary(tp, self.leaf(*pre, "wo"))
        self.reduce(tp, "partial" if split else "whole", b * s * cfg.d_model * it, g)

    def mlp(self, tp: _TP, pre: tuple, b: int, s: int, d_ff: int, g: bool = True, last: bool = False) -> None:
        from repro_torch.models.mlp import GATED

        split = tp.splits(d_ff)
        names = ("wg", "wu") if self.cfg.mlp_kind in GATED else ("wu",)
        self.col(tp, b * s * self.cfg.d_model * self.it, split,
                 [self.leaf(*pre, n) for n in names] if not split and tp.seq else [], g)
        if not split and tp.seq:
            self.vary(tp, self.leaf(*pre, "wd"))
        with self.last(last):
            self.reduce(tp, "partial" if split else "whole", b * s * self.cfg.d_model * self.it, g)

    def moe(self, tp: _TP, pre: tuple, b: int, s: int, last: bool = False) -> None:
        """``moe.apply_moe`` on replicated (B, S, d) activations."""
        cfg, it, mo = self.cfg, self.it, self.cfg.moe
        d, e = cfg.d_model, mo.num_experts
        mesh = self.moe_mesh
        shape, pn = mesh.shape, mesh.shape.get("model", 1)
        dispatch = mo.dispatch
        if dispatch == "ring" and (pn == 1 or e % pn or s % pn):
            dispatch = "einsum"
        if dispatch == "ring":
            self.vary(tp, self.leaf(*pre, "router"))
            self.vary(tp, b * s * d * it)
            rows = b // _size(shape, sharding.resolve(mesh, "batch")[0])
            cap = moe_lib._capacity(rows * (s // pn), mo.top_k, e, mo.capacity_factor)
            self.hops(2 * (pn - 1), (e // pn) * cap * d * it)
            with self.last(last and not mo.num_shared):  # the islands combined: nothing saved after
                self.fwd("all-gather", b * s * d * it, tuple(shape))
                self.fwd("all-gather", math.prod(shape.values()) * 4, tuple(shape))  # each island's (1, 1) aux
                if self.batch:  # every data group's aux mean
                    self.fwd("all-gather", _size(self.mesh.shape, self.batch) * 4, self.batch)
        elif dispatch == "dense" and self.batch:  # the aux's counts and sums over every row
            self.fwd("all-reduce", (2 * e + 1) * 4, self.batch)
        elif dispatch == "einsum" and math.prod(shape.values()) > 1:
            t = b * s
            groups = moe_lib._groups(mesh, t)
            cap = moe_lib._capacity(t // groups, mo.top_k, e, mo.capacity_factor)
            buf = (groups, e, cap, d)
            spec = sharding.resolve(mesh, "batch", "experts", "expert_cap", None, shape=buf)
            if any(spec):
                if spec[1] is None:
                    for n in ("wg", "wu", "wd"):
                        if n in _dig(self.shapes, pre):
                            self.vary(tp, self.leaf(*pre, n))
                self.vary(tp, math.prod(buf) * it)
                cut = math.prod(_size(shape, entry) for entry in spec)
                ranks = shape["model"] if len(shape) == 1 else math.prod(shape.values())
                self.fwd("all-gather", ranks * math.prod(buf) * it // cut, tuple(shape))
        if mo.num_shared:
            self.mlp(tp, pre + ("shared",), b, s, (mo.expert_d_ff or cfg.d_ff) * mo.num_shared, last=last)

    def mamba(self, tp: _TP, pre: tuple, b: int, s: int, g: bool = True) -> None:
        cfg = self.cfg
        di, n = int(cfg.ssm.expand * cfg.d_model), cfg.ssm.state_dim
        split = tp.splits(di)
        self.col(tp, b * s * cfg.d_model * self.it, split, (), g)
        if split:
            self.psum(tp, b * s * (2 * n + di) * 4)
            self.vary(tp, b * s * 2 * n * 4)
            self.vary(tp, b * s * di * 4)
        self.reduce(tp, "partial" if split else "whole", b * s * cfg.d_model * self.it, g)

    def mlstm(self, tp: _TP, pre: tuple, b: int, s: int, g: bool = True, last: bool = False) -> None:
        cfg, it = self.cfg, self.it
        di = int(cfg.ssm.expand * cfg.d_model)
        split, by_heads = tp.splits(di), tp.splits(cfg.num_heads)
        self.col(tp, b * s * cfg.d_model * it, split, (), g)
        if split:
            self.gather(tp, b * s * di * it)
            self.gather(tp, b * s * di * it)
        if by_heads:
            self.vary(tp, b * s * di * it)
            self.vary(tp, b * s * di * it)
            self.vary(tp, self.leaf(*pre, "gn", "scale"))
        elif split:
            self.vary(tp, b * s * di * it)
        with self.last(last):
            self.reduce(tp, "partial" if split else "whole", b * s * cfg.d_model * it, g)

    def slstm(self, tp: _TP, b: int, s: int, g: bool = True, last: bool = False) -> None:
        cfg, it, d = self.cfg, self.it, self.cfg.d_model
        split = tp.splits(4 * d)
        self.col(tp, b * s * d * 4, split, (), g)
        if split:
            self.gather(tp, b * s * 4 * d * 4)
        fsplit = tp.splits(int(d * 4 / 3))
        self.col(tp, b * s * d * it, fsplit, (), g)
        with self.last(last):
            self.reduce(tp, "partial" if fsplit else "whole", b * s * d * it, g)

    def cross(self, tp: _TP, pre: tuple, b: int, s: int, s_enc: int, g: bool = True) -> None:
        """``blocks._cross``."""
        cfg, it = self.cfg, self.it
        split, kvs = tp.splits(cfg.num_heads), tp.splits(cfg.num_kv_heads)
        rs = split or tp.seq
        self.norm(tp, *pre, "lnc")
        self.col(tp, b * s * cfg.d_model * it, split, [self.leaf(*pre, "cross", "wq")] if not split and rs else [], g)
        if not kvs and rs:
            for _ in range(2):
                self.vary(tp, b * s_enc * cfg.num_kv_heads * cfg.head_dim_ * it)
        if not split and rs:
            self.vary(tp, self.leaf(*pre, "cross", "wo"))
        self.reduce(tp, "partial" if split else "whole", b * s * cfg.d_model * it, g)

    def decoder(self, tp: _TP, pre: tuple, b: int, s: int, moe: bool, *, cache: bool = False,
                s_enc: int = 0, remat: bool = False) -> None:
        """``blocks.apply_decoder_block`` / ``prefill_decoder_block`` over
        ``s`` positions (the cross-attention's K / V projected by the
        caller)."""
        cfg, it = self.cfg, self.it
        self.norm(tp, *pre, "ln1")
        if cfg.mla is not None:
            self.mla(tp, pre + ("attn",), b, s)
        else:
            self.attention(tp, pre + ("attn",), b, s, cache=cache)
        if cfg.post_norm:
            self.norm(tp, *pre, "ln1p")
        if s_enc:
            self.cross(tp, pre, b, s, s_enc)
        self.norm(tp, *pre, "ln2")
        last = remat and not cfg.post_norm  # the post-norm saves tensors after the FFN's reduce
        if moe:
            if tp.seq:  # TP.whole: the sequence blocks gathered for the experts
                self.gather(tp, b * s * cfg.d_model * it)
            self.moe(tp.with_seq(False), pre + ("ffn",), b, s, last)
            if tp.seq:
                self.vary(tp, b * s * cfg.d_model * it)
        else:
            self.mlp(tp, pre + ("ffn",), b, s, cfg.d_ff, last=last)
        if cfg.post_norm:
            self.norm(tp, *pre, "ln2p")

    def decode_decoder(self, tp: _TP, pre: tuple, b: int, moe: bool, s_kv: int, blocks: int,
                       s_enc: int = 0) -> None:
        cfg = self.cfg
        if cfg.mla is not None:  # ``attention.decode_mla``: over ``data`` the combine, then the psum
            split = tp.splits(cfg.num_heads)
            if blocks > 1:
                self.combine(b, cfg.num_heads // tp.p if split else cfg.num_heads, cfg.mla.v_head_dim)
            self.reduce(tp, "partial" if split else "whole", b * cfg.d_model * self.it)
        else:
            self.decode_attention(tp, b, s_kv, blocks)
        if s_enc:
            self.cross(tp, pre, b, 1, s_enc)
        if moe:
            self.moe(tp, pre + ("ffn",), b, 1)
        else:
            self.mlp(tp, pre + ("ffn",), b, 1, cfg.d_ff)

    def layer(self, tp: _TP, g, b: int, s: int, *, cache: bool = False, s_enc: int = 0,
              remat: bool = False) -> None:
        """One layer of group ``g`` over ``s`` positions (train or prefill;
        ``remat``: recomputed in the backward, but for its trailing
        collectives, :meth:`last`)."""
        pre = (g.name,)
        if g.kind == "hymba":
            self.attention(tp, pre + ("attn",), b, s, cache=cache)
            self.mamba(tp, pre + ("mamba",), b, s)
            self.mlp(tp, pre + ("ffn",), b, s, self.cfg.d_ff, last=remat)
        elif g.kind in ("xlstm_pair", "xlstm_m"):
            self.mlstm(tp, pre + ("m",), b, s, last=remat and g.kind == "xlstm_m")
            if g.kind == "xlstm_pair":
                self.slstm(tp, b, s, last=remat)
        elif g.kind == "enc":
            self.norm(tp, *pre, "ln1")
            self.attention(tp, pre + ("attn",), b, s)
            self.norm(tp, *pre, "ln2")
            self.mlp(tp, pre + ("ffn",), b, s, self.cfg.d_ff)
        else:
            self.decoder(tp, pre, b, s, g.kind == "dec_moe", cache=cache, s_enc=s_enc, remat=remat)

    def decode_layer(self, tp: _TP, g, b: int, s_kv: int, blocks: int = 1, s_enc: int = 0) -> None:
        """One layer of a decode step over a cache of ``s_kv`` positions
        (``blocks`` sequence blocks over ``data``)."""
        pre = (g.name,)
        if g.kind == "hymba":
            self.decode_attention(tp, b, s_kv, blocks)
            self.mamba(tp, pre + ("mamba",), b, 1)
            self.mlp(tp, pre + ("ffn",), b, 1, self.cfg.d_ff)
        elif g.kind in ("xlstm_pair", "xlstm_m"):
            self.mlstm(tp, pre + ("m",), b, 1)
            if g.kind == "xlstm_pair":
                self.slstm(tp, b, 1)
        else:
            self.decode_decoder(tp, pre, b, g.kind == "dec_moe", s_kv, blocks, s_enc)

    def embed(self, tp: _TP, b: int, s: int) -> None:
        """``common.embed_tokens``: one psum where the vocabulary is split."""
        if tp.splits(self.cfg.vocab_size):
            self.psum(tp, b * s * self.cfg.d_model * self.it)

    def unembed_chunks(self, tp: _TP, b: int, s: int) -> None:
        """``losses.chunked_xent``'s unembedding over ``s`` positions: per
        checkpointed chunk the input's "f" and the logits' gather."""
        if not tp.splits(self.cfg.vocab_size):
            return
        chunk = min(1024, s)
        fm, self.fm = self.fm, self.fm + 1  # each chunk's own checkpoint recomputes it once more
        for _ in range(-(-s // chunk)):
            self.vary(tp, b * chunk * self.cfg.d_model * self.it)
            self.gather(tp, b * chunk * self.cfg.vocab_size * self.it)
        self.fm = fm


def _seq_shard(shape: ShapeConfig) -> bool:
    """Whether the cell serves its cache with the sequence over ``data``:
    ``long_500k``, as the reference's dry run sets ``seq_shard``."""
    return shape.name == "long_500k"


def seq_blocks(shape: ShapeConfig, mesh, s_kv: int) -> int:
    """The blocks a serving cache of ``s_kv`` positions lies in over
    ``data`` (``common.seq_blocks``, the model's own rule) where the cell
    is :func:`_seq_shard`, else 1."""
    return common.seq_blocks(mesh.shape.get("data", 1), s_kv) if _seq_shard(shape) else 1


def _context(cfg: ModelConfig, tp: _TP) -> bool:
    """``attention.use_context_parallel``."""
    if tp.p == 1:
        return False
    if cfg.attn_partition == "context":
        return True
    if cfg.attn_partition == "heads":
        return False
    return cfg.num_heads % tp.p != 0


def _size(shape: Dict[str, int], entry) -> int:
    return math.prod(shape[a] for a in _axes(entry))


def _dig(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rows(shape: ShapeConfig, mesh, micro: int = 1, one_process: bool = False) -> int:
    """The rows a rank runs at once: a microbatch's block over the batch
    axes (the whole batch where ``one_process`` runs every rank; a batch
    of one on every rank)."""
    b = shape.global_batch // micro
    if one_process or shape.global_batch == 1:
        return b
    return b // math.prod(mesh.shape[a] for a in STATE_AXES if a in mesh.shape)


def _seq_parallel(cfg: ModelConfig, tp: _TP, s: int) -> bool:
    """``Model.seq_parallel``."""
    return cfg.seq_parallel and cfg.family not in ("ssm", "hybrid") and tp.p > 1 and s % tp.p == 0


def activation_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                           tcfg: TrainConfig = PRODUCTION_TCFG, one_process: bool = False) -> _Tally:
    """The collectives beside the state's one rank of ``mesh`` issues in
    the cell's step: the model's over ``model`` (the tensor-parallel
    psums and the Megatron "f" all-reduces of their backward, the
    sequence-parallel rings' hops, the vocabulary's psum and gathers, the
    context partition's gathers and all-to-alls, the MoE dispatches'
    gathers and hops, the SSM splits' psums and gathers), the MoE ring's
    aux over the batch axes, and the train step's clip norm over the sets
    of leaves placed on ``model`` alone. With ``one_process``, what a
    ``SimMesh``'s process counts (``core.mesh.collectives``: one rank's
    share): every rank on the whole batch, the data axis holding it, no
    clip over ``model`` (the step places no leaf there)."""
    w = _Acts(cfg, mesh, shape.kind == "train", one_process)
    tp = _TP(mesh.shape.get("model", 1))
    s, d, it = shape.seq_len, cfg.d_model, w.it
    groups = build_groups(cfg)
    if shape.kind == "decode":
        b = _rows(shape, mesh, one_process=one_process)
        w.embed(tp, b, 1)
        s_enc = s if cfg.is_encdec else 0
        s_kv = s + cfg.meta_tokens
        blocks = seq_blocks(shape, mesh, s_kv)
        for g in _trunk_groups(cfg):
            for _ in range(g.count):
                w.decode_layer(tp, g, b, s_kv, blocks, s_enc)
        if tp.splits(cfg.vocab_size):  # the logits' gather
            w.gather(tp, b * cfg.vocab_size * 4)
        return w.tally
    micro = (tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1) if shape.kind == "train" else 1
    b = _rows(shape, mesh, micro, one_process)
    again = 1 if shape.kind != "train" or cfg.remat == "none" else 2
    for _ in range(micro):
        s_enc = 0
        if cfg.is_encdec:  # the encoder once (no remat), whole on every rank after it
            s_enc, s = shape.seq_len, max(shape.seq_len // cfg.decoder_ratio, 1)
            enc = groups[0]
            etp = tp.with_seq(_seq_parallel(cfg, tp, s_enc))
            for _ in range(enc.count):
                w.layer(etp, enc, b, s_enc)
            if etp.seq:
                w.gather(etp, b * s_enc * d * it)
        tokens = cfg.is_encdec or cfg.input_kind != "embeddings"
        if tokens:
            w.embed(tp, b, s)
        pos = s + cfg.meta_tokens
        ttp = tp.with_seq(_seq_parallel(cfg, tp, pos)) if shape.kind == "train" else tp
        if ttp.seq:  # into sequence blocks: the embeddings from the batch need no gradient
            w.vary(ttp, b * pos * d * it, g=tokens or cfg.meta_tokens > 0)
        for g in _trunk_groups(cfg):
            for _ in range(g.count):
                w.fm = again
                if g.cross and shape.kind == "train":  # cross_kv_proj inside the layer, over replicated rows
                    w.col(tp, b * s_enc * d * it, tp.splits(cfg.num_kv_heads))
                w.layer(ttp, g, b, pos, cache=shape.kind == "prefill", s_enc=s_enc, remat=again == 2)
                w.fm = 1
        if shape.kind != "train":
            if tp.splits(cfg.vocab_size):
                w.gather(tp, b * cfg.vocab_size * 4)
            continue
        w.norm(ttp, "final_norm")
        if ttp.seq:
            w.gather(ttp, b * pos * d * it)
        w.unembed_chunks(tp, b, s)
        if cfg.mtp_depth > 0 and tokens:
            _mtp(w, tp, b, s)
    if shape.kind == "train" and not one_process:
        for p in {sharding.placed_axes(leaf.where) for leaf in weight_leaves(cfg, mesh)}:
            if p and not any(a in STATE_AXES for a in p):  # the clip's norm over model alone
                w.tally.add("all-reduce", 1, SCALAR_BYTES, _live(mesh, p))
    return w.tally


def _mtp(w: _Acts, tp: _TP, b: int, s: int) -> None:
    """``Model._mtp_loss`` under its checkpoint: the next tokens' lookup,
    the block on the float32 masters (replicated activations), the
    chunked loss over ``s - 1`` positions."""
    cfg = w.cfg
    w.fm, w.wit = 2, 4
    w.embed(tp, b, s - 1)
    use_moe = cfg.moe is not None and cfg.moe.first_k_dense < cfg.num_layers
    w.decoder(tp, ("mtp", "block"), b, s - 1, use_moe)
    w.unembed_chunks(tp, b, s - 1)
    w.fm, w.wit = 1, w.it
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
                                            seq_shard=_seq_shard(shape))
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


def memory(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig, peak: int) -> Dict[str, Any]:
    """The cell's ``memory`` entry (see the module docstring): the walk's
    arguments, outputs and aliases, and the temporaries as the rest of
    ``peak`` (:func:`executed`'s), so that ``peak_device_bytes`` is the
    reference's arguments + temporaries + outputs - aliases.
    ``floor_bytes`` is the peak without temporaries."""
    args = arguments(cfg, shape, mesh, tcfg)
    alias = sum(v for k, v in args.items() if donated(shape, k))
    total, outs = sum(args.values()), sum(outputs(cfg, shape, mesh, tcfg).values())
    floor = total + outs - alias
    temp = peak - floor
    return {
        "argument_bytes": total,
        "output_bytes": outs,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "peak_device_bytes": total + temp + outs - alias,
        "floor_bytes": floor,
    }


# ---------------------------------------------------------------------------
# the executed half: one rank's step, traced on the ``meta`` device
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops that allocate and write nothing (no kernel)
_ALLOCATE = frozenset({_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
                       _aten.new_empty.default, _aten.new_empty_strided.default})
#: ops that make a view or an alias without saying so in their schema
_ALIASES = frozenset({_aten._unsafe_view.default, _aten.lift_fresh.default})
#: in-place ops that change a tensor's sizes or strides: always run, never replayed
_RESHAPING = frozenset({"resize_", "resize_as_", "set_", "as_strided_", "squeeze_", "unsqueeze_", "transpose_",
                        "t_", "swapdims_", "swapaxes_", "detach_"})


class _Op(NamedTuple):
    """What :class:`StepTally` knows of an aten op: whether it decomposes
    (a composite op: its parts are counted), how it moves bytes ("view":
    every output aliases an input, or one of ``_ALIASES`` -- metadata
    only; "alloc": one of ``_ALLOCATE`` -- memory, no bytes; "inplace":
    an output written in place -- that operand counted read and written;
    "fresh": new outputs), its FLOP formula and whether a meta trace may
    replay it."""

    decomposes: bool
    kind: str
    flops: Any
    replay: bool


_OPS: Dict[Any, _Op] = {}


def _op(func) -> _Op:
    from torch.utils.flop_counter import flop_registry

    info = _OPS.get(func)
    if info is None:
        alias = [r.alias_info for r in func._schema.returns]
        if any(a is not None and a.is_write for a in alias):
            kind = "inplace"
        elif (alias and all(a is not None for a in alias)) or func in _ALIASES:
            kind = "view"
        else:
            kind = "alloc" if func in _ALLOCATE else "fresh"
        replay = kind == "fresh" or (kind == "inplace" and func._overloadpacket.__name__ not in _RESHAPING)
        info = _OPS[func] = _Op(func.has_kernel_for_dispatch_key(torch._C.DispatchKey.CompositeImplicitAutograd),
                                kind, flop_registry.get(func._overloadpacket), replay)
    return info


def _sig(x):
    """What an op's output metadata depends on: a tensor's shape, strides,
    offset, dtype and device; any other argument itself."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.storage_offset(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(map(_sig, x))
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    return x


def _tensors(tree, out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists, dicts and NamedTuples."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: the meta trace's replay cache (:class:`StepTally`), shared by every cell
_REPLAY: dict = {}


class StepTally:
    """What a step executes on ``device``, op by op, as a
    ``TorchDispatchMode`` over the aten ops it dispatches (the backward's
    and remat's recompute too; the ``with`` block enters it):

    - ``flops``: ``torch.utils.flop_counter``'s count of each op (its
      ``flop_registry``: the matrix products and convolutions, the
      reference's rule of dots), what ``FlopCounterMode`` counts; a
      composite op is decomposed first, as ``FlopCounterMode`` does;
    - ``moved``: the HBM bytes of an eager program, every op that launches
      a kernel reading each tensor operand once and writing each output
      once (an in-place op's operand is read and written). Left out:
      views and aliases (an op whose every output aliases an input, and
      ``aten._unsafe_view`` / ``aten.lift_fresh``), allocations that write
      nothing (``aten.empty*`` / ``new_empty*``), and ops with no tensor on
      ``device`` (host scalars);
    - ``live`` / ``peak``: the bytes of the storages on ``device`` alive,
      from each storage's first appearance as an op's output (or
      :meth:`hold`) to its release, and their largest sum;
    - ``phases``: ``[peak, flops, moved]`` of each phase of the step,
      a phase ending where a backward pass begins or ends (a train step
      with microbatches: each microbatch's forward, with the previous
      one's accumulation, and its backward, then the update), or where
      :meth:`mark` names another part; ``profile`` the bytes alive after
      each op of the last phase.

    On ``meta`` it replays an op it has run before on the same metadata
    (:data:`_REPLAY`, shared by every trace): its fresh outputs made with
    ``empty_strided`` (an in-place op returns its operand), so a loop's
    repeated bodies cost no meta kernel. Python's cycle collector is off
    inside, so releases follow the references alone."""

    def __init__(self, device):
        from torch.utils._python_dispatch import TorchDispatchMode

        tally = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return tally._dispatch(func, args, kwargs or {})

        self._mode = _Mode()
        self.device = torch.device(device).type
        self.live = self.peak = 0
        self.phases: List[List[int]] = [[0, 0, 0]]
        #: the bytes alive after each op of the current phase
        self.profile: List[int] = []
        self._phase: Tuple[bool, Optional[str]] = (False, None)
        self._mark: Optional[str] = None
        self._held: Dict[int, Any] = {}
        self._cache = _REPLAY if self.device == "meta" else None

    @property
    def flops(self) -> int:
        return sum(ph[1] for ph in self.phases)

    @property
    def moved(self) -> int:
        return sum(ph[2] for ph in self.phases)

    def hold(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        """Count ``t``'s storage live from now (``nbytes``: in place of the
        storage's own size) until it is released."""
        if t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self._held[key] = weakref.ref(st, functools.partial(self._release, key, n))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        phase = self.phases[-1]
        if self.live > phase[0]:
            phase[0] = self.live

    def mark(self, name: Optional[str]) -> None:
        """Start a new phase at the next op where ``name`` differs from the
        last mark (the trace marks each layer group it enters)."""
        self._mark = name

    def _release(self, key: int, n: int, _ref) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= n

    def __enter__(self) -> "StepTally":
        import gc

        self._gc = gc.isenabled()
        gc.disable()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import gc

        self._mode.__exit__(*exc)
        if self._gc:
            gc.enable()

    def _dispatch(self, func, args, kwargs):
        info = _OPS.get(func) or _op(func)
        if info.decomposes:  # as FlopCounterMode does (inference mode hands composite ops down)
            with self._mode:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = key = None
        cache = self._cache
        if cache is not None and info.replay:
            key = (func, _sig(args), _sig(kwargs) if kwargs else None)
            hit = cache.get(key)
            if hit is not None:
                out = self._replayed(hit, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
            if key is not None:
                self._remember(cache, key, out, args, kwargs, info.kind)
        outs = _tensors(out)
        ins = _tensors(kwargs, _tensors(args)) if kwargs else _tensors(args)
        dev = self.device
        if not any(t.device.type == dev for t in outs) and not any(t.device.type == dev for t in ins):
            return out
        phase = (torch._C._current_graph_task_id() != -1, self._mark)
        if phase != self._phase:
            self._phase = phase
            self.phases.append([self.live, 0, 0])
            self.profile = []
        phase = self.phases[-1]
        if info.flops is not None:
            phase[1] += info.flops(*args, **kwargs, out_val=out)
        if info.kind == "fresh" or info.kind == "inplace":
            phase[2] += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self.hold(t)
        self.profile.append(self.live)
        return out

    @staticmethod
    def _replayed(hit, args, kwargs):
        if hit == "self":
            return args[0]
        if hit == "out":
            return kwargs["out"]
        spec, metas = hit
        leaves = [torch.empty_strided(sz, st, dtype=dt, device="meta") for sz, st, dt in metas]
        if spec is None:
            return leaves[0]
        from torch.utils._pytree import tree_unflatten

        return tree_unflatten(leaves, spec)

    @staticmethod
    def _remember(cache, key, out, args, kwargs, kind) -> None:
        """Keep what replays ``out``: an in-place op's operand, or a fresh
        op's outputs' metadata where ``empty_strided`` makes the same
        storages."""
        if kind == "inplace":
            if args and out is args[0]:
                cache[key] = "self"
            elif out is kwargs.get("out"):
                cache[key] = "out"
            return
        from torch.utils._pytree import tree_structure

        leaves = _tensors(out)
        if leaves and all(isinstance(t, torch.Tensor) and t.device.type == "meta" and t.storage_offset() == 0
                          and t.untyped_storage().nbytes() == torch.empty_strided(
                              t.shape, t.stride(), dtype=t.dtype, device="meta").untyped_storage().nbytes()
                          for t in leaves):
            cache[key] = (None if isinstance(out, torch.Tensor) else tree_structure(out),
                          [(t.shape, t.stride(), t.dtype) for t in leaves])


def _patterns(cfg: ModelConfig) -> Dict[Tuple[str, bool], int]:
    """Each distinct layer of the model -- (group, is_global): the group
    fixes its kind and whether it has cross-attention -- and how many
    layers of it the model has, in the order they first appear."""
    out: Dict[Tuple[str, bool], int] = {}
    for g in build_groups(cfg):
        for i in range(g.count):
            key = (g.name, g.static_global if g.flags is None else g.flags[i])
            out[key] = out.get(key, 0) + 1
    return out


def _groups_of(cfg: ModelConfig, counts: Dict[Tuple[str, bool], int]):
    """The model's groups holding ``counts`` layers of each pattern (a
    group's patterns in their order, each repeated)."""
    out = []
    for g in build_groups(cfg):
        flags = [f for (name, f), n in counts.items() if name == g.name for _ in range(n)]
        out.append(dataclasses.replace(g, count=len(flags), flags=None if g.flags is None else tuple(flags)))
    return out


def _rank_rows(shape: ShapeConfig, mesh) -> int:
    """The rows of a serving batch a rank holds: its block over the batch
    axes (all of a batch of one)."""
    b = shape.global_batch
    return b if b == 1 else b // math.prod(mesh.shape[a] for a in STATE_AXES if a in mesh.shape)


def _trace(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig, groups, whole: bool = False,
           device="meta") -> Dict[str, Any]:
    """One rank's step of a model holding ``groups``, traced on the
    ``meta`` device over a ``core.mesh.MetaRankMesh`` of ``mesh``'s
    axes under :class:`StepTally`: the state and batch made first and
    held live from the start, then the cell's entry point --
    ``train.make_train_step``'s step, ``Model.prefill`` or
    ``Model.decode_step``.

    A train step of more than two microbatches is traced with two (the
    same rows each) and extended: its later microbatches repeat the
    second's forward and backward phases, and its batch is held at its
    own size (unless ``whole``). On another ``device`` (a grid of one
    rank) the same step runs on real tensors, the weights drawn, the
    inputs zeros."""
    from repro_torch.core.mesh import MetaRankMesh
    from repro_torch.train import init_train_state, make_train_step

    micro = tcfg.microbatch if shape.kind == "train" and tcfg.microbatch and tcfg.microbatch > 2 else 0
    micro = 0 if whole else micro
    if micro:
        tcfg = dataclasses.replace(tcfg, microbatch=2)
        shape = dataclasses.replace(shape, global_batch=shape.global_batch // micro * 2)
    rank = MetaRankMesh(tuple(mesh.shape.values()), tuple(mesh.shape), device=device)
    tally = StepTally(device)
    # a serving step's phases: each group of layers it runs through
    model = Model(cfg, rank, device=device, groups=groups, on_layer=None if shape.kind == "train" else tally.mark)
    new = functools.partial(torch.empty if device == "meta" else torch.zeros, device=device)
    gen = torch.Generator() if device == "meta" else torch.Generator(device).manual_seed(0)
    held: List[Tuple[torch.Tensor, Optional[int]]] = []
    grown = 0  # the batch's bytes past the traced microbatches'
    if shape.kind == "train":
        state, _ = init_train_state(model, gen, tcfg)
        held += [(t, None) for t in _tensors(tuple(state))]
        batch = {}
        for k, (shp, dtype, spec) in specs_lib.batch_input_specs(cfg, shape, mesh).items():
            # every rank passes the whole batch and reads its rows: held at the rank's block
            batch[k] = new(shp, dtype=getattr(torch, dtype))
            held.append((batch[k], block_bytes(mesh, shp, dtype, spec)))
            if micro:
                full = (shp[0] // 2 * micro,) + tuple(shp[1:])
                grown += block_bytes(mesh, full, dtype, spec) - block_bytes(mesh, shp, dtype, spec)
        run = functools.partial(make_train_step(model, tcfg), state, batch)
    else:
        params, _ = model.init(gen, dtype=model.dtype)
        b, s = _rank_rows(shape, mesh), shape.seq_len
        st = model.init_decode_state(b, s, seq_shard=_seq_shard(shape))
        held += [(t, None) for t in _tensors((params, st))]
        if shape.kind == "prefill":
            batch = {}
            for k, (shp, dtype, _) in specs_lib.batch_input_specs(cfg, shape, mesh).items():
                batch[k] = new((b,) + tuple(shp[1:]), dtype=getattr(torch, dtype))
                held.append((batch[k], None))
            run = functools.partial(model.prefill, params, batch, st)
        else:
            st["pos"] = s - 1  # the new token's query sees the cache's seq_len positions
            if cfg.is_encdec:  # the cross K / V over the frames, as prefill made them
                st["cross"] = model._cross_kv(params, new((b, s, cfg.d_model), dtype=model.dtype))
                held += [(t, None) for t in _tensors(st["cross"])]
            tokens = new((b, 1), dtype=torch.int32)
            held.append((tokens, None))
            run = functools.partial(model.decode_step, params, tokens, st)
    for t, n in held:
        tally.hold(t, n)
    args = tally.live
    with tally:
        out = run()
    live = tally.live
    del out, run
    phases = [list(ph) for ph in tally.phases]
    if micro:  # [F1, B1, F2, B2, U]: F2 and B2 again for each further microbatch
        phases = phases[:4] + [list(ph) for _ in range(micro - 2) for ph in phases[2:4]] + phases[4:]
        for ph in phases:
            ph[0] += grown
    return {"flops": sum(ph[1] for ph in phases), "moved": sum(ph[2] for ph in phases),
            "peaks": [ph[0] for ph in phases], "tail": [n + grown for n in tally.profile], "args": args + grown,
            "live_end": live + grown}


@functools.lru_cache(maxsize=None)
def _warm_up() -> None:
    """One small train step traced once a process and dropped: the first
    step a process traces keeps the learning rate's scalars alive to its
    end (torch's first use of those ops), in that trace alone."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-32b", reduced=True), num_layers=1)
    _trace(cfg, ShapeConfig("warm", 8, 4, "train"), MeshShape((1, 1), ("data", "model")), PRODUCTION_TCFG,
           build_groups(cfg))


#: the loops over positions whose trips the trace caps (``models.common.TRIP_CAPS``)
LOOPS = ("kv", "mamba", "mlstm", "slstm")
#: a loop of at least this many trips is traced at two caps and extended
CAP_FROM = 16
#: the caps it is traced at: CAP and CAP + 1 trips
CAP = 4


def _loop_trips(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, int]:
    """The trips each loop of :data:`LOOPS` makes in the cell's step, as
    the model code counts them (the trace checks them): the KV chunks over
    every position (one length for every attention of a decoder-only
    model; an encoder-decoder's differ and are never capped), Mamba's and
    the mLSTM's chunks and the sLSTM's steps over the positions (none in
    a decode step)."""
    s = shape.seq_len
    pos = s + cfg.meta_tokens
    out: Dict[str, int] = {}
    if cfg.family != "ssm" and not cfg.is_encdec:
        out["kv"] = -(-pos // min(cfg.attn_kv_chunk, pos))
    if shape.kind != "decode" and cfg.ssm is not None:
        if cfg.ssm.kind == "mamba":
            out["mamba"] = -(-pos // min(cfg.ssm.chunk, pos))
        else:
            out["mlstm"] = -(-s // min(cfg.ssm.chunk, s))
            if cfg.ssm.slstm_every:
                out["slstm"] = s
    return out


def _traced(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig, counts, caps: Dict[str, int],
            whole: bool = False) -> Dict[str, Any]:
    """:func:`_trace` of a model holding ``counts`` layers of each
    pattern, its loops capped at ``caps`` trips."""
    old, common.TRIP_CAPS = common.TRIP_CAPS, dict(caps)
    common.TRIPS_SEEN.clear()
    try:
        out = _trace(cfg, shape, mesh, tcfg, _groups_of(cfg, counts), whole)
    finally:
        common.TRIP_CAPS = old
    out["seen"] = {k: set(v) for k, v in common.TRIPS_SEEN.items()}
    return out


def _combine(q00, q_p: Dict[Any, Any], q_l: Dict[Any, Any], q_pl: Dict[Any, Any], a: Dict[Any, int],
             b: Dict[Any, int]):
    """A figure at ``a`` more layers of each pattern and ``b`` more trips of
    each loop than the base trace's ``q00``, from the traces with one
    more layer (``q_p``), one more trip (``q_l``) and both (``q_pl``):
    affine in each, a layer's loops' trips the cross term."""
    out = q00 + sum(a[p] * (q_p[p] - q00) for p in q_p) + sum(b[l] * (q_l[l] - q00) for l in q_l)
    return out + sum(a[p] * b[l] * (q_pl[p, l] - q_p[p] - q_l[l] + q00) for p in q_p for l in q_l)


def executed(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig = PRODUCTION_TCFG, *,
             whole: bool = False) -> Dict[str, Any]:
    """What one rank of ``mesh`` executes in the cell's step, measured by
    running the step's own code on the ``meta`` device (:func:`_trace`):
    ``flops`` as executed (remat's recompute, the chunked attention's
    masked KV chunks, every expert's slots of the einsum dispatch),
    ``hbm_bytes`` as an eager program moves them (:class:`StepTally`),
    ``peak_bytes`` the most bytes alive on the rank, the state and the
    rank's block of the batch included, and ``trace_s``.

    Unless ``whole``, the step is traced small and extended:

    - **depth**: with two layers of each distinct pattern
      (:func:`_patterns`; fewer where the model has fewer), and with one
      layer added for each pattern the model has more of; a layer's share
      extended to the pattern's count;
    - **loops**: each loop over positions of ``CAP_FROM`` trips or more
      (:data:`LOOPS`) run at ``CAP`` and ``CAP + 1`` trips
      (``models.common.TRIP_CAPS``, the skipped trips' outputs stood in
      for), a trip's share extended to the loop's count, with a layer's
      loops as the cross term;
    - **microbatches**: two traced, the later ones repeating the second
      (:func:`_trace`).

    FLOPs and moved bytes add up this way exactly; each phase's peak (a
    phase ends where a backward pass begins or ends) grows by each
    layer's and each trip's share -- saved activations, gradients, state
    -- and a layer's own temporaries count once: the peak is the largest
    phase's. The train step's update after its last backward, the same
    ops at every depth, is extended op by op. Held exactly against
    ``whole`` traces on reduced configs (``tests/test_torch_dryrun_executed.py``).

    ``core.mesh``'s collective counters are left as they were (the traces
    count into them)."""
    from repro_torch.core import mesh as mesh_lib

    counters = (mesh_lib.COLLECTIVE_BYTES, mesh_lib.COLLECTIVE_CALLS, mesh_lib.FSDP_BYTES, mesh_lib.FSDP_CALLS)
    saved = [dict(c) for c in counters]
    try:
        return _executed_step(cfg, shape, mesh, tcfg, whole)
    finally:
        for c, old in zip(counters, saved):
            c.clear()
            c.update(old)


def _executed_step(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig, whole: bool) -> Dict[str, Any]:
    """:func:`executed`'s traces and their extension."""
    import time

    t0 = time.perf_counter()
    _warm_up()
    counts = _patterns(cfg)
    if whole:
        out = _traced(cfg, shape, mesh, tcfg, counts, {}, whole=True)
        return _report(out, max(out["peaks"]), 1, t0)
    base = {p: min(n, 2) for p, n in counts.items()}
    caps = {name: CAP for name, n in _loop_trips(cfg, shape).items() if n >= CAP_FROM}
    first = _traced(cfg, shape, mesh, tcfg, base, caps)
    traced = 1
    loops = {name: next(iter(n)) for name, n in first["seen"].items()
             if name in caps and len(n) == 1 and min(n) >= CAP_FROM}
    if set(loops) != set(caps):  # a loop of several lengths, or shorter than predicted: every trip
        caps = {name: CAP for name in loops}
        first = _traced(cfg, shape, mesh, tcfg, base, caps)
        traced += 1
    more = [p for p, n in counts.items() if n > base[p]]
    t_p = {p: _traced(cfg, shape, mesh, tcfg, {**base, p: base[p] + 1}, caps) for p in more}
    t_l = {l: _traced(cfg, shape, mesh, tcfg, base, {**caps, l: CAP + 1}) for l in loops}
    t_pl = {(p, l): _traced(cfg, shape, mesh, tcfg, {**base, p: base[p] + 1}, {**caps, l: CAP + 1})
            for p in more for l in loops}
    traced += len(t_p) + len(t_l) + len(t_pl)
    a = {p: counts[p] - base[p] for p in more}
    b = {l: loops[l] - CAP for l in loops}

    def fig(key):
        return _combine(first[key], {p: t[key] for p, t in t_p.items()}, {l: t[key] for l, t in t_l.items()},
                        {pl: t[key] for pl, t in t_pl.items()}, a, b)

    out = {key: fig(key) for key in ("flops", "moved", "args")}

    def extend(key):
        return [_combine(first[key][i], {p: t[key][i] for p, t in t_p.items()}, {l: t[key][i] for l, t in t_l.items()},
                         {pl: t[key][i] for pl, t in t_pl.items()}, a, b) for i in range(len(first[key]))]

    peak = max(extend("peaks"))
    if shape.kind == "train" and all(len(t["tail"]) == len(first["tail"])
                                     for t in (*t_p.values(), *t_l.values(), *t_pl.values())):
        # the update after the last backward runs the same ops at every depth: each op's bytes alive extended
        # alone (its largest leaf's temporaries may grow past a constant one's, which the phase's peak hides)
        peak = max(max(extend("peaks")[:-1]), max(extend("tail")))
    return _report(out, peak, traced, t0)


def _report(out: Dict[str, Any], peak: int, traces: int, t0: float) -> Dict[str, Any]:
    import time

    return {"flops": out["flops"], "hbm_bytes": out["moved"], "peak_bytes": peak, "args_bytes": out["args"],
            "traces": traces, "trace_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig = PRODUCTION_TCFG,
                one_process: bool = False) -> Dict[str, Any]:
    """The cell's ``collectives`` entry: ``counts`` and ``bytes`` by the
    reference's five kinds, the bytes shipped (``comm_model.shipped_bytes``
    at each collective's group size: what the reference's
    ``hlo_analysis`` reports), state and activation together; under them
    ``state`` (:func:`train_collectives` / :func:`serve_collectives`) and
    ``activation`` (:func:`activation_collectives`), each the counts and
    the bytes assembled on the rank, as ``core.mesh.collectives`` counts
    them, and its ``shipped`` total. ``one_process``: what a ``SimMesh``'s one process issues
    (:func:`activation_collectives`)."""
    state = (train_collectives(cfg, shape, mesh, tcfg, one_process) if shape.kind == "train"
             else serve_collectives(cfg, shape, mesh, one_process))
    act = activation_collectives(cfg, shape, mesh, tcfg, one_process)
    entries = {"state": state.as_dict("state collectives"), "activation": act.as_dict("activation collectives")}
    for name, tally in (("state", state), ("activation", act)):
        entries[name]["shipped"] = sum(tally.shipped(mesh).values())
    shipped = {k: a + b for (k, a), b in zip(state.shipped(mesh).items(), act.shipped(mesh).values())}
    return {
        "counts": {k: entries["state"]["counts"][k] + entries["activation"]["counts"][k] for k in KINDS},
        "bytes": shipped,
        "scope": "every collective of a rank, bytes shipped (the reference's ring factors)",
        **entries,
    }


def cell_report(cfg: ModelConfig, shape: ShapeConfig, mesh, *, tcfg: Optional[TrainConfig] = None,
                one_process: bool = False) -> Dict[str, Any]:
    """One cell's report on ``mesh`` (anything with a ``.shape`` mapping of
    axis name to size): ``memory`` (the walk's bytes, the executed peak
    and temporaries), ``collectives``, ``executed`` (:func:`executed`:
    one rank's step traced on the ``meta`` device), the reference's
    analytic FLOPs and parameter counts, and the H100 roofline on the
    executed FLOPs and moved bytes. ``tcfg``: the train step's config
    (default ``PRODUCTION_TCFG``). A shape named ``long_500k`` shards its
    caches' sequence (the reference's rule) in the walk. ``one_process``:
    the collectives one process running every rank of a ``SimMesh``
    counts (:func:`collectives`)."""
    tcfg = PRODUCTION_TCFG if tcfg is None else tcfg
    chips = math.prod(mesh.shape.values())
    ex = _executed(cfg, shape, tuple(mesh.shape.values()), tuple(mesh.shape), tcfg)
    mem = memory(cfg, shape, mesh, tcfg, peak=ex["peak_bytes"])
    coll = collectives(cfg, shape, mesh, tcfg, one_process)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    # 6ND for train (fwd 2ND + bwd 4ND); forward-only passes are 2ND (the reference's)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    roof = comm_model.Roofline(
        flops=float(ex["flops"]),  # the rank's, as executed
        hbm_bytes=float(ex["hbm_bytes"]),  # as an eager program moves them
        coll_bytes=float(sum(coll["bytes"].values())),  # shipped
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
        "executed": {k: v for k, v in ex.items() if k != "trace_s"},
        "trace_s": ex["trace_s"],
        "params": n_params,
        "active_params": n_active,
        "tokens_per_step": tokens,
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / chips,
        "useful_flops_frac": (model_flops / chips) / max(roof.flops, 1.0),
    }


@functools.lru_cache(maxsize=256)
def _executed(cfg: ModelConfig, shape: ShapeConfig, dims: Tuple[int, ...], names: Tuple[str, ...],
              tcfg: TrainConfig) -> Dict[str, Any]:
    """:func:`executed` on a ``MeshShape`` of ``dims`` named ``names``,
    once a cell a process."""
    return executed(cfg, shape, MeshShape(dims, names), tcfg)


def run_cell(arch: str, sname: str, mesh_kind: str, *, reduced: bool = False) -> Dict[str, Any]:
    """:func:`cell_report` of ``arch`` x ``sname`` on the single- or the
    multi-pod production mesh, tagged as the reference tags its cells."""
    res = cell_report(get_config(arch, reduced=reduced), SHAPES[sname],
                      make_production_mesh(multi_pod=(mesh_kind == "multi")))
    res.update(arch=arch, mesh=mesh_kind)
    return res


#: the memory of one H100 (80 GB): a cell whose peak a rank exceeds it does not fit
CARD_BYTES = 80 * 10**9
#: the CLI's worker processes at most (one a core)
CLI_WORKERS = 8


def _cell_job(job: Tuple[str, str, str, bool, str]) -> Tuple[str, Optional[str], Optional[Dict[str, Any]]]:
    """One cell of :func:`main`, written to its file: (tag, the error or
    None, a summary or None). Runs in a worker process on one torch
    thread (the trace dispatches small ops); a cell that leaves anything
    in its process (``launch.mesh.touched``) fails."""
    arch, sname, mk, reduced, out_dir = job
    torch.set_num_threads(1)
    # torch's first import of dynamo (lazy: a train step's first op under a
    # dispatch mode) sets TORCHINDUCTOR_CACHE_DIR where it is unset (torch
    # 2.13): the library's own import, so done before the snapshot
    importlib.import_module("torch._dynamo")
    tag = f"{arch}_{sname}_{mk}" + ("_reduced" if reduced else "") + "_torch"
    before = process_state()
    try:
        res = run_cell(arch, sname, mk, reduced=reduced)
        left = touched(before)
        if left:
            raise RuntimeError(f"the cell left in its process: {', '.join(left)}")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
        r = res["roofline"]
        return tag, None, {"peak": res["memory"]["peak_device_bytes"], "bottleneck": r["bottleneck"],
                           "t": (r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]), "trace_s": res["trace_s"]}
    except Exception:  # noqa: BLE001
        err = traceback.format_exc()
        with open(os.path.join(out_dir, tag + ".FAILED"), "w") as f:
            f.write(err)
        return tag, err, None


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
    # the train cells trace longest: first, so the workers end together
    jobs = sorted(((arch, sname, mk, args.reduced, out_dir) for arch, sname in todo for mk in meshes),
                  key=lambda j: SHAPES[j[1]].kind != "train")
    workers = min(CLI_WORKERS, os.cpu_count() or 1, len(jobs))
    if workers > 1:
        import concurrent.futures
        import multiprocessing

        # spawned workers: a fork of a process whose torch thread pools ran may hang
        with concurrent.futures.ProcessPoolExecutor(workers,
                                                    mp_context=multiprocessing.get_context("spawn")) as pool:
            done = list(pool.map(_cell_job, jobs))
    else:
        done = [_cell_job(j) for j in jobs]
    failures = 0
    for tag, err, res in sorted(done):
        if err is not None:
            failures += 1
            print(f"[FAIL] {tag}:\n{err}")
            continue
        print(f"[OK] {tag}: mem/dev={res['peak'] / 2**30:.2f}GiB bottleneck={res['bottleneck']} "
              "t=({:.2e},{:.2e},{:.2e})s".format(*res["t"]) + f" traced in {res['trace_s']:.2f}s")
    over = [tag for tag, err, res in sorted(done) if err is None and res["peak"] > CARD_BYTES]
    print(f"{len(over)} of {len(done)} cells exceed {CARD_BYTES / 1e9:.0f} GB a rank: " + ", ".join(over))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
