"""Logical-axis sharding rules (MaxText-style), the pure half of
``repro.core.sharding``.

Model code annotates arrays with *logical* axis names (``Model.init``'s
specs); the rules below map them onto whatever mesh axes exist. Missing
mesh axes resolve to replication. A mesh here is any object with a
``.shape`` mapping of axis name to size (the reference's tests use a
shape-only ``FakeMesh``), and a partition spec is a plain tuple with one
entry per dim: ``None``, an axis name, or a tuple of axis names -- the
entries of jax's ``PartitionSpec``.

The reference's other half (``named``, ``constrain``, ``tree_shardings``,
``batch_sharding``) builds GSPMD shardings and constraints; the compiler
then moves the data. The port places explicitly instead:
:func:`placement` resolves a leaf's spec for the mesh and :func:`block`
names the block a ``ProcessGroupMesh`` rank keeps (``Model.init``,
``models.model.params_from_numpy``, ``train.step.state_placement``);
:func:`batch_placement` is ``batch_sharding``'s spec, the rows a rank
of the ``('pod', 'data')`` axes trains on. ``constrain`` has no
counterpart: the activations' layout is whatever the model code
computes, and the collectives that move them sit in the model code
(``models.common.TP`` over ``model``, the FSDP gathers of
``models.model`` over ``('pod', 'data')``).

The weights are FSDP x TP, as the reference's: an ``"fsdp"`` dim over
the ``('pod', 'data')`` axes that divide it (a rank keeps its block and
gathers the layer's whole weight just before the layer runs), a
``"heads"`` / ``"mlp"`` / ``"vocab"`` / ``"experts"`` dim over ``model``.
A tuple of axes on one dim is laid row-major, ``pod`` before ``data``,
as a jax ``NamedSharding`` lays it, so a rank's block is the
reference's shard on the device of the same mesh coordinates. One rule
differs from GSPMD's: heads are placed whole. The reference resolves
the flattened ``(d, H*hd)`` leaves by their size, so a model with 2 KV
heads of 16 on 4 ranks splits ``wk`` into half heads, which GSPMD
survives and explicit attention cannot; here a ``"heads"`` or
``"kv_heads"`` dim takes the ``model`` axis only where the head count
(``units``) divides it.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axis = Union[str, None]
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]

# logical name -> tuple of preferred mesh axes (first existing ones kept)
DEFAULT_RULES: dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),  # weight sharding along d_model/embed dim
    "tp": ("model",),  # heads / d_ff / experts / vocab
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "expert_cap": ("model",),  # fallback when expert count < TP width
    "mlp": ("model",),
    "seq": (),  # sequence kept unsharded by default
    "seq_shard": ("data",),  # explicit sequence parallelism (long-context)
    "seq_act": ("model",),  # Megatron-style SP: saved residual stream seq dim
    "embed": (),  # activation d_model dim: replicated
    "fft_rows": ("model",),  # FFT pencil decomposition
}


def _entry(axes) -> Union[str, Tuple[str, ...], None]:
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def resolve(mesh, *logical: Axis, shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axis names to a partition spec valid for ``mesh``.

    With ``shape`` given, the resolution is *shape-aware*: a mesh axis is
    only claimed by a dim it evenly divides, and unclaimed axes remain
    available for later dims (what routes the TP axis to d_ff when an
    arch's expert/head count doesn't divide it).
    """
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        axes = [a for a in DEFAULT_RULES.get(name, ()) if a in mesh.shape and a not in used]
        if shape is not None:
            # greedily keep the longest prefix whose product divides the dim
            kept, prod = [], 1
            for a in axes:
                if shape[i] % (prod * mesh.shape[a]) == 0:
                    kept.append(a)
                    prod *= mesh.shape[a]
            axes = kept
        used.update(axes)
        out.append(_entry(axes))
    return tuple(out)


#: logical names whose units are heads: placed whole (see the module docstring)
HEAD_NAMES = ("heads", "kv_heads")


def placement(mesh, spec: Sequence[Axis], shape: Sequence[int],
              units: Optional[Mapping[str, int]] = None, parts: int = 1) -> Spec:
    """The port's placement of a leaf of ``shape`` whose logical spec is
    ``spec``, one entry a dim: ``"model"`` on the dim :func:`resolve`
    gives the ``model`` axis, where the dim's whole units --
    ``units[name]`` (the head count of a ``"heads"`` / ``"kv_heads"``
    dim), else its size over ``parts`` (a dim that packs equal parts side
    by side, as Mamba's ``win`` packs ``[x | z]``) -- divide the axis; the
    ``('pod', 'data')`` axes :func:`resolve` gives a dim (an ``"fsdp"``
    dim: the axes of more than one rank that divide it, one name or a
    tuple); None everywhere else (replicated). No mesh, or axes of one
    rank, place nothing."""
    if mesh is None:
        return (None,) * len(spec)
    p = mesh.shape.get("model", 1)
    out = []
    for name, entry, n in zip(spec, resolve(mesh, *spec, shape=shape), shape):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        if "model" in axes and p > 1:
            if name in HEAD_NAMES and (units is None or name not in units):
                raise ValueError(f"placing a {name!r} dim needs its head count (units={{{name!r}: ...}}): heads are "
                                 "placed whole")
            whole = units[name] if units is not None and name in units else n // parts
            out.append("model" if whole % p == 0 else None)
            continue
        batch = tuple(a for a in axes if a in DEFAULT_RULES["batch"] and mesh.shape[a] > 1)
        out.append(_entry(batch))
    return tuple(out)


def placed_axes(where: Spec) -> Tuple[str, ...]:
    """The mesh axes a :func:`placement` cuts the leaf over, in the order
    of its dims."""
    out: Tuple[str, ...] = ()
    for entry in where:
        if entry is not None:
            out += (entry,) if isinstance(entry, str) else tuple(entry)
    return out


#: one cut of a leaf a rank keeps: ``(dim, first, count, parts)`` -- along
#: ``dim``, ``count`` entries from ``first`` of each of its ``parts`` equal
#: parts, side by side (parts > 1 only on a ``model`` dim that packs them)
Cut = Tuple[int, int, int, int]


def block(mesh, spec: Sequence[Axis], shape: Sequence[int],
          units: Optional[Mapping[str, int]] = None, parts: int = 1) -> Optional[List[Cut]]:
    """One :data:`Cut` for each dim :func:`placement` cuts: the block of a
    leaf that the caller keeps on a mesh where it holds its own block (a
    ``ProcessGroupMesh``), in dim order -- along a ``model`` dim its
    ``model`` coordinate's slice of each of the dim's ``parts`` (the
    caller keeps the parts' slices side by side), along an ``"fsdp"`` dim
    its row-major position on the dim's ``('pod', 'data')`` axes. None
    where it keeps the whole leaf: no mesh, a ``SimMesh`` (every rank's
    block is a view of the whole leaf), or a leaf placed nowhere."""
    if mesh is None or not mesh.caller_holds_block:
        return None
    out = []
    for dim, entry in enumerate(placement(mesh, spec, shape, units, parts)):
        if entry is None:
            continue
        per = parts if entry == "model" else 1
        n = shape[dim] // per // mesh.axis_size(entry)
        out.append((dim, mesh.axis_index(entry) * n, n, per))
    return out or None


def cut_indices(n: int, cut: Cut) -> np.ndarray:
    """The global indices along a dim of ``n`` entries that ``cut`` keeps,
    in the block's order."""
    _, first, count, parts = cut
    width = n // parts
    return np.concatenate([np.arange(j * width + first, j * width + first + count) for j in range(parts)])


def block_indices(shape: Sequence[int], cuts: Optional[Sequence[Cut]]) -> List[np.ndarray]:
    """For every dim of a leaf of global ``shape``, the global indices its
    block under ``cuts`` holds (every index of an uncut dim)."""
    out = [np.arange(n) for n in shape]
    for cut in cuts or ():
        out[cut[0]] = cut_indices(shape[cut[0]], cut)
    return out


def take(a, cuts: Optional[Sequence[Cut]]):
    """A tensor's or numpy array's block under ``cuts`` (:func:`block`):
    a view where each cut keeps one run of indices, else a copy."""
    for cut in cuts or ():
        dim, idx = cut[0], cut_indices(a.shape[cut[0]], cut)
        if cut[3] == 1:
            a = a[(slice(None),) * dim + (slice(int(idx[0]), int(idx[0]) + len(idx)),)]
        elif isinstance(a, np.ndarray):
            a = np.take(a, idx, axis=dim)
        else:
            a = a.index_select(dim, torch.from_numpy(idx).to(a.device))
    return a


def batch_placement(mesh, ndim: int) -> Spec:
    """``batch_sharding``'s spec for an ``ndim`` batch input: its leading
    (row) dim over the mesh's ``('pod', 'data')`` axes, row-major -- the
    rows a rank trains on."""
    return resolve(mesh, *(["batch"] + [None] * (ndim - 1)))


def sanitize_spec(mesh, spec: Sequence, shape: Sequence[int]) -> Spec:
    """Drop mesh axes from a partition spec that don't divide the dim
    (required for input shardings; constraints tolerate padding)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        kept, prod = [], 1
        for a in entry if isinstance(entry, tuple) else (entry,):
            if a in mesh.shape and shape[i] % (prod * mesh.shape[a]) == 0:
                kept.append(a)
                prod *= mesh.shape[a]
        out.append(_entry(kept))
    return tuple(out)


def fft_axis(mesh) -> str:
    """Mesh axis the FFT pencil decomposition shards over."""
    for a in DEFAULT_RULES["fft_rows"]:
        if a in mesh.shape:
            return a
    return list(mesh.shape)[-1]
