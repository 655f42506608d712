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
``models.model.params_from_numpy``). ``constrain`` has no counterpart:
the activations' layout is whatever the model code computes, and the
collectives that move them sit in the model code (``models.common.TP``).

Two rules differ from GSPMD's. Heads are placed whole: the reference
resolves the flattened ``(d, H*hd)`` leaves by their size, so a model
with 2 KV heads of 16 on 4 ranks splits ``wk`` into half heads, which
GSPMD survives and explicit attention cannot; here a ``"heads"`` or
``"kv_heads"`` dim takes the ``model`` axis only where the head count
(``units``) divides it. And only the ``model`` axis places weights in
this slice: a ``data`` axis (``"fsdp"``) replicates them (FSDP comes
with the placed training state, ROADMAP A15.3c).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

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
    ``spec``: ``"model"`` on the dim :func:`resolve` gives the ``model``
    axis, where the dim's whole units -- ``units[name]`` (the head count
    of a ``"heads"`` / ``"kv_heads"`` dim), else its size over ``parts``
    (a dim that packs equal parts side by side, as Mamba's ``win`` packs
    ``[x | z]``) -- divide the axis; None everywhere else (replicated). No
    mesh, or a ``model`` axis of one rank, places nothing."""
    p = mesh.shape.get("model", 1) if mesh is not None else 1
    if p == 1:
        return (None,) * len(spec)
    out = []
    for name, entry, n in zip(spec, resolve(mesh, *spec, shape=shape), shape):
        if entry != "model" and not (isinstance(entry, tuple) and "model" in entry):
            out.append(None)
            continue
        if name in HEAD_NAMES and (units is None or name not in units):
            raise ValueError(f"placing a {name!r} dim needs its head count (units={{{name!r}: ...}}): heads are "
                             "placed whole")
        whole = units[name] if units is not None and name in units else n // parts
        out.append("model" if whole % p == 0 else None)
    return tuple(out)


def block(mesh, spec: Sequence[Axis], shape: Sequence[int],
          units: Optional[Mapping[str, int]] = None, parts: int = 1) -> Optional[Tuple[int, int, int]]:
    """(dim, first, count): the block of a leaf that the caller keeps on a
    mesh where it holds its own block (a ``ProcessGroupMesh``): its
    ``model`` coordinate's slice of the dim :func:`placement` puts on
    that axis -- of each part, where the dim packs ``parts`` (the caller
    keeps the parts' slices side by side: ``first`` and ``count`` are
    within a part). None where it keeps the whole leaf: no mesh, a
    ``SimMesh`` (every rank's block is a view of the whole leaf), or a
    leaf placed nowhere."""
    if mesh is None or not mesh.caller_holds_block:
        return None
    where = placement(mesh, spec, shape, units, parts)
    if "model" not in where:
        return None
    dim = where.index("model")
    n = shape[dim] // parts // mesh.shape["model"]
    return dim, mesh.axis_index("model") * n, n


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
