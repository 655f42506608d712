"""Logical-axis sharding rules (MaxText-style), the pure half of
``repro.core.sharding``.

Model code annotates arrays with *logical* axis names (``Model.init``'s
specs); the rules below map them onto whatever mesh axes exist. Missing
mesh axes resolve to replication. A mesh here is any object with a
``.shape`` mapping of axis name to size (the reference's tests use a
shape-only ``FakeMesh``), and a partition spec is a plain tuple with one
entry per dim: ``None``, an axis name, or a tuple of axis names -- the
entries of jax's ``PartitionSpec``.

``named``, ``constrain``, ``tree_shardings`` and ``batch_sharding`` build
GSPMD objects; their counterparts come with tensor-parallel serving
(ROADMAP A15.1c). ``resolve`` already places the MoE experts
(``models.model``, ``models.moe``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

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
