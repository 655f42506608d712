"""Abstract input and decode-state specs, ported from
``repro.launch.specs``: the rules the dry run reads, as plain data.

The reference builds ``ShapeDtypeStruct`` stand-ins carrying
``NamedSharding`` s for ``jit(...).lower``. The port has no lowering: its
counterparts return shapes, dtypes and partition specs as plain tuples
(``None``, an axis name or a tuple of them per dim), resolved against
any mesh with a ``.shape`` mapping -- a ``ProcessGroupMesh``, a
``SimMesh`` or a shape-only ``launch.mesh.MeshShape``. The abstract
decode state is the port's own on the ``meta`` device (no memory).

Rules (the reference's): the batch over ``('pod', 'data')``; the KV and
latent caches additionally over ``model`` (heads, or the head dim where
the KV heads do not fill the axis); at batch 1 (``long_500k``) the batch
is replicated and with ``seq_shard`` the caches' sequence axis goes over
``data``. Every spec is sanitized: an axis that does not divide its dim
is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.sharding import Spec, sanitize_spec
from repro_torch.models.attention import cache_model_dim

#: (shape, dtype name, partition spec) of one abstract input
InputSpec = Tuple[Tuple[int, ...], str, Spec]


def _batch_axes(mesh, *, replicate_batch: bool = False):
    if replicate_batch:
        return None
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return axes if axes else None


def batch_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, InputSpec]:
    """The abstract train / prefill inputs of one architecture x shape:
    ``{name: (shape, dtype, spec)}``."""
    b, s = shape.global_batch, shape.seq_len
    ba = _batch_axes(mesh, replicate_batch=(b == 1))
    tok = sanitize_spec(mesh, (ba, None), (b, s))
    emb = sanitize_spec(mesh, (ba, None, None), (b, s, 1))
    out: Dict[str, InputSpec] = {}
    if cfg.is_encdec:
        out["enc_embeds"] = ((b, s, cfg.d_model), "bfloat16", emb)
        dec_len = max(s // cfg.decoder_ratio, 1)
        out["tokens"] = ((b, dec_len), "int32", tok)
        if shape.kind == "train":
            out["labels"] = ((b, dec_len), "int32", tok)
        return out
    if cfg.input_kind == "embeddings":
        out["embeds"] = ((b, s, cfg.d_model), "bfloat16", emb)
    else:
        out["tokens"] = ((b, s), "int32", tok)
    if shape.kind == "train":
        out["labels"] = ((b, s), "int32", tok)
        if cfg.mtp_depth > 0 and "tokens" not in out:
            out["tokens"] = ((b, s), "int32", tok)
    return out


def _leaf_spec(path: str, ndim: int, *, ba, seq_shard: bool, shape=(), tp: int = 1) -> Spec:
    """The spec of one stacked decode-state leaf (leading axis: the
    layer), by its dotted path's name."""
    seq_ax = "data" if seq_shard else None
    if path.endswith("length") and ndim == 2:  # (L, B)
        return (None, ba)
    if path.endswith("pos"):
        return ()
    if path.endswith((".k", ".v")) and ndim == 5:  # (L, B, S, KVH, D)
        # KV heads the axis does not divide (GQA): the head dim instead, as the model cuts its cache
        if shape and cache_model_dim(shape[3], shape[4], tp) == 3:
            return (None, ba, seq_ax, None, "model")
        return (None, ba, seq_ax, "model", None)
    if path.endswith("ckv") and ndim == 4:  # (L, B, S, r)
        return (None, ba, seq_ax, None)
    if path.endswith("k_rope") and ndim == 4:
        return (None, ba, seq_ax, None)
    if ".cross" in path and ndim == 5:  # (L, B, S_enc, H, D)
        return (None, ba, None, "model", None)
    if path.endswith(".h") and ndim == 4:  # Mamba state (L, B, di, N)
        return (None, ba, "model", None)
    if path.endswith(".conv") and ndim == 4:  # (L, B, W, di)
        return (None, ba, None, "model")
    if path.endswith(".c") and ndim == 5:  # mLSTM C (L, B, H, dk, dv)
        return (None, ba, "model", None, None)
    if path.endswith(".n") and ndim == 4:
        return (None, ba, "model", None)
    if path.endswith(".m") and ndim == 3:
        return (None, ba, "model")
    if ndim >= 3:  # the sLSTM's h / c / n / m (L, B, d) and anything else batched
        return (None, ba) + (None,) * (ndim - 2)
    return (None,) * ndim


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def decode_state_shardings(state, mesh, *, replicate_batch: bool, seq_shard: bool):
    """The decode state's tree (dicts and NamedTuples as in ``state``)
    with each leaf replaced by its sanitized spec: ``_leaf_spec`` of its
    path (``.group.field``, as the reference dots the path of its
    pytree)."""
    ba = _batch_axes(mesh, replicate_batch=replicate_batch)
    tp = mesh.shape.get("model", 1)

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            shape = _shape(node)
            spec = _leaf_spec("." + ".".join(path), len(shape), ba=ba, seq_shard=seq_shard, shape=shape, tp=tp)
            return sanitize_spec(mesh, spec, shape)
        mapped = {name: walk(child, path + (name,)) for name, child in kids}
        if isinstance(node, dict):
            return {k: mapped[str(k)] for k in node}
        values = [mapped[name] for name, _ in kids]
        if isinstance(node, list):
            return values
        return type(node)(*values) if hasattr(node, "_fields") else tuple(values)

    return walk(state, ())


def abstract_decode_state(model, b: int, s_max: int) -> Dict[str, Any]:
    """The whole decode state of ``model``'s config at batch ``b`` and
    ``s_max`` positions, on the ``meta`` device: shapes and dtypes, no
    memory (the reference's ``jax.eval_shape`` of
    ``model.init_decode_state``)."""
    from repro_torch.models.model import Model

    return Model(model.cfg, device="meta").init_decode_state(b, s_max)

