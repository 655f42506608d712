"""Feed-forward variants: SwiGLU / GeGLU / squared-ReLU / GELU, ported
from ``repro.models.mlp``. GELU is ``jax.nn.gelu``'s default, the tanh
approximation; both activations are ``common.silu`` / ``common.gelu``,
spelled op by op as the reference rounds them (bitwise in bfloat16).

Tensor-parallel over ``tp`` (``common.TP``) where the mesh's ``model``
axis divides ``d_ff`` (the reference's ``"mlp"`` specs): ``wg`` / ``wu``
column blocks, ``wd`` a row block, one psum of the partial outputs (with
sequence blocks, the ring all-gather in and the ring reduce-scatter out).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import Params, Specs

GATED = ("swiglu", "geglu")


def init_mlp(generator: torch.Generator, d: int, d_ff: int, kind: str, device) -> Tuple[Params, Specs]:
    def w(shape):
        return common.dense_init(shape, generator=generator, device=device)

    if kind in GATED:
        p = {"wg": w((d, d_ff)), "wu": w((d, d_ff)), "wd": w((d_ff, d))}
        s = {"wg": ("fsdp", "mlp"), "wu": ("fsdp", "mlp"), "wd": ("mlp", "fsdp")}
    else:
        p = {"wu": w((d, d_ff)), "wd": w((d_ff, d))}
        s = {"wu": ("fsdp", "mlp"), "wd": ("mlp", "fsdp")}
    return p, s


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return common.silu(h)
    if kind in ("geglu", "gelu"):
        return common.gelu(h)
    if kind == "relu2":
        r = F.relu(h)
        return r * r
    raise ValueError(kind)


def apply_mlp(p: Params, x: common.Acts, kind: str, tp: common.TP = common.SINGLE,
              d_ff: Optional[int] = None) -> common.Acts:
    """``d_ff``: the global hidden width (needed where the process holds
    its block; default the leaves' own)."""
    d_ff = p["wd"].shape[0] if d_ff is None else d_ff
    names = ("wg", "wu") if kind in GATED else ("wu",)
    split = tp.splits(d_ff)
    coords = tp.owners(split)
    hs = tp.col(x, lambda c: [tp.block(p[k], 1, c, d_ff, vary=tp.seq) for k in names], coords, split=split)
    parts = []
    for c, h in zip(coords, hs):
        a = _act(h[0], kind) * h[1] if kind in GATED else _act(h[0], kind)
        parts.append(a @ tp.block(p["wd"], 0, c, d_ff, vary=tp.seq).to(a.dtype))
    return tp.reduce(parts, "partial" if split else "whole")
