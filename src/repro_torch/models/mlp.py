"""Feed-forward variants: SwiGLU / GeGLU / squared-ReLU / GELU, ported
from ``repro.models.mlp``. GELU is ``jax.nn.gelu``'s default, the tanh
approximation."""

from __future__ import annotations

from typing import Tuple

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
        return F.silu(h)
    if kind in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        r = F.relu(h)
        return r * r
    raise ValueError(kind)


def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind in GATED:
        h = _act(x @ p["wg"].to(dt), kind) * (x @ p["wu"].to(dt))
    else:
        h = _act(x @ p["wu"].to(dt), kind)
    return h @ p["wd"].to(dt)
