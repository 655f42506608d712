"""Shared layer primitives: norms, RoPE, embeddings, initializers, ported
from ``repro.models.common``.

Functional style, as there: ``init_*`` returns ``(params, specs)`` where
``specs`` mirrors the param tree with tuples of *logical* sharding axis
names (``repro_torch.core.sharding`` resolves them against a mesh);
``apply_*`` are plain functions on tensors. Initializers take an
explicit ``torch.Generator`` and ``device``: they cannot reproduce
JAX's random bits, so parity with the reference comes from its weights
(``models.model.params_from_numpy``), and these are held only in their
statistics.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

Params = dict
Specs = dict


def _std(shape, scale: float) -> float:
    return scale / math.sqrt(shape[0] if len(shape) > 1 else 1)


def _unit_draw(shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return out.mul_(std)


def trunc_normal(shape, scale: float, *, generator: torch.Generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal init with fan-in scaling (MaxText default): std =
    scale / sqrt(shape[0]) (1 for a vector), truncated at +-3 std."""
    return _unit_draw(shape, _std(shape, scale), generator, device).to(dtype)


def dense_init(shape, *, generator: torch.Generator, device, scale: float = 1.0) -> torch.Tensor:
    return trunc_normal(shape, scale, generator=generator, device=device)


class Deferred(NamedTuple):
    """A ``dense_init`` draw of ``shape`` made later, one slice of the
    leading axis at a time, in float32 straight into the tensor that keeps
    it (of any float dtype): a DeepSeek-V3 MoE layer's experts are 46 GB
    in float32, so ``Model.init`` never makes them whole."""

    shape: Tuple[int, ...]
    scale: float = 1.0

    def fill(self, out: torch.Tensor, generator: torch.Generator, first: int = 0) -> torch.Tensor:
        """Draw all ``shape[0]`` slices in order and write slices ``first``
        .. ``first + len(out)`` into ``out`` (a rank's block of the
        experts: the same values as the whole draw's, whatever it keeps)."""
        std = _std(self.shape, self.scale)
        for j in range(self.shape[0]):
            draw = _unit_draw(self.shape[1:], std, generator, out.device)
            if first <= j < first + out.shape[0]:
                out[j - first].copy_(draw)
        return out

    def draw(self, generator: torch.Generator, device) -> torch.Tensor:
        return self.fill(torch.empty(self.shape, device=device), generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, device) -> Tuple[Params, Specs]:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), device=device)}, {"scale": (None,)}
    if kind == "layernorm":
        return (
            {"scale": torch.zeros((d,), device=device), "bias": torch.zeros((d,), device=device)},
            {"scale": (None,), "bias": (None,)},
        )
    raise ValueError(kind)


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """The ``(1 + scale)`` form, in float32; layernorm's variance is the
    population one (``jnp.var``)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + p["scale"]) + p["bias"]
    return out.to(x.dtype)


def init_groupnorm(heads: int, d: int, device) -> Tuple[Params, Specs]:
    """Per-head group norm (xLSTM blocks)."""
    return {"scale": torch.zeros((d,), device=device)}, {"scale": (None,)}


def apply_groupnorm(p: Params, x: torch.Tensor, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., H, dh) normalized per head."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out.reshape(out.shape[:-2] + (-1,)) * (1.0 + p["scale"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) integer.

    ``fraction`` < 1 rotates only the leading dims (nemotron partial rope).
    """
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0 or theta <= 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    # positions (..., S) -> angles (..., S, 1, half), broadcasting over heads
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (seq, d), built in
    float64 with numpy as the reference builds them."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(generator: torch.Generator, vocab: int, d: int, tie: bool, device) -> Tuple[Params, Specs]:
    p = {"table": trunc_normal((vocab, d), 1.0, generator=generator, device=device)}
    s = {"table": ("vocab", "fsdp")}
    if not tie:
        p["unembed"] = trunc_normal((d, vocab), 1.0, generator=generator, device=device)
        s["unembed"] = ("fsdp", "vocab")
    return p, s


def embed_tokens(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


def unembed(p: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    w = p["table"].T if tie else p["unembed"]
    return x @ w.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)

