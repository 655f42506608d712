"""The dense decoder block, ported from ``repro.models.blocks``
(``use_moe=False``, ``cross=False``; the MoE, cross-attention, hymba and
xLSTM blocks are ROADMAP A15.2).

``is_global`` is a Python ``bool`` per layer (``Group.flags``), where the
reference traces a flag through ``lax.cond``: gemma2's alternation of
sliding-window and global layers. Decode and prefill take one layer's
``KVCache`` (views into the model's stacked cache) and write it in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.attention import AttnSpec, KVCache
from repro_torch.models.common import Params


def _attn_spec(cfg: ModelConfig, *, is_global: bool, causal: bool = True) -> AttnSpec:
    window = 0 if is_global else cfg.window_size
    return AttnSpec(
        causal=causal, window=window, softcap=cfg.attn_logit_softcap, prefix=cfg.meta_tokens
    )


def _maybe_post(p, h, cfg):
    """gemma2's sandwich norm on a sublayer's output."""
    return common.apply_norm(p, h, cfg.norm_kind) if cfg.post_norm else h


def init_n(cfg, device):
    return common.init_norm(cfg.d_model, cfg.norm_kind, device)


def init_decoder_block(generator: torch.Generator, cfg: ModelConfig, device):
    pa, sa = attn.init_attention(generator, cfg, device)
    p = {"attn": pa, "ln1": init_n(cfg, device)[0]}
    s = {"attn": sa, "ln1": init_n(cfg, device)[1]}
    p["ffn"], s["ffn"] = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
    p["ln2"], s["ln2"] = init_n(cfg, device)
    if cfg.post_norm:
        p["ln1p"], s["ln1p"] = init_n(cfg, device)
        p["ln2p"], s["ln2p"] = init_n(cfg, device)
    return p, s


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h2 = common.apply_norm(p["ln2"], x, cfg.norm_kind)
    return x + _maybe_post(p.get("ln2p"), mlp.apply_mlp(p["ffn"], h2, cfg.mlp_kind), cfg)


def apply_decoder_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    is_global: bool,
    positions=None,
    impl: str = "chunked",
) -> torch.Tensor:
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    a = attn.apply_attention(p["attn"], h, cfg, spec, positions=positions, impl=impl)
    return _ffn(p, x + _maybe_post(p.get("ln1p"), a, cfg), cfg)


def init_block_cache(cfg: ModelConfig, b: int, s_max: int, dtype=torch.bfloat16, device=None) -> KVCache:
    return attn.init_kv_cache(b, s_max, cfg.num_kv_heads, cfg.head_dim_, dtype, device)


def decode_decoder_block(
    p: Params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache, *, is_global: bool
) -> Tuple[torch.Tensor, KVCache]:
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    a, new_cache = attn.decode_attention(p["attn"], h, cache, cfg, _attn_spec(cfg, is_global=is_global))
    return _ffn(p, x + _maybe_post(p.get("ln1p"), a, cfg), cfg), new_cache


def prefill_decoder_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: KVCache,
    *,
    is_global: bool,
    impl: str = "chunked",
) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence forward that also fills the layer's cache."""
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    a, new_cache = attn.prefill_attention(p["attn"], h, cache, cfg, spec, impl=impl)
    return _ffn(p, x + _maybe_post(p.get("ln1p"), a, cfg), cfg), new_cache
