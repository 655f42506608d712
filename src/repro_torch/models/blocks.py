"""The decoder block, dense or MoE, with GQA or MLA attention, ported
from ``repro.models.blocks`` (``cross=False``; the cross-attention,
hymba and xLSTM blocks are ROADMAP A15.2b / A15.2c).

``is_global`` is a Python ``bool`` per layer (``Group.flags``), where the
reference traces a flag through ``lax.cond``: gemma2's alternation of
sliding-window and global layers. ``apply_decoder_block`` returns ``(x,
aux)``, aux the MoE router's load-balance loss (0 for a dense FFN).
Decode and prefill take one layer's cache (``KVCache`` or ``MLACache``,
views into the model's stacked cache) and write it in place.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, moe
from repro_torch.models.attention import AttnSpec, KVCache, MLACache
from repro_torch.models.common import Params

Cache = Union[KVCache, MLACache]


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


def init_decoder_block(generator: torch.Generator, cfg: ModelConfig, device, *, use_moe: bool = False):
    """With ``use_moe`` the experts are ``common.Deferred`` draws
    (``moe.init_moe``), which ``Model.init`` fills in place."""
    if cfg.mla is not None:
        pa, sa = attn.init_mla(generator, cfg, device)
    else:
        pa, sa = attn.init_attention(generator, cfg, device)
    p = {"attn": pa, "ln1": init_n(cfg, device)[0]}
    s = {"attn": sa, "ln1": init_n(cfg, device)[1]}
    if use_moe:
        p["ffn"], s["ffn"] = moe.init_moe(generator, cfg, device)
    else:
        p["ffn"], s["ffn"] = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
    p["ln2"], s["ln2"] = init_n(cfg, device)
    if cfg.post_norm:
        p["ln1p"], s["ln1p"] = init_n(cfg, device)
        p["ln2p"], s["ln2p"] = init_n(cfg, device)
    return p, s


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, use_moe: bool, mesh):
    """(x + the FFN's output, the router's aux loss or None for a dense
    FFN: decode and prefill drop it, so they make no zero for it)."""
    h2 = common.apply_norm(p["ln2"], x, cfg.norm_kind)
    if use_moe:
        f, aux = moe.apply_moe(p["ffn"], h2, cfg, mesh=mesh)
    else:
        f, aux = mlp.apply_mlp(p["ffn"], h2, cfg.mlp_kind), None
    return x + _maybe_post(p.get("ln2p"), f, cfg), aux


def apply_decoder_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    is_global: bool,
    use_moe: bool = False,
    positions=None,
    impl: str = "chunked",
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    if cfg.mla is not None:
        a = attn.apply_mla(p["attn"], h, cfg, spec, positions=positions, impl=impl)
    else:
        a = attn.apply_attention(p["attn"], h, cfg, spec, positions=positions, impl=impl)
    x, aux = _ffn(p, x + _maybe_post(p.get("ln1p"), a, cfg), cfg, use_moe, mesh)
    return x, torch.zeros((), device=x.device) if aux is None else aux


def init_block_cache(cfg: ModelConfig, b: int, s_max: int, dtype=torch.bfloat16, device=None) -> Cache:
    if cfg.mla is not None:
        return attn.init_mla_cache(b, s_max, cfg.mla, dtype, device)
    return attn.init_kv_cache(b, s_max, cfg.num_kv_heads, cfg.head_dim_, dtype, device)


def decode_decoder_block(
    p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Cache, *, is_global: bool, use_moe: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    decode = attn.decode_mla if cfg.mla is not None else attn.decode_attention
    a, new_cache = decode(p["attn"], h, cache, cfg, spec)
    return _ffn(p, x + _maybe_post(p.get("ln1p"), a, cfg), cfg, use_moe, mesh)[0], new_cache


def prefill_decoder_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Cache,
    *,
    is_global: bool,
    use_moe: bool = False,
    impl: str = "chunked",
    mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also fills the layer's cache."""
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    prefill = attn.prefill_mla if cfg.mla is not None else attn.prefill_attention
    a, new_cache = prefill(p["attn"], h, cache, cfg, spec, impl=impl)
    return _ffn(p, x + _maybe_post(p.get("ln1p"), a, cfg), cfg, use_moe, mesh)[0], new_cache
