"""Attention, the GQA half of ``repro.models.attention``: masks
(causal, sliding window, always-visible prefix), logit softcap, the naive
oracle and the chunked online-softmax scan, the projection layer and
cache-based prefill / decode.

The chunked scan never materializes (Sq, Skv) scores: it walks KV blocks
in a Python loop carrying the online-softmax (m, l, acc) state, as the
reference's ``lax.scan`` does. Numerics follow the reference's:

- ``q`` is scaled by 1/sqrt(d) in its own dtype, then scores and the PV
  product are float32 from the operands upcast (``preferred_element_type
  =float32`` there; products of bfloat16 values are exact in float32);
- ``p`` is rounded to ``v``'s dtype before the PV product.

MLA (DeepSeek-V3's multi-head latent attention): prefill expands the
latent to per-head K/V and attends as MHA; decode scores against the
*latent* cache through the absorbed up-projection, as the reference's.

Not ported yet: the flash backward (A15.3) and ``flash_decode_combine``
(A15.1c).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import common
from repro_torch.models.common import Params, Specs

NEG_INF = -1e30


class AttnSpec(NamedTuple):
    """Static per-call attention behaviour."""

    causal: bool = True
    window: int = 0  # 0 = full
    softcap: float = 0.0
    prefix: int = 0  # keys with idx < prefix always visible (meta tokens)


# ---------------------------------------------------------------------------
# Core softmax attention (naive + chunked)
# ---------------------------------------------------------------------------


def _mask(q_idx: torch.Tensor, k_idx: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """(..., Sq, Skv) boolean visibility. q_idx: (Sq,) or (B, Sq) for
    per-row decode positions; k_idx: (Skv,)."""
    if spec.causal:
        ok = k_idx <= q_idx[..., None]
    else:
        ok = torch.ones(q_idx.shape + k_idx.shape, dtype=torch.bool, device=k_idx.device)
    if spec.window > 0:
        inwin = k_idx > q_idx[..., None] - spec.window
        if spec.prefix > 0:
            inwin = inwin | (k_idx < spec.prefix)
        ok = ok & inwin
    return ok


def _q_idx(q_offset, sq: int, device) -> torch.Tensor:
    """Query positions: (Sq,) for an int or 0-d offset, (B, Sq) for a
    per-row (B,) offset."""
    ar = torch.arange(sq, device=device)
    if isinstance(q_offset, torch.Tensor):
        return q_offset.to(device)[..., None] + ar if q_offset.ndim else q_offset.to(device) + ar
    return q_offset + ar


def attention_naive(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, Dv)
    spec: AttnSpec,
    *,
    q_offset: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s / math.sqrt(d)
    s = common.softcap(s, spec.softcap)
    q_idx = _q_idx(q_offset, sq, q.device)
    k_idx = torch.arange(k.shape[1], device=q.device)
    s = torch.where(_mask(q_idx, k_idx, spec), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhe->bqhge", p, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: AttnSpec,
    *,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_chunk: int = 512,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash-style online softmax over KV chunks (O(Sq) memory).

    ``kv_valid_len``: number of valid cache entries, () or (B,) (decode
    with a preallocated cache). The last chunk may be short: the
    reference pads it with masked keys, which add exactly nothing.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dv = v.shape[-1]
    kv_chunk = min(kv_chunk, skv)
    dev = q.device

    qg = (q / math.sqrt(d)).reshape(b, sq, kvh, g, d).float()  # scaled in q's dtype, then f32
    q_idx = _q_idx(q_offset, sq, dev)
    valid = None
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, device=dev)
        valid = valid[..., None, None] if valid.ndim else valid

    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=dev)
    for start in range(0, skv, kv_chunk):
        kb = k[:, start:start + kv_chunk]
        vb = v[:, start:start + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float())
        s = common.softcap(s, spec.softcap)
        k_idx = torch.arange(start, start + kb.shape[1], device=dev)
        ok = _mask(q_idx, k_idx, spec)  # (Sq, K) or (B, Sq, K)
        if valid is not None:
            ok = ok & (k_idx < valid)
        ok = ok[None, None, None] if ok.ndim == 2 else ok[:, None, None]
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhe->bhgqe", p.to(vb.dtype).float(), vb.float()
        )
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def flash_attention_train(q, k, v, spec: AttnSpec, *, kv_chunk: int = 512) -> torch.Tensor:
    """The forward pass of the reference's flash attention (q_offset=0):
    the same online-softmax scan. Its custom backward is ROADMAP A15.3."""
    return attention_chunked(q, k, v, spec, kv_chunk=kv_chunk)


def attention(
    q, k, v, spec: AttnSpec, *, impl: str = "chunked", q_offset=0, kv_chunk: int = 512,
    kv_valid_len=None,
) -> torch.Tensor:
    if impl == "naive":
        if kv_valid_len is not None:
            raise ValueError("the naive attention takes no kv_valid_len")
        return attention_naive(q, k, v, spec, q_offset=q_offset)
    if kv_valid_len is None and isinstance(q_offset, int) and q_offset == 0:
        return flash_attention_train(q, k, v, spec, kv_chunk=kv_chunk)
    return attention_chunked(
        q, k, v, spec, q_offset=q_offset, kv_chunk=kv_chunk, kv_valid_len=kv_valid_len
    )


# ---------------------------------------------------------------------------
# GQA projection layer
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig, device) -> Tuple[Params, Specs]:
    """Weights stored FLAT -- (d, H*hd) not (d, H, hd) -- so a TP axis
    shards the flattened head dim, which divides even when the head
    count doesn't (qwen 40H, hymba 25H, phi3-medium 10 kv heads)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def w(shape):
        return common.dense_init(shape, generator=generator, device=device)

    p = {"wq": w((d, h * hd)), "wk": w((d, kvh * hd)), "wv": w((d, kvh * hd)), "wo": w((h * hd, d))}
    s = {
        "wq": ("fsdp", "heads"),
        "wk": ("fsdp", "kv_heads"),
        "wv": ("fsdp", "kv_heads"),
        "wo": ("heads", "fsdp"),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), device=device)
        p["bk"] = torch.zeros((kvh * hd,), device=device)
        p["bv"] = torch.zeros((kvh * hd,), device=device)
        s["bq"] = ("heads",)
        s["bk"] = ("kv_heads",)
        s["bv"] = ("kv_heads",)
    return p, s


def qkv_proj(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    dt = x.dtype
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.rope_theta > 0:
        q = common.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = common.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def out_proj(p: Params, attn_out: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = attn_out.shape
    return attn_out.reshape(b, s, h * hd) @ p["wo"].to(attn_out.dtype)


def apply_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: AttnSpec,
    *,
    positions: Optional[torch.Tensor] = None,
    impl: str = "chunked",
) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = qkv_proj(p, x, cfg, positions)
    o = attention(q, k, v, spec, impl=impl, kv_chunk=cfg.attn_kv_chunk)
    return out_proj(p, o)


# --- decode with cache -------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KVH, D)
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32 -- valid entries per row (ragged slots)


def init_kv_cache(b: int, s_max: int, kvh: int, hd: int, dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((b, s_max, kvh, hd), dtype=dtype, device=device),
        v=torch.zeros((b, s_max, kvh, hd), dtype=dtype, device=device),
        length=torch.zeros((b,), dtype=torch.int32, device=device),
    )


def _write_rows(pos: torch.Tensor, *pairs) -> None:
    """``cache[row, pos[row]] = new[row]`` in place for each (cache, new)
    pair, for the rows whose position lies inside the cache; a row at or
    past the end (an idle serving slot keeps stepping) is not written, as
    JAX drops an out-of-bounds ``.at[].set`` (torch would raise)."""
    first = pairs[0][0]
    rows = torch.arange(first.shape[0], device=first.device)
    at = pos.clamp(max=first.shape[1] - 1).long()
    inside = pos < first.shape[1]
    for cache, new in pairs:
        keep = inside.reshape((-1,) + (1,) * (new.dim() - 1))
        cache[rows, at] = torch.where(keep, new.to(cache.dtype), cache[rows, at])


def decode_attention(
    p: Params,
    x: torch.Tensor,  # (B, 1, d)
    cache: KVCache,
    cfg: ModelConfig,
    spec: AttnSpec,
    *,
    kv_chunk: int = 512,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: write K/V at each row's cache.length, attend over
    the cache. Rows may be at different positions (serving slots).

    The write goes into ``cache.k`` / ``cache.v`` in place (``_write_rows``);
    the returned cache shares them, with ``length + 1``.
    """
    pos = cache.length  # (B,)
    q, k, v = qkv_proj(p, x, cfg, positions=pos[:, None])
    _write_rows(pos, (cache.k, k[:, 0]), (cache.v, v[:, 0]))
    o = attention_chunked(
        q, cache.k, cache.v, spec, q_offset=pos, kv_chunk=kv_chunk, kv_valid_len=pos + 1
    )
    return out_proj(p, o), KVCache(cache.k, cache.v, pos + 1)


def prefill_attention(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cache: KVCache,
    cfg: ModelConfig,
    spec: AttnSpec,
    *,
    impl: str = "chunked",
) -> Tuple[torch.Tensor, KVCache]:
    """Causal full-sequence pass that also writes cache[0:S] in place.
    It attends the fresh K/V, not the cache's (bfloat16) copy of them."""
    b, s, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg, positions=torch.arange(s, device=x.device))
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    o = attention(q, k, v, spec, impl=impl, kv_chunk=cfg.attn_kv_chunk)
    length = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return out_proj(p, o), KVCache(cache.k, cache.v, length)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ModelConfig, device) -> Tuple[Params, Specs]:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim

    def w(shape):
        return common.dense_init(shape, generator=generator, device=device)

    p = {
        "wdq": w((d, m.q_lora_rank)),
        "wuq": w((m.q_lora_rank, h * qd)),
        "wdkv": w((d, m.kv_lora_rank + m.rope_head_dim)),
        "wukv": w((m.kv_lora_rank, h * (m.nope_head_dim + m.v_head_dim))),
        "wo": w((h * m.v_head_dim, d)),
    }
    p["q_norm"], _ = common.init_norm(m.q_lora_rank, "rmsnorm", device)
    p["kv_norm"], _ = common.init_norm(m.kv_lora_rank, "rmsnorm", device)
    s = {
        "wdq": ("fsdp", None),
        "wuq": (None, "heads"),
        "wdkv": ("fsdp", None),
        "wukv": (None, "heads"),
        "wo": ("heads", "fsdp"),
        "q_norm": {"scale": (None,)},
        "kv_norm": {"scale": (None,)},
    }
    return p, s


def _mla_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated, ckv (B,S,r)
    normalized, k_rope (B,S,1,rope) rotated)."""
    m: MLAConfig = cfg.mla
    dt = x.dtype
    b, s, _ = x.shape
    cq = common.apply_norm(p["q_norm"], x @ p["wdq"].to(dt), "rmsnorm")
    q = (cq @ p["wuq"].to(dt)).reshape(b, s, cfg.num_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = common.rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p["wdkv"].to(dt)
    ckv = common.apply_norm(p["kv_norm"], ckv_full[..., :m.kv_lora_rank], "rmsnorm")
    k_rope = common.rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def _mla_expanded(p: Params, x: torch.Tensor, cfg: ModelConfig, spec: AttnSpec, positions, impl: str):
    """Attention with the latent expanded to per-head K/V (MHA): returns
    (output (B, S, d), ckv, k_rope) -- the fresh latent, for a cache."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, positions)
    kv = (ckv @ p["wukv"].to(x.dtype)).reshape(b, s, h, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(q, k, v, spec, impl=impl).reshape(b, s, h * m.v_head_dim)
    return o @ p["wo"].to(x.dtype), ckv, k_rope


def apply_mla(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: AttnSpec,
    *,
    positions: Optional[torch.Tensor] = None,
    impl: str = "chunked",
) -> torch.Tensor:
    """Training/prefill MLA: expand the latent to per-head K/V, run MHA."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _mla_expanded(p, x, cfg, spec, positions, impl)[0]


class MLACache(NamedTuple):
    ckv: torch.Tensor  # (B, S_max, kv_lora_rank)
    k_rope: torch.Tensor  # (B, S_max, rope_head_dim)
    length: torch.Tensor  # (B,) int32


def init_mla_cache(b: int, s_max: int, m: MLAConfig, dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        ckv=torch.zeros((b, s_max, m.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((b, s_max, m.rope_head_dim), dtype=dtype, device=device),
        length=torch.zeros((b,), dtype=torch.int32, device=device),
    )


def prefill_mla(
    p: Params, x: torch.Tensor, cache: MLACache, cfg: ModelConfig, spec: AttnSpec, *, impl: str = "chunked",
) -> Tuple[torch.Tensor, MLACache]:
    """Full-sequence MLA pass that writes the latent cache[0:S] in place.
    It attends the fresh latent, not the cache's (bfloat16) copy of it."""
    b, s, _ = x.shape
    out, ckv, k_rope = _mla_expanded(p, x, cfg, spec, torch.arange(s, device=x.device), impl)
    cache.ckv[:, :s] = ckv.to(cache.ckv.dtype)
    cache.k_rope[:, :s] = k_rope[:, :, 0, :].to(cache.k_rope.dtype)
    return out, MLACache(cache.ckv, cache.k_rope, torch.full((b,), s, dtype=torch.int32, device=x.device))


def decode_mla(
    p: Params, x: torch.Tensor, cache: MLACache, cfg: ModelConfig, spec: AttnSpec
) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-matrix MLA decode: scores against the *latent* cache.

    score_h = (W_uk[h]^T q_nope[h]) . ckv + q_rope[h] . k_rope, so the
    cache stays rank-(kv_lora + rope_d) per token. The write goes into
    the cache in place (a row past its end is not written, as in
    :func:`decode_attention`); every row attends positions <= its own.
    ``spec`` is unused, as in the reference (no window, no softcap).
    """
    m: MLAConfig = cfg.mla
    h = cfg.num_heads
    pos = cache.length  # (B,)
    b, dt = x.shape[0], x.dtype
    q_nope, q_rope, ckv_t, k_rope_t = _mla_qkv(p, x, cfg, positions=pos[:, None])
    _write_rows(pos, (cache.ckv, ckv_t[:, 0]), (cache.k_rope, k_rope_t[:, 0, 0, :]))
    ckv_c, kr_c = cache.ckv.to(dt), cache.k_rope.to(dt)

    wukv = p["wukv"].reshape(m.kv_lora_rank, h, m.nope_head_dim + m.v_head_dim)
    wuk = wukv[..., :m.nope_head_dim].to(dt)  # (r, h, nope)
    wuv = wukv[..., m.nope_head_dim:].to(dt)  # (r, h, v)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, wuk)  # the absorbed query
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, ckv_c)
    s_rope = torch.einsum("bshe,bte->bhst", q_rope, kr_c)
    scores = (s_lat + s_rope).float() / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    t_idx = torch.arange(scores.shape[-1], device=x.device)
    scores = torch.where((t_idx <= pos[:, None])[:, None, None, :], scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    lat_sum = torch.einsum("bhst,btr->bshr", pr.to(dt), ckv_c)
    o = torch.einsum("bshr,rhe->bshe", lat_sum, wuv).reshape(b, -1, h * m.v_head_dim)
    return o @ p["wo"].to(dt), MLACache(cache.ckv, cache.k_rope, pos + 1)
