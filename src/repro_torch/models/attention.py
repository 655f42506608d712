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

Tensor parallelism (``tp``, a ``common.TP`` over the mesh's ``model``
axis; the reference's GSPMD constraints, ``attention.py:29-83``), by
whole heads (``core.sharding.placement``):

- **heads partition**: ``wq`` / ``bq`` column blocks of H/P heads, ``wo``
  a row block, one psum of the partial outputs. ``wk`` / ``wv`` / ``bk``
  / ``bv`` and the KV cache are split by KV heads where P divides their
  count; elsewhere they stay whole on every rank, and each rank reads the
  KV heads its Q heads read (GQA group ``h // (H / KVH)``).
- **context partition** (:func:`use_context_parallel`: ``attn_partition``
  "context", or "auto" where P does not divide the heads), for the
  full-sequence passes: Q sequence-sharded (an all-to-all from the head
  blocks, or each rank's rows of the whole Q), K / V whole (an all-gather
  of the KV head blocks), every head on the rank's S/P queries, then back
  to the row-parallel ``wo`` (an all-to-all) or, where the heads stay
  whole, ``wo`` on the rank's rows and an all-gather. Where P does not
  divide S it falls back to the heads partition if P divides the heads,
  else every rank computes every head (the reference pads; the outputs
  are the same). Decode (no constraint in the reference) keeps the cache
  whole under the context partition; each rank attends for its Q heads,
  or for every head where the heads stay whole.
- **MLA**: ``wdq`` / ``wdkv`` and the latent cache whole on every rank,
  ``wuq`` / ``wukv`` column blocks by head (the absorbed decode absorbs
  the rank's heads), ``wo`` a row block, one psum (the reference
  constrains MLA to the heads partition).

:func:`flash_decode_combine` merges partial online softmaxes over a
sequence-sharded KV (``pmax`` then two ``psum`` s); no serving or
training path calls it, in the reference or here, and over a process
group it has no gradient (``mesh.pmax`` raises under autograd).

Training over a ``ProcessGroupMesh``: where the products differ by rank
(split heads, sequence blocks, the context partition's rows), a tensor
the same on every rank enters them through ``TP.vary`` -- the input of
a split projection, a whole K / V weight or ``wo``, the context
partition's whole Q / K / V, MLA's latent -- so its gradient is summed
over the ranks (``common.TP``).

:func:`flash_attention_train` (every full-sequence pass with ``impl="chunked"``
and ``q_offset=0``) carries the reference's custom backward as a
``torch.autograd.Function``: its forward is the serving scan, bit for bit.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import common
from repro_torch.models.common import TP, Acts, Params, Specs

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


def _online_softmax(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec, q_idx: torch.Tensor,
                    valid: Optional[torch.Tensor], kv_chunk: int):
    """The online-softmax scan over KV chunks: (m, l, acc) of the float32
    queries ``qg`` (B, Sq, KVH, G, D), already scaled, against ``k`` /
    ``v`` in their own dtype; ``valid`` the valid cache entries (None, or
    broadcastable against the (Sq, K) / (B, Sq, K) mask)."""
    b, sq, kvh, g, _ = qg.shape
    skv, dv = k.shape[1], v.shape[-1]
    dev = qg.device
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
    return m, l, acc


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
    kvh = k.shape[2]
    g = h // kvh
    dev = q.device
    qg = (q / math.sqrt(d)).reshape(b, sq, kvh, g, d).float()  # scaled in q's dtype, then f32
    valid = None
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, device=dev)
        valid = valid[..., None, None] if valid.ndim else valid
    _, l, acc = _online_softmax(qg, k, v, spec, _q_idx(q_offset, sq, dev), valid, min(kv_chunk, k.shape[1]))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention with a custom backward (train path: q_offset=0, no
# valid_len), the reference's ``_make_flash`` custom VJP
#
# The forward keeps only (q, k, v, out, lse); the backward recomputes each
# KV chunk's probabilities from the final logsumexp:
#     p = exp(s - L);  dv += p^T dO;  dp = dO v^T
#     ds = p * (dp - rowsum(dO*O)) [* dsoftcap];  dq += ds k;  dk += ds^T q
# ---------------------------------------------------------------------------


def _flash_fwd(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec, kv_chunk: int):
    """(out (B, KVH, G, Sq, Dv) float32, lse (B, KVH, G, Sq)) of the scaled
    queries ``qg`` (B, Sq, KVH, G, D) in q's dtype: the serving scan."""
    m, l, acc = _online_softmax(qg.float(), k, v, spec, torch.arange(qg.shape[1], device=qg.device), None,
                                kv_chunk)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


def _flash_bwd(qg, k, v, out, lse, dout, spec: AttnSpec, kv_chunk: int):
    """(dqg, dk, dv) in the primals' dtypes. ``p``, ``dout`` and ``ds``
    are rounded to the K / V dtype before each product, as the reference
    rounds them; the products themselves are float32 (of upcast
    operands), ``dq`` accumulates in float32."""
    sq = qg.shape[1]
    q_idx = torch.arange(sq, device=qg.device)
    qf = qg.float()
    dout = dout.float()
    dmat = torch.sum(dout * out, dim=-1)  # (B,KVH,G,Sq)
    dout_v = dout.to(v.dtype).float()
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
    dks, dvs = [], []
    for start in range(0, k.shape[1], kv_chunk):
        kb = k[:, start:start + kv_chunk].float()
        vb = v[:, start:start + kv_chunk]
        s_raw = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
        if spec.softcap > 0:
            t = torch.tanh(s_raw / spec.softcap)
            s = spec.softcap * t
            dcap = 1.0 - t * t
        else:
            s, dcap = s_raw, None
        k_idx = torch.arange(start, start + kb.shape[1], device=qg.device)
        s = torch.where(_mask(q_idx, k_idx, spec)[None, None, None], s, NEG_INF)
        p = torch.exp(s - lse[..., None])  # (B,KVH,G,Sq,K)
        dvs.append(torch.einsum("bhgqk,bhgqe->bkhe", p.to(vb.dtype).float(), dout_v))
        dp = torch.einsum("bhgqe,bkhe->bhgqk", dout, vb.float())
        ds = p * (dp - dmat[..., None])
        if dcap is not None:
            ds = ds * dcap
        dsv = ds.to(k.dtype).float()
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", dsv, kb)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", dsv, qf))
    return dq.to(qg.dtype), torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype)


class _Flash(torch.autograd.Function):
    """The reference's ``flash`` custom VJP on (qg, K, V) -> out float32
    (B, KVH, G, Sq, Dv)."""

    @staticmethod
    def forward(ctx, qg, k, v, spec: AttnSpec, kv_chunk: int):
        out, lse = _flash_fwd(qg, k, v, spec, kv_chunk)
        ctx.save_for_backward(qg, k, v, out, lse)
        ctx.spec, ctx.kv_chunk = spec, kv_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(qg, k, v, out, lse, dout, ctx.spec, ctx.kv_chunk)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, spec: AttnSpec, *, kv_chunk: int = 512) -> torch.Tensor:
    """Memory-optimal flash for the train / prefill path (q_offset=0): the
    serving scan forward, bit for bit ``attention_chunked``'s, and the
    reference's custom backward (:class:`_Flash`)."""
    b, sq, h, d = q.shape
    kvh, dvd = k.shape[2], v.shape[-1]
    kv_chunk = min(kv_chunk, k.shape[1])
    qg = (q / math.sqrt(d)).reshape(b, sq, kvh, h // kvh, d)
    out = _Flash.apply(qg, k, v, spec, kv_chunk)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dvd).to(q.dtype)


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


def use_context_parallel(cfg: ModelConfig, tp: TP) -> bool:
    """The reference's ``_use_context_parallel``: ``attn_partition``
    "context" or "heads" as asked, "auto" the context partition where the
    ``model`` axis does not divide the heads; never on one rank."""
    if tp.p == 1:
        return False
    if cfg.attn_partition == "context":
        return True
    if cfg.attn_partition == "heads":
        return False
    return cfg.num_heads % tp.p != 0


class _Split(NamedTuple):
    heads: bool  # wq / bq / wo in blocks of H/P heads
    kv: bool  # wk / wv / bk / bv in blocks of KVH/P heads
    cache: bool  # the KV cache in blocks of KVH/P heads
    context: bool  # the context partition for the full-sequence passes


def _split(cfg: ModelConfig, tp: TP) -> _Split:
    ctx = use_context_parallel(cfg, tp)
    kv = tp.splits(cfg.num_kv_heads)
    return _Split(tp.splits(cfg.num_heads), kv, kv and not ctx, ctx)


def cache_heads(cfg: ModelConfig, tp: TP) -> int:
    """The KV heads of the cache this process holds."""
    return cfg.num_kv_heads // tp.p if _split(cfg, tp).cache and tp.holds_block else cfg.num_kv_heads


def _heads_block(tp: TP, w: torch.Tensor, dim: int, c: int, units: int, width: int, *,
                 vary: bool = False) -> torch.Tensor:
    """Coordinate ``c``'s block of ``units`` heads of ``width`` along ``dim``
    (``vary``: ``TP.block``'s)."""
    return tp.block(w, dim % w.ndim, c, units * width, units, vary=vary)


def _gqa_qkv(p: Params, x: Acts, cfg: ModelConfig, positions: torch.Tensor, tp: TP, coords: Sequence[int]):
    """Each coordinate's (q (B, S, H', hd), k, v (B, S, KVH', hd)), rope
    applied: its Q heads and its K / V heads (every KV head where they
    stay whole), over the whole sequence. Where the Q heads are split or
    the activations are sequence blocks the products differ by rank, and
    K / V weights kept whole enter through ``TP.vary``."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    split = tp.splits(h)
    rs = split or tp.seq
    cols = tp.col(x, lambda c: [_heads_block(tp, p[n], -1, c, u, hd, vary=rs)
                                for n, u in (("wq", h), ("wk", kvh), ("wv", kvh))], coords, split=split)
    out = []
    for c, (q, k, v) in zip(coords, cols):
        dt = q.dtype
        if cfg.qkv_bias:
            q = q + _heads_block(tp, p["bq"], 0, c, h, hd, vary=rs).to(dt)
            k = k + _heads_block(tp, p["bk"], 0, c, kvh, hd, vary=rs).to(dt)
            v = v + _heads_block(tp, p["bv"], 0, c, kvh, hd, vary=rs).to(dt)
        b, s = q.shape[:2]
        q = q.reshape(b, s, -1, hd)
        k = k.reshape(b, s, -1, hd)
        v = v.reshape(b, s, -1, hd)
        if cfg.rope_theta > 0:
            q = common.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
            k = common.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        out.append((q, k, v))
    return out


def _kv_for(t: torch.Tensor, c: int, cfg: ModelConfig, tp: TP) -> torch.Tensor:
    """The K or V heads (dim 2 of ``t``) that coordinate ``c``'s Q heads
    read: ``t`` itself where it holds every Q head or is the rank's own
    KV block; of a whole ``t``, the KV heads of the rank's GQA groups
    (``h // (H / KVH)``): a view where they are contiguous whole groups
    or one group, else one KV head per Q head (a copy)."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if not tp.splits(h) or t.shape[2] != kvh:
        return t
    n, g = h // tp.p, h // kvh
    if g % n == 0:
        return t.narrow(2, c * n // g, 1)
    if n % g == 0:
        return t.narrow(2, c * n // g, n // g)
    return t.index_select(2, torch.tensor([(c * n + i) // g for i in range(n)], device=t.device))


def _out(p: Params, o: torch.Tensor, c: int, cfg: ModelConfig, tp: TP, width: int, *,
         vary: bool = False) -> torch.Tensor:
    """Coordinate ``c``'s (B, S, H', width) attention output through its
    row block of ``wo`` (``vary``: the outputs differ by rank, so a whole
    ``wo`` enters through ``TP.vary``)."""
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ _heads_block(tp, p["wo"], 0, c, cfg.num_heads, width, vary=vary).to(o.dtype)


def _full_attention(p: Params, x: Acts, cfg: ModelConfig, spec: AttnSpec, impl: str, tp: TP,
                    cache: Optional["KVCache"] = None) -> Acts:
    """The full-sequence pass (positions 0..S-1) in the heads or the
    context partition; with ``cache``, its rows [0, S) written in place
    from the fresh K / V (the rank's KV heads, or all of them once)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    sp = _split(cfg, tp)
    whole = x if isinstance(x, torch.Tensor) else x[0]
    s = whole.shape[1] * (tp.p if tp.seq else 1)
    context = sp.context and s % tp.p == 0
    rs = sp.heads or tp.seq  # the q / k / v products differ by rank (else the same on every rank)
    coords = tp.owners(sp.heads or context)
    qkv = _gqa_qkv(p, x, cfg, torch.arange(s, device=whole.device), tp, coords)
    kv_whole = None
    if context or (cache is not None and not sp.cache):
        if sp.kv:
            kv_whole = (tp.gather([k for _, k, _ in qkv], 2), tp.gather([v for _, _, v in qkv], 2))
        else:
            kv_whole = qkv[0][1:]
    if cache is not None:
        if sp.cache:
            for c, (_, k, v) in zip(coords, qkv):
                tp.block(cache.k, 2, c, kvh)[:, :s] = k.to(cache.k.dtype)
                tp.block(cache.v, 2, c, kvh)[:, :s] = v.to(cache.v.dtype)
        else:
            cache.k[:, :s] = kv_whole[0].to(cache.k.dtype)
            cache.v[:, :s] = kv_whole[1].to(cache.v.dtype)
    if not context:
        outs = [attention(q, _kv_for(k, c, cfg, tp), _kv_for(v, c, cfg, tp), spec, impl=impl,
                          kv_chunk=cfg.attn_kv_chunk) for c, (q, k, v) in zip(coords, qkv)]
        return tp.reduce([_out(p, o, c, cfg, tp, hd, vary=rs) for c, o in zip(coords, outs)],
                         "partial" if sp.heads else "whole")
    sl = s // tp.p
    if sp.heads:  # the head blocks -> each rank's S/P queries of every head
        qs = tp.all_to_all([q for q, _, _ in qkv], 1, 2)
    else:
        qs = [tp.vary(q, not rs, c).narrow(1, c * sl, sl) for c, (q, _, _) in zip(coords, qkv)]
    # every rank's queries read the whole K / V: gathered, or the same on every rank
    k, v = (tp.vary(t, sp.kv or not rs) for t in kv_whole)
    outs = [attention(q, k, v, spec, impl=impl, kv_chunk=cfg.attn_kv_chunk, q_offset=c * sl)
            for c, q in zip(coords, qs)]
    if sp.heads:  # back to the head blocks over the whole sequence, for the row-parallel wo
        outs = tp.all_to_all(outs, 2, 1)
        return tp.reduce([_out(p, o, c, cfg, tp, hd) for c, o in zip(coords, outs)], "partial")
    return tp.reduce([_out(p, o, c, cfg, tp, hd, vary=True) for c, o in zip(coords, outs)], "seq")


def apply_attention(
    p: Params, x: Acts, cfg: ModelConfig, spec: AttnSpec, *, impl: str = "chunked", tp: TP = common.SINGLE,
) -> Acts:
    """The training / trunk pass over positions 0..S-1."""
    return _full_attention(p, x, cfg, spec, impl, tp)


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
    tp: TP = common.SINGLE,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: write K/V at each row's cache.length, attend over
    the cache. Rows may be at different positions (serving slots).

    The write goes into ``cache.k`` / ``cache.v`` in place (``_write_rows``):
    each rank's KV heads where the cache is split, else all of them once
    (the new token's K / V gathered over the ranks where their weights are
    split); the returned cache shares them, with ``length + 1``.
    """
    kvh, hd = cfg.num_kv_heads, cfg.head_dim_
    sp = _split(cfg, tp)
    pos = cache.length  # (B,)
    coords = tp.owners(sp.heads)
    qkv = _gqa_qkv(p, x, cfg, pos[:, None], tp, coords)

    def view(t, c):
        return tp.block(t, 2, c, kvh) if sp.cache else t

    if sp.cache:
        for c, (_, k, v) in zip(coords, qkv):
            _write_rows(pos, (view(cache.k, c), k[:, 0]), (view(cache.v, c), v[:, 0]))
    else:
        k, v = ((tp.gather([t[i] for t in qkv], 2) for i in (1, 2)) if sp.kv else qkv[0][1:])
        _write_rows(pos, (cache.k, k[:, 0]), (cache.v, v[:, 0]))
    parts = []
    for c, (q, _, _) in zip(coords, qkv):
        o = attention_chunked(q, _kv_for(view(cache.k, c), c, cfg, tp), _kv_for(view(cache.v, c), c, cfg, tp), spec,
                              q_offset=pos, kv_chunk=kv_chunk, kv_valid_len=pos + 1)
        parts.append(_out(p, o, c, cfg, tp, hd))
    return tp.reduce(parts, "partial" if sp.heads else "whole"), KVCache(cache.k, cache.v, pos + 1)


def prefill_attention(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cache: KVCache,
    cfg: ModelConfig,
    spec: AttnSpec,
    *,
    impl: str = "chunked",
    tp: TP = common.SINGLE,
) -> Tuple[torch.Tensor, KVCache]:
    """Causal full-sequence pass that also writes cache[0:S] in place.
    It attends the fresh K/V, not the cache's (bfloat16) copy of them."""
    b, s, _ = x.shape
    out = _full_attention(p, x, cfg, spec, impl, tp, cache)
    return out, KVCache(cache.k, cache.v, torch.full((b,), s, dtype=torch.int32, device=x.device))


def flash_decode_combine(partial_out: Sequence[torch.Tensor], partial_m: Sequence[torch.Tensor],
                         partial_l: Sequence[torch.Tensor], mesh, axis_name: str) -> List[torch.Tensor]:
    """Distributed decode over a sequence-sharded KV, the reference's
    two-psum combine: each rank's partial online softmax -- its (B, 1, H,
    Dv) unnormalized output, (B, H) max and (B, H) sum over its slice of
    the keys, one of each per ``mesh.local_ranks()`` -- rescaled by the
    global max (``mesh.pmax``) and summed (``mesh.psum``) over
    ``axis_name``. Returns each rank's normalized (B, 1, H, Dv) output."""
    m_glob = mesh.pmax(list(partial_m), axis_name)
    scale = [torch.exp(m - g) for m, g in zip(partial_m, m_glob)]
    num = mesh.psum([o * sc[:, None, :, None] for o, sc in zip(partial_out, scale)], axis_name)
    den = mesh.psum([l * sc for l, sc in zip(partial_l, scale)], axis_name)
    return [n / torch.clamp(d[:, None, :, None], min=1e-30) for n, d in zip(num, den)]


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


def _mla_ranks(p: Params, x: Acts, cfg: ModelConfig, positions: torch.Tensor, tp: TP, coords: Sequence[int]):
    """Each coordinate's (q_nope (B,S,H',nope), q_rope (B,S,H',rope)
    rotated, ckv (B,S,r) normalized, k_rope (B,S,1,rope) rotated): its
    heads' queries, and the latent, which every rank computes whole. The
    latent's leaves are whole: on sequence blocks they meet each rank's
    rows (``TP.vary``); on replicated activations the latent is the same
    on every rank and enters the rank's heads through ``TP.vary``."""
    m: MLAConfig = cfg.mla
    h, qd = cfg.num_heads, m.nope_head_dim + m.rope_head_dim
    seq, split = tp.seq, tp.splits(h)
    enter = split and not seq  # a latent the same on every rank, into the rank's heads
    q_norm, kv_norm = tp.vary_tree(p["q_norm"], seq), tp.vary_tree(p["kv_norm"], seq)
    out = []
    for c, (cq, ckv_full) in zip(coords, tp.col(x, lambda c: [tp.vary(p["wdq"], seq, c), tp.vary(p["wdkv"], seq, c)],
                                                coords)):
        dt = cq.dtype
        cq = tp.vary(common.apply_norm(q_norm, cq, "rmsnorm"), enter, c)
        q = cq @ _heads_block(tp, p["wuq"], 1, c, h, qd, vary=seq).to(dt)
        q = q.reshape(q.shape[0], q.shape[1], -1, qd)
        q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
        q_rope = common.rope(q_rope, positions, cfg.rope_theta)
        ckv = tp.vary(common.apply_norm(kv_norm, ckv_full[..., :m.kv_lora_rank], "rmsnorm"), enter, c)
        k_rope = tp.vary(common.rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta), enter,
                         c)
        out.append((q_nope, q_rope, ckv, k_rope))
    return out


def _mla_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """One rank's (q_nope, q_rope, ckv, k_rope) of :func:`_mla_ranks`."""
    return _mla_ranks(p, x, cfg, positions, common.SINGLE, [0])[0]


def _mla_expanded(p: Params, x: Acts, cfg: ModelConfig, spec: AttnSpec, positions, impl: str, tp: TP):
    """Attention with the latent expanded to per-head K/V (MHA), each
    rank on its heads: returns (output in x's layout, ckv, k_rope) -- the
    fresh latent, for a cache."""
    m: MLAConfig = cfg.mla
    h, e = cfg.num_heads, m.nope_head_dim + m.v_head_dim
    split = tp.splits(h)
    coords = tp.owners(split)
    parts = []
    ranks = _mla_ranks(p, x, cfg, positions, tp, coords)
    for c, (q_nope, q_rope, ckv, k_rope) in zip(coords, ranks):
        b, s, n = q_nope.shape[:3]
        kv = (ckv @ _heads_block(tp, p["wukv"], 1, c, h, e, vary=tp.seq).to(ckv.dtype)).reshape(b, s, n, e)
        k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
        k = torch.cat([k_nope, k_rope.expand(b, s, n, m.rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        parts.append(_out(p, attention(q, k, v, spec, impl=impl), c, cfg, tp, m.v_head_dim, vary=tp.seq))
    return tp.reduce(parts, "partial" if split else "whole"), ranks[0][2], ranks[0][3]


def apply_mla(
    p: Params,
    x: Acts,
    cfg: ModelConfig,
    spec: AttnSpec,
    *,
    positions: Optional[torch.Tensor] = None,
    impl: str = "chunked",
    tp: TP = common.SINGLE,
) -> Acts:
    """Training/prefill MLA: expand the latent to per-head K/V, run MHA."""
    if positions is None:
        whole = x if isinstance(x, torch.Tensor) else x[0]
        positions = torch.arange(whole.shape[1] * (tp.p if tp.seq else 1), device=whole.device)
    return _mla_expanded(p, x, cfg, spec, positions, impl, tp)[0]


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
    tp: TP = common.SINGLE,
) -> Tuple[torch.Tensor, MLACache]:
    """Full-sequence MLA pass that writes the latent cache[0:S] in place.
    It attends the fresh latent, not the cache's (bfloat16) copy of it."""
    b, s, _ = x.shape
    out, ckv, k_rope = _mla_expanded(p, x, cfg, spec, torch.arange(s, device=x.device), impl, tp)
    cache.ckv[:, :s] = ckv.to(cache.ckv.dtype)
    cache.k_rope[:, :s] = k_rope[:, :, 0, :].to(cache.k_rope.dtype)
    return out, MLACache(cache.ckv, cache.k_rope, torch.full((b,), s, dtype=torch.int32, device=x.device))


def decode_mla(
    p: Params, x: torch.Tensor, cache: MLACache, cfg: ModelConfig, spec: AttnSpec, *, tp: TP = common.SINGLE,
) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-matrix MLA decode: scores against the *latent* cache.

    score_h = (W_uk[h]^T q_nope[h]) . ckv + q_rope[h] . k_rope, so the
    cache stays rank-(kv_lora + rope_d) per token. The write goes into
    the cache in place (a row past its end is not written, as in
    :func:`decode_attention`); every row attends positions <= its own.
    Each rank absorbs its heads' up-projection. ``spec`` is unused, as in
    the reference (no window, no softcap).
    """
    m: MLAConfig = cfg.mla
    h, e = cfg.num_heads, m.nope_head_dim + m.v_head_dim
    pos = cache.length  # (B,)
    b, dt = x.shape[0], x.dtype
    split = tp.splits(h)
    coords = tp.owners(split)
    ranks = _mla_ranks(p, x, cfg, pos[:, None], tp, coords)
    _write_rows(pos, (cache.ckv, ranks[0][2][:, 0]), (cache.k_rope, ranks[0][3][:, 0, 0, :]))
    ckv_c, kr_c = cache.ckv.to(dt), cache.k_rope.to(dt)
    t_idx = torch.arange(ckv_c.shape[1], device=x.device)
    parts = []
    for c, (q_nope, q_rope, _, _) in zip(coords, ranks):
        n = q_nope.shape[2]
        wukv = _heads_block(tp, p["wukv"], 1, c, h, e).reshape(m.kv_lora_rank, n, e)
        wuk = wukv[..., :m.nope_head_dim].to(dt)  # (r, h, nope)
        wuv = wukv[..., m.nope_head_dim:].to(dt)  # (r, h, v)
        q_lat = torch.einsum("bshe,rhe->bshr", q_nope, wuk)  # the absorbed query
        s_lat = torch.einsum("bshr,btr->bhst", q_lat, ckv_c)
        s_rope = torch.einsum("bshe,bte->bhst", q_rope, kr_c)
        scores = (s_lat + s_rope).float() / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        scores = torch.where((t_idx <= pos[:, None])[:, None, None, :], scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1)
        lat_sum = torch.einsum("bhst,btr->bshr", pr.to(dt), ckv_c)
        o = torch.einsum("bshr,rhe->bshe", lat_sum, wuv)
        parts.append(_out(p, o, c, cfg, tp, m.v_head_dim))
    return tp.reduce(parts, "partial" if split else "whole"), MLACache(cache.ckv, cache.k_rope, pos + 1)
