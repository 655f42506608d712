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
  / ``bv`` are split by KV heads where P divides their count; elsewhere
  they stay whole on every rank, and each rank reads the KV heads its Q
  heads read (GQA group ``h // (H / KVH)``).
- **context partition** (:func:`use_context_parallel`: ``attn_partition``
  "context", or "auto" where P does not divide the heads), for the
  full-sequence passes: Q sequence-sharded (an all-to-all from the head
  blocks, or each rank's rows of the whole Q), K / V whole (an all-gather
  of the KV head blocks), every head on the rank's S/P queries, then back
  to the row-parallel ``wo`` (an all-to-all) or, where the heads stay
  whole, ``wo`` on the rank's rows and an all-gather. Where P does not
  divide S it falls back to the heads partition if P divides the heads,
  else every rank computes every head (the reference pads; the outputs
  are the same).
- **the serving cache** lies as the reference's ``decode_state_shardings``
  places it (:func:`cache_model_dim`, :func:`cache_block`): by KV heads
  over ``model`` where P divides them, else by head dim where P divides
  that, else whole; with ``TP.kv_seq`` (``long_500k``'s ``seq_shard``)
  its sequence in blocks over ``data``. A process on a
  ``ProcessGroupMesh`` holds its block, a ``SimMesh`` the whole cache
  (a rank's block a view). Prefill writes each block from the fresh K /
  V, computed as above (no new collective). Decode
  (:func:`_attend_cache`) attends each block of the cache. On a head-dim
  cut it takes the step's queries of every head (gathered over ``model``
  where they are head blocks), sums each rank's partial scores against
  its slice of the keys by one psum over ``model`` a layer, applies the
  scale, the softcap and the mask to the full-width sums, reads the
  rank's slice of the values, and goes back to ``wo``: an all-to-all to
  the rank's heads, or the rows of its slice of a whole ``wo``, then one
  psum. On a sequence-sharded cache each rank's online softmax over its
  own keys (masked by absolute position; a block with no visible key
  gives m = -inf and l = 0) is combined over ``data`` by
  :func:`flash_decode_combine`, after the scores' psum where both cuts
  apply.
- **MLA**: ``wdq`` / ``wdkv`` and the latent cache whole on every rank,
  ``wuq`` / ``wukv`` column blocks by head (the absorbed decode absorbs
  the rank's heads), ``wo`` a row block, one psum (the reference
  constrains MLA to the heads partition). With ``TP.kv_seq`` the latent
  cache's sequence lies in blocks over ``data`` (:func:`mla_cache_block`),
  and the decode combines the blocks' partial softmaxes after ``wuv``.

:func:`flash_decode_combine` merges partial online softmaxes over a
sequence-sharded KV (``pmax`` then two ``psum`` s): the decode of a
sequence-sharded cache calls it; over a process group it has no
gradient (``mesh.pmax`` raises under autograd).

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


def _online_softmax(qg: Optional[torch.Tensor], k: Optional[torch.Tensor], v: torch.Tensor, spec: AttnSpec,
                    q_idx: torch.Tensor, valid: Optional[torch.Tensor], kv_chunk: int, *, k0: int = 0,
                    scores: Optional[torch.Tensor] = None):
    """The online-softmax scan over KV chunks: (m, l, acc) of the float32
    queries ``qg`` (B, Sq, KVH, G, D), already scaled, against ``k`` /
    ``v`` in their own dtype; ``valid`` the valid cache entries (None, or
    broadcastable against the (Sq, K) / (B, Sq, K) mask). ``k0``: the
    position of the first key (a block of a sequence-sharded cache).
    ``scores``: the (B, KVH, G, Sq, Skv) float32 scores of every key,
    already summed (a head-dim cut's psum), in place of ``qg`` and ``k``."""
    if scores is None:
        b, sq, kvh, g, _ = qg.shape
    else:
        b, kvh, g, sq = scores.shape[:4]
    skv, dv = v.shape[1], v.shape[-1]
    dev = v.device
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=dev)
    for j in common.trips("kv", -(-skv // kv_chunk), v)[0]:
        start = j * kv_chunk
        vb = v[:, start:start + kv_chunk]
        if scores is None:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, start:start + kv_chunk].float())
        else:
            s = scores[..., start:start + kv_chunk]
        s = common.softcap(s, spec.softcap)
        k_idx = torch.arange(k0 + start, k0 + start + vb.shape[1], device=dev)
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
    run, skipped = common.trips("kv", -(-k.shape[1] // kv_chunk), k)
    for j in run:
        if skipped and j == run[-1]:
            dks += common.stand_ins(dks[-1], skipped)
            dvs += common.stand_ins(dvs[-1], skipped)
        start = j * kv_chunk
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
    cache: Optional[int]  # the KV cache's dim cut over the axis: 2 (KV heads), 3 (head dim) or None
    context: bool  # the context partition for the full-sequence passes


def cache_model_dim(kv_heads: int, head_dim: int, p: int) -> Optional[int]:
    """The dim of a (B, S, KVH, hd) KV cache a ``model`` axis of ``p``
    ranks cuts: 2, the KV heads, where ``p`` divides them; else 3, the
    head dim, where ``p`` divides it; else None (whole on every rank).
    The reference's ``decode_state_shardings`` rule
    (``repro/launch/specs.py:77-82``); ``launch.specs._leaf_spec`` reads
    it from here."""
    if kv_heads % p == 0:
        return 2
    return 3 if head_dim % p == 0 else None


def _split(cfg: ModelConfig, tp: TP) -> _Split:
    cache = cache_model_dim(cfg.num_kv_heads, cfg.head_dim_, tp.p) if tp.p > 1 else None
    return _Split(tp.splits(cfg.num_heads), tp.splits(cfg.num_kv_heads), cache, use_context_parallel(cfg, tp))


def cache_block(cfg: ModelConfig, tp: TP, b: int, s_tot: int) -> Tuple[int, int, int, int]:
    """The (B, S, KVH, hd) shape of the KV cache of ``b`` rows and
    ``s_tot`` positions this process holds: its block -- the KV heads or
    the head dim over ``model`` (:func:`cache_model_dim`), the sequence
    over ``data`` where ``tp.kv_seq`` -- where it holds its own blocks (a
    ``ProcessGroupMesh``), else the whole cache (a ``SimMesh``: each
    rank's block a view, :func:`_cache_view`)."""
    shape = [b, s_tot, cfg.num_kv_heads, cfg.head_dim_]
    dim = _split(cfg, tp).cache
    if dim is not None and tp.holds_block:
        shape[dim] //= tp.p
    if tp.kv_seq is not None and tp.kv_seq.holds_block:
        shape[1] //= tp.kv_seq.blocks
    return tuple(shape)


def _cache_view(t: torch.Tensor, dim: Optional[int], tp: TP, c: int, d: int) -> torch.Tensor:
    """The block of coordinate ``c`` on ``model`` and ``d`` on ``data`` of
    a cache leaf laid out as :func:`cache_block` says (``dim``: the dim
    cut over ``model``): the leaf itself where the process holds its
    block, else a view of the whole."""
    if dim is not None and not tp.holds_block:
        n = t.shape[dim] // tp.p
        t = t.narrow(dim, c * n, n)
    if tp.kv_seq is not None and not tp.kv_seq.holds_block:
        n = t.shape[1] // tp.kv_seq.blocks
        t = t.narrow(1, d * n, n)
    return t


def _cache_blocks(sp: _Split, tp: TP) -> List[Tuple[int, int]]:
    """The (model, data) coordinates of the cache blocks this process
    writes: each local one where the cache is cut, else one."""
    cs = tp.ranks if sp.cache is not None else tp.ranks[:1]
    return [(c, d) for c in cs for d in (tp.kv_seq.coords if tp.kv_seq is not None else [0])]


def _slice(t: torch.Tensor, sp: _Split, view: torch.Tensor, c: int) -> torch.Tensor:
    """``t`` (K or V at the full head dim) cut to ``view``'s head dim:
    coordinate ``c``'s slice where the cache is cut along it."""
    if sp.cache != 3:
        return t
    w = view.shape[3]
    return t.narrow(-1, c * w, w)


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
    from the fresh K / V into each block of it the process holds (the
    rank's KV heads, its head-dim slice or its sequence block)."""
    hd = cfg.head_dim_
    sp = _split(cfg, tp)
    whole = x if isinstance(x, torch.Tensor) else x[0]
    s = whole.shape[1] * (tp.p if tp.seq else 1)
    context = sp.context and s % tp.p == 0
    rs = sp.heads or tp.seq  # the q / k / v products differ by rank (else the same on every rank)
    coords = tp.owners(sp.heads or context)
    qkv = _gqa_qkv(p, x, cfg, torch.arange(s, device=whole.device), tp, coords)
    kv_whole = None
    if context or (cache is not None and sp.cache != 2):
        if sp.kv:
            kv_whole = (tp.gather([k for _, k, _ in qkv], 2), tp.gather([v for _, _, v in qkv], 2))
        else:
            kv_whole = qkv[0][1:]
    if cache is not None:  # each block from the rank's KV heads, or from all of them
        own = {c: (k, v) for c, (_, k, v) in zip(coords, qkv)}
        for c, d in _cache_blocks(sp, tp):
            for t, new in zip((cache.k, cache.v), own[c] if sp.cache == 2 else kv_whole):
                view = _cache_view(t, sp.cache, tp, c, d)
                lo, n = d * view.shape[1], view.shape[1]
                if lo < s:
                    view[:, :min(s - lo, n)] = _slice(new, sp, view, c)[:, lo:lo + n].to(t.dtype)
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
    past the end (an idle serving slot keeps stepping), or before the
    start (another rank's block of a sequence-sharded cache), is not
    written, as JAX drops an out-of-bounds ``.at[].set`` (torch would
    raise)."""
    first = pairs[0][0]
    rows = torch.arange(first.shape[0], device=first.device)
    at = pos.clamp(0, first.shape[1] - 1).long()
    inside = (pos >= 0) & (pos < first.shape[1])
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
    each block of the cache the process holds (:func:`cache_block`) takes
    its KV heads, its head-dim slice or, sequence-sharded, the row of the
    block that holds the position; the returned cache shares them, with
    ``length + 1``. The attention is :func:`_attend_cache`'s.
    """
    sp = _split(cfg, tp)
    pos = cache.length  # (B,)
    coords = tp.ranks if sp.cache == 3 else tp.owners(sp.heads)
    qkv = _gqa_qkv(p, x, cfg, pos[:, None], tp, coords)
    new = {c: (k[:, 0], v[:, 0]) for c, (_, k, v) in zip(coords, qkv)}
    for c, d in _cache_blocks(sp, tp):
        views = [_cache_view(t, sp.cache, tp, c, d) for t in (cache.k, cache.v)]
        kv = new[c] if sp.cache == 2 else new[coords[0]]  # the rank's KV heads, or every one
        _write_rows(pos - d * views[0].shape[1], *((vw, _slice(t, sp, vw, c)) for vw, t in zip(views, kv)))
    return _attend_cache(p, qkv, coords, cache, cfg, spec, sp, tp, kv_chunk), KVCache(cache.k, cache.v, pos + 1)


def _attend_cache(p: Params, qkv, coords: List[int], cache: KVCache, cfg: ModelConfig, spec: AttnSpec, sp: _Split,
                  tp: TP, kv_chunk: int) -> torch.Tensor:
    """The decode step's attention over the cache (the write done),
    through ``wo``, reduced.

    Each coordinate's online softmax runs over its block of the keys,
    masked by absolute position: of its Q heads at the full head dim, or
    on a head-dim cut of every head at the rank's slice, from the
    partial scores of every rank's slice summed by one psum over
    ``model`` a layer -- the scale (1/sqrt of the full head dim, on the
    query, as the uncut path scales it), the softcap and the mask apply
    to the sums. A block with no visible key (a windowed layer far from
    the position) leaves m = -inf and l = 0; over ``data`` the blocks
    combine through :func:`flash_decode_combine`. The output goes to
    ``wo``: on a head-dim cut an all-to-all over ``model`` brings a rank
    its own heads at the full head dim for its row block of ``wo``, or,
    where ``wo`` is whole, the rank's slice meets its rows of ``wo``; one
    psum sums the parts."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    pos = cache.length
    q_idx, valid = pos[:, None], (pos + 1)[:, None, None]
    dt = qkv[0][0].dtype
    cut_hd = sp.cache == 3
    w = hd // tp.p  # a head-dim slice
    if cut_hd:  # every head's query, gathered where the heads are blocks over the axis
        q = tp.gather([q for q, _, _ in qkv], 2) if sp.heads else qkv[0][0]
        qg = (q / math.sqrt(hd)).reshape(q.shape[0], 1, kvh, h // kvh, hd).float()
    blocks = []  # each data block's (out, m, l) of each softmax this process runs
    for d in tp.kv_seq.coords if tp.kv_seq is not None else [0]:
        k0 = d * _cache_view(cache.v, sp.cache, tp, coords[0], d).shape[1]
        if cut_hd:  # one softmax of the summed scores over the values every local rank holds (their slices)
            scores = tp.psum([torch.einsum("bqhgd,bkhd->bhgqk", qg[..., c * w:(c + 1) * w],
                                           _cache_view(cache.k, sp.cache, tp, c, d).float()) for c in coords])
            v = _cache_view(cache.v, None, tp, coords[0], d)
            runs = [_online_softmax(None, None, v, spec, q_idx, valid, min(kv_chunk, v.shape[1]), k0=k0,
                                    scores=scores)]
        else:  # each coordinate's Q heads against the KV heads it reads
            runs = []
            for c, (q_c, _, _) in zip(coords, qkv):
                k, v = (_kv_for(_cache_view(t, sp.cache, tp, c, d), c, cfg, tp) for t in (cache.k, cache.v))
                qc = (q_c / math.sqrt(hd)).reshape(q_c.shape[0], 1, k.shape[2], -1, hd).float()
                runs.append(_online_softmax(qc, k, v, spec, q_idx, valid, min(kv_chunk, k.shape[1]), k0=k0))
        parts = []
        for m, l, acc in runs:
            if tp.kv_seq is not None:  # a block with no visible key: m = -inf, l = 0
                empty = m <= NEG_INF
                m, l = m.masked_fill(empty, -math.inf), l.masked_fill(empty, 0.0)
                acc = acc.masked_fill(empty[..., None], 0.0)
            b = m.shape[0]
            parts.append((acc.permute(0, 3, 1, 2, 4).reshape(b, 1, -1, acc.shape[-1]), m.reshape(b, -1),
                          l.reshape(b, -1)))
        blocks.append(parts)
    outs = []
    for accs, ms, ls in (zip(*run) for run in zip(*blocks)):  # each softmax over the data blocks
        if tp.kv_seq is not None:
            o = flash_decode_combine(accs, ms, ls, tp.kv_seq.ring, "data")[0]
        else:
            o = accs[0] / torch.clamp(ls[0][:, None, :, None], min=1e-30)
        outs.append(o.to(dt))
    if cut_hd:  # each local rank's slice of the head dim
        outs = [outs[0].narrow(-1, i * w, w) for i in range(len(coords))]
    if cut_hd and sp.heads:  # every head's slice -> the rank's heads at the full head dim
        outs = tp.all_to_all(outs, 2, 3)
    if cut_hd and not sp.heads:  # wo whole: the rows of the rank's slice of every head
        res = [torch.einsum("bshe,hed->bsd", o, _heads_block(tp, p["wo"], 0, c, h, hd).reshape(h, hd, -1)
                            [:, c * w:(c + 1) * w].to(o.dtype)) for c, o in zip(coords, outs)]
    else:
        res = [_out(p, o, c, cfg, tp, hd) for c, o in zip(coords, outs)]
    return tp.reduce(res, "partial" if sp.heads or cut_hd else "whole")


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
    # a rank with no visible key (m = -inf) adds nothing, even where no rank has one
    scale = [torch.where(torch.isneginf(m), 0.0, torch.exp(m - g)) for m, g in zip(partial_m, m_glob)]
    num = mesh.psum([o * sc[:, None, :, None] for o, sc in zip(partial_out, scale)], axis_name, activation=True)
    den = mesh.psum([l * sc for l, sc in zip(partial_l, scale)], axis_name, activation=True)
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


def mla_cache_block(tp: TP, b: int, s_tot: int) -> Tuple[int, int]:
    """The (B, S) of the latent cache of ``b`` rows and ``s_tot``
    positions this process holds, :func:`cache_block`'s counterpart: the
    sequence over ``data`` where ``tp.kv_seq`` and the process holds its
    own block (a ``ProcessGroupMesh``), else the whole cache (a
    ``SimMesh``: each block a view, :func:`_cache_view`). The latent
    stays whole over ``model``, as the reference's spec has it."""
    if tp.kv_seq is not None and tp.kv_seq.holds_block:
        return b, s_tot // tp.kv_seq.blocks
    return b, s_tot


def init_mla_cache(b: int, s_max: int, m: MLAConfig, dtype=torch.bfloat16, device=None,
                   tp: TP = common.SINGLE) -> MLACache:
    """One layer's latent cache: this process's block of it (:func:`mla_cache_block`)."""
    b, s = mla_cache_block(tp, b, s_max)
    return MLACache(
        ckv=torch.zeros((b, s, m.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((b, s, m.rope_head_dim), dtype=dtype, device=device),
        length=torch.zeros((b,), dtype=torch.int32, device=device),
    )


def _latent_blocks(cache: MLACache, tp: TP) -> List[Tuple[int, torch.Tensor, torch.Tensor]]:
    """(``data`` coordinate, ckv, k_rope) of each block of the latent
    cache the process holds or views; without ``tp.kv_seq`` one, the
    whole cache."""
    return [(d, _cache_view(cache.ckv, None, tp, 0, d), _cache_view(cache.k_rope, None, tp, 0, d))
            for d in (tp.kv_seq.coords if tp.kv_seq is not None else [0])]


def prefill_mla(
    p: Params, x: torch.Tensor, cache: MLACache, cfg: ModelConfig, spec: AttnSpec, *, impl: str = "chunked",
    tp: TP = common.SINGLE,
) -> Tuple[torch.Tensor, MLACache]:
    """Full-sequence MLA pass that writes the latent cache[0:S] in place,
    into each block of it the process holds (:func:`mla_cache_block`).
    It attends the fresh latent, not the cache's (bfloat16) copy of it."""
    b, s, _ = x.shape
    out, ckv, k_rope = _mla_expanded(p, x, cfg, spec, torch.arange(s, device=x.device), impl, tp)
    for d, ckv_d, kr_d in _latent_blocks(cache, tp):
        lo, n = d * ckv_d.shape[1], ckv_d.shape[1]
        if lo < s:
            ckv_d[:, :min(s - lo, n)] = ckv[:, lo:lo + n].to(ckv_d.dtype)
            kr_d[:, :min(s - lo, n)] = k_rope[:, lo:lo + n, 0, :].to(kr_d.dtype)
    return out, MLACache(cache.ckv, cache.k_rope, torch.full((b,), s, dtype=torch.int32, device=x.device))


def _latent_block_attend(q_lat: torch.Tensor, q_rope: torch.Tensor, wuv: torch.Tensor, ckv: torch.Tensor,
                         k_rope: torch.Tensor, k0: int, pos: torch.Tensor, cfg: ModelConfig):
    """One block of the latent cache (positions ``k0`` on) under a
    coordinate's absorbed queries (B, 1, H', r) and rope queries: its
    (B, 1, H', v_head_dim) output through ``wuv``, normalized over the
    block, and its (B, H', 1, S_block) float32 scores, scaled and masked
    on absolute positions, for :func:`_latent_combine`."""
    m: MLAConfig = cfg.mla
    t_idx = torch.arange(k0, k0 + ckv.shape[1], device=ckv.device)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, ckv)
    s_rope = torch.einsum("bshe,bte->bhst", q_rope, k_rope)
    scores = (s_lat + s_rope).float() / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    scores = torch.where((t_idx <= pos[:, None])[:, None, None, :], scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    lat_sum = torch.einsum("bhst,btr->bshr", pr.to(q_lat.dtype), ckv)
    return torch.einsum("bshr,rhe->bshe", lat_sum, wuv), scores


def _latent_combine(runs, tp: TP) -> torch.Tensor:
    """The data blocks' normalized outputs and scores
    (:func:`_latent_block_attend`) merged by :func:`flash_decode_combine`
    over ``data``: each block enters with its log-sum-exp as the max and
    1 as the sum, so the combine weighs the blocks by their shares of the
    softmax. A block with no visible key has a log-sum-exp of -inf and
    adds nothing, as :func:`_attend_cache`'s empty blocks."""
    lse = [torch.logsumexp(sc, -1)[..., 0] for _, sc in runs]
    lse = [x.masked_fill(x <= NEG_INF, -math.inf) for x in lse]
    return flash_decode_combine([o.float() for o, _ in runs], lse, [torch.ones_like(x) for x in lse],
                                tp.kv_seq.ring, "data")[0]


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

    The new latent goes into the block that holds each row's position
    (the whole cache, without ``tp.kv_seq``), and each coordinate's heads
    attend each block apart (:func:`_latent_block_attend`). With the
    sequence over ``data`` the blocks combine (:func:`_latent_combine`)
    after ``wuv`` (which is linear) and before ``wo``: (B, 1, H',
    v_head_dim) a block rather than the latent sum's (B, 1, H',
    kv_lora_rank).
    """
    m: MLAConfig = cfg.mla
    h, e = cfg.num_heads, m.nope_head_dim + m.v_head_dim
    pos = cache.length  # (B,)
    dt = x.dtype
    split = tp.splits(h)
    coords = tp.owners(split)
    ranks = _mla_ranks(p, x, cfg, pos[:, None], tp, coords)
    new = (ranks[0][2][:, 0], ranks[0][3][:, 0, 0, :])
    held = []  # (the block's first position, ckv, k_rope) after the write
    for d, ckv_d, kr_d in _latent_blocks(cache, tp):
        k0 = d * ckv_d.shape[1]
        _write_rows(pos - k0 if k0 else pos, (ckv_d, new[0]), (kr_d, new[1]))
        held.append((k0, ckv_d.to(dt), kr_d.to(dt)))
    parts = []
    for c, (q_nope, q_rope, _, _) in zip(coords, ranks):
        n = q_nope.shape[2]
        wukv = _heads_block(tp, p["wukv"], 1, c, h, e).reshape(m.kv_lora_rank, n, e)
        wuk = wukv[..., :m.nope_head_dim].to(dt)  # (r, h, nope)
        wuv = wukv[..., m.nope_head_dim:].to(dt)  # (r, h, v)
        q_lat = torch.einsum("bshe,rhe->bshr", q_nope, wuk)  # the absorbed query
        runs = [_latent_block_attend(q_lat, q_rope, wuv, ckv_d, kr_d, k0, pos, cfg) for k0, ckv_d, kr_d in held]
        o = _latent_combine(runs, tp) if tp.kv_seq is not None else runs[0][0]
        parts.append(_out(p, o.to(dt), c, cfg, tp, m.v_head_dim))
    return tp.reduce(parts, "partial" if split else "whole"), MLACache(cache.ckv, cache.k_rope, pos + 1)
