"""The decoder block, dense or MoE, with GQA or MLA attention (and
whisper's cross-attention over the encoder's states), whisper's encoder
block, and the hymba (parallel attention + Mamba heads) and xLSTM (mLSTM
+ sLSTM pair) blocks with their states, ported from
``repro.models.blocks``.

``is_global`` is a Python ``bool`` per layer (``Group.flags``), where the
reference traces a flag through ``lax.cond``: gemma2's alternation of
sliding-window and global layers. ``apply_decoder_block`` returns ``(x,
aux)``, aux the MoE router's load-balance loss (0 for a dense FFN).
Decode and prefill take one layer's cache (``KVCache`` or ``MLACache``,
views into the model's stacked cache) and write it in place; the hymba
and xLSTM blocks take one layer's state tree (``HymbaState``,
``XLSTMPairState``, ``ssm.MLSTMBlockState``) and return the new one
(the KV cache and the mLSTM cell written in place, the rest fresh).

The cross-attention (``cross=True``: ``cross`` an attention tree,
``lnc`` its pre-norm) reads K / V that :func:`cross_kv_proj` computes
once from the encoder's output (``Model.prefill`` keeps them in
``state["cross"]``, in the model's dtype): q from ``cross.wq``, a
non-causal attention, ``out_proj``.

Over a mesh (``tp``, ``common.TP``) the attention and the dense FFN are
tensor-parallel and the norms and residuals run on the activations as
they lie: replicated, or under Megatron sequence parallelism
(``Model.hidden``) on each rank's sequence block (their scales through
``TP.norm``, so a rank's rows add their share of the scales' gradients
over processes). The cross-attention
splits as the self-attention's heads partition: ``wq`` column blocks of
whole heads, ``wo`` a row block and one psum, its K / V the rank's KV
heads (a rank holds those of ``state["cross"]`` on a
``ProcessGroupMesh``). The SSM blocks take ``tp`` into their mixers
(``models.ssm``); their activations stay replicated between the layers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, moe, ssm
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


def init_decoder_block(generator: torch.Generator, cfg: ModelConfig, device, *, use_moe: bool = False,
                       cross: bool = False):
    """With ``use_moe`` the experts are ``common.Deferred`` draws
    (``moe.init_moe``), which ``Model.init`` fills in place; ``cross``
    adds the cross-attention's ``cross`` and ``lnc``."""
    if cfg.mla is not None:
        pa, sa = attn.init_mla(generator, cfg, device)
    else:
        pa, sa = attn.init_attention(generator, cfg, device)
    p = {"attn": pa, "ln1": init_n(cfg, device)[0]}
    s = {"attn": sa, "ln1": init_n(cfg, device)[1]}
    if cross:
        p["cross"], s["cross"] = attn.init_attention(generator, cfg, device)
        p["lnc"], s["lnc"] = init_n(cfg, device)
    if use_moe:
        p["ffn"], s["ffn"] = moe.init_moe(generator, cfg, device)
    else:
        p["ffn"], s["ffn"] = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
    p["ln2"], s["ln2"] = init_n(cfg, device)
    if cfg.post_norm:
        p["ln1p"], s["ln1p"] = init_n(cfg, device)
        p["ln2p"], s["ln2p"] = init_n(cfg, device)
    return p, s


def _ffn(p: Params, x: common.Acts, cfg: ModelConfig, use_moe: bool, tp: common.TP):
    """(x + the FFN's output, the router's aux loss or None for a dense
    FFN: decode and prefill drop it, so they make no zero for it). A MoE
    FFN runs on the whole sequence (gathered from sequence blocks, and
    its output cut back to them): its experts keep their own placement."""
    h2 = tp.norm(p["ln2"], x, cfg.norm_kind)
    if use_moe:
        f, aux = moe.apply_moe(p["ffn"], tp.whole(h2), cfg, mesh=tp.mesh, tp=tp.with_seq(False))
        if tp.seq:
            f = tp.scatter_seq(f)
    else:
        f, aux = mlp.apply_mlp(p["ffn"], h2, cfg.mlp_kind, tp, cfg.d_ff), None
    return _residual(p.get("ln2p"), x, f, cfg, tp), aux


def _residual(post, x: common.Acts, a: common.Acts, cfg: ModelConfig, tp: common.TP) -> common.Acts:
    return tp.each(lambda xi, ai: xi + ai, x, tp.norm(post if cfg.post_norm else None, a, cfg.norm_kind))


class CrossKV(NamedTuple):
    k: torch.Tensor  # (B, S_enc, KVH, D): every KV head, or the rank's on a ProcessGroupMesh
    v: torch.Tensor


def cross_kv_proj(p: Params, enc_out: torch.Tensor, cfg: ModelConfig, tp: common.TP = common.SINGLE) -> CrossKV:
    """The cross-attention's K / V of the encoder's states (B, S_enc, d),
    once a sequence, in their dtype: each coordinate's KV heads, side by
    side (every head on a ``SimMesh``, the rank's on a
    ``ProcessGroupMesh``)."""
    c_, kvh, hd = p["cross"], cfg.num_kv_heads, cfg.head_dim_
    split = tp.splits(kvh)
    coords = tp.owners(split)
    kv = tp.col(enc_out, lambda c: [attn._heads_block(tp, c_[n], -1, c, kvh, hd) for n in ("wk", "wv")], coords,
                split=split)
    b, s = enc_out.shape[:2]
    k, v = (torch.cat([pair[i] for pair in kv], -1) if len(kv) > 1 else kv[0][i] for i in (0, 1))
    return CrossKV(k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd))


def _cross(p: Params, x: common.Acts, cfg: ModelConfig, cross_kv: CrossKV, impl: str, tp: common.TP) -> common.Acts:
    """x + the cross-attention sublayer: ``lnc``, q from ``cross.wq``, a
    non-causal attention over ``cross_kv``, ``out_proj``."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    pc = p["cross"]
    hc = tp.norm(p["lnc"], x, cfg.norm_kind)
    split = tp.splits(h)
    rs = split or tp.seq  # the products differ by rank
    coords = tp.owners(split)
    qs = tp.col(hc, lambda c: [attn._heads_block(tp, pc["wq"], -1, c, h, hd, vary=rs)], coords, split=split)

    def kv(t, c):  # the rank's own KV heads, or all of them: the same on every rank
        return attn._kv_for(tp.block(t, 2, c, kvh) if tp.splits(kvh) else tp.vary(t, rs, c), c, cfg, tp)

    parts = []
    for c, (q,) in zip(coords, qs):
        q = q.reshape(q.shape[0], q.shape[1], -1, hd)
        o = attn.attention(q, kv(cross_kv.k, c), kv(cross_kv.v, c), AttnSpec(causal=False), impl=impl)
        parts.append(attn._out(pc, o, c, cfg, tp, hd, vary=rs))
    return tp.each(lambda xi, ai: xi + ai, x, tp.reduce(parts, "partial" if split else "whole"))


def apply_decoder_block(
    p: Params,
    x: common.Acts,
    cfg: ModelConfig,
    *,
    is_global: bool,
    use_moe: bool = False,
    impl: str = "chunked",
    tp: common.TP = common.SINGLE,
    cross_kv: Optional[CrossKV] = None,
) -> Tuple[common.Acts, torch.Tensor]:
    """``x`` in ``tp``'s layout (sequence blocks under Megatron sequence
    parallelism), positions 0..S-1."""
    h = tp.norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    if cfg.mla is not None:
        a = attn.apply_mla(p["attn"], h, cfg, spec, impl=impl, tp=tp)
    else:
        a = attn.apply_attention(p["attn"], h, cfg, spec, impl=impl, tp=tp)
    x = _residual(p.get("ln1p"), x, a, cfg, tp)
    if cross_kv is not None:
        x = _cross(p, x, cfg, cross_kv, impl, tp)
    x, aux = _ffn(p, x, cfg, use_moe, tp)
    dev = (x if isinstance(x, torch.Tensor) else x[0]).device
    return x, torch.zeros((), device=dev) if aux is None else aux


def init_block_cache(cfg: ModelConfig, b: int, s_max: int, dtype=torch.bfloat16, device=None,
                     tp: common.TP = common.SINGLE) -> Cache:
    """One layer's cache: this process's block of it
    (``attention.cache_block``, ``attention.mla_cache_block``)."""
    if cfg.mla is not None:
        return attn.init_mla_cache(b, s_max, cfg.mla, dtype, device, tp)
    return attn.init_kv_cache(*attn.cache_block(cfg, tp, b, s_max), dtype, device)


def decode_decoder_block(
    p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Cache, *, is_global: bool, use_moe: bool = False,
    tp: common.TP = common.SINGLE, cross_kv: Optional[CrossKV] = None,
) -> Tuple[torch.Tensor, Cache]:
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    decode = attn.decode_mla if cfg.mla is not None else attn.decode_attention
    a, new_cache = decode(p["attn"], h, cache, cfg, spec, tp=tp)
    x = x + _maybe_post(p.get("ln1p"), a, cfg)
    if cross_kv is not None:
        x = _cross(p, x, cfg, cross_kv, "chunked", tp)
    return _ffn(p, x, cfg, use_moe, tp)[0], new_cache


def prefill_decoder_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Cache,
    *,
    is_global: bool,
    use_moe: bool = False,
    impl: str = "chunked",
    tp: common.TP = common.SINGLE,
    cross_kv: Optional[CrossKV] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also fills the layer's cache."""
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    prefill = attn.prefill_mla if cfg.mla is not None else attn.prefill_attention
    a, new_cache = prefill(p["attn"], h, cache, cfg, spec, impl=impl, tp=tp)
    x = x + _maybe_post(p.get("ln1p"), a, cfg)
    if cross_kv is not None:
        x = _cross(p, x, cfg, cross_kv, impl, tp)
    return _ffn(p, x, cfg, use_moe, tp)[0], new_cache


# ---------------------------------------------------------------------------
# encoder block (whisper)
# ---------------------------------------------------------------------------


def init_encoder_block(generator: torch.Generator, cfg: ModelConfig, device):
    pa, sa = attn.init_attention(generator, cfg, device)
    pm, sm = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
    p = {"attn": pa, "ffn": pm, "ln1": init_n(cfg, device)[0], "ln2": init_n(cfg, device)[0]}
    s = {"attn": sa, "ffn": sm, "ln1": init_n(cfg, device)[1], "ln2": init_n(cfg, device)[1]}
    return p, s


def apply_encoder_block(p: Params, x: common.Acts, cfg: ModelConfig, *, impl: str = "chunked",
                        tp: common.TP = common.SINGLE) -> common.Acts:
    """Pre-norm: bidirectional self-attention, then the MLP."""
    h = tp.norm(p["ln1"], x, cfg.norm_kind)
    x = tp.each(lambda xi, ai: xi + ai, x, attn.apply_attention(p["attn"], h, cfg, AttnSpec(causal=False),
                                                                impl=impl, tp=tp))
    h2 = tp.norm(p["ln2"], x, cfg.norm_kind)
    return tp.each(lambda xi, fi: xi + fi, x, mlp.apply_mlp(p["ffn"], h2, cfg.mlp_kind, tp, cfg.d_ff))


# ---------------------------------------------------------------------------
# hymba block: parallel attention + mamba heads
# ---------------------------------------------------------------------------


class HymbaState(NamedTuple):
    kv: KVCache
    mamba: ssm.MambaState


def init_hymba_block(generator: torch.Generator, cfg: ModelConfig, device):
    pa, sa = attn.init_attention(generator, cfg, device)
    pm, sm = ssm.init_mamba(generator, cfg, device)
    pf, sf = mlp.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
    p = {"attn": pa, "mamba": pm, "ffn": pf}
    s = {"attn": sa, "mamba": sm, "ffn": sf}
    for name in ("ln1", "ln2", "na", "nm"):
        p[name], s[name] = init_n(cfg, device)
    for name in ("beta_a", "beta_m"):
        p[name], s[name] = torch.ones((cfg.d_model,), device=device), (None,)
    return p, s


def _hymba_rest(p, x, a, mo, cfg: ModelConfig, tp: common.TP):
    """x + the two heads' normalized, beta-weighted mean, then the FFN."""
    dt = x.dtype
    mix = 0.5 * (common.apply_norm(p["na"], a, cfg.norm_kind) * p["beta_a"].to(dt)
                 + common.apply_norm(p["nm"], mo, cfg.norm_kind) * p["beta_m"].to(dt))
    x = x + mix
    h2 = common.apply_norm(p["ln2"], x, cfg.norm_kind)
    return x + mlp.apply_mlp(p["ffn"], h2, cfg.mlp_kind, tp, cfg.d_ff)


def apply_hymba_block(p, x, cfg: ModelConfig, *, is_global: bool, impl: str = "chunked",
                      state: Optional[HymbaState] = None, tp: common.TP = common.SINGLE):
    """Returns (x, the Mamba head's new state, or None without ``state``);
    the positions are 0..S-1, meta tokens included."""
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    a = attn.apply_attention(p["attn"], h, cfg, _attn_spec(cfg, is_global=is_global), impl=impl, tp=tp)
    mo, mstate = ssm.apply_mamba(p["mamba"], h, cfg, state.mamba if state is not None else None, tp)
    return _hymba_rest(p, x, a, mo, cfg, tp), mstate


def prefill_hymba_block(p, x, cfg: ModelConfig, state: HymbaState, *, is_global: bool, impl: str = "chunked",
                        tp: common.TP = common.SINGLE):
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    spec = _attn_spec(cfg, is_global=is_global)
    a, kv = attn.prefill_attention(p["attn"], h, state.kv, cfg, spec, impl=impl, tp=tp)
    mo, mstate = ssm.apply_mamba(p["mamba"], h, cfg, state.mamba, tp)
    return _hymba_rest(p, x, a, mo, cfg, tp), HymbaState(kv, mstate)


def decode_hymba_block(p, x, cfg: ModelConfig, state: HymbaState, *, is_global: bool,
                       tp: common.TP = common.SINGLE):
    h = common.apply_norm(p["ln1"], x, cfg.norm_kind)
    a, kv = attn.decode_attention(p["attn"], h, state.kv, cfg, _attn_spec(cfg, is_global=is_global), tp=tp)
    mo, mstate = ssm.decode_mamba(p["mamba"], h, cfg, state.mamba, tp)
    return _hymba_rest(p, x, a, mo, cfg, tp), HymbaState(kv, mstate)


# ---------------------------------------------------------------------------
# xlstm pair block (mLSTM + sLSTM), and the mLSTM-only layer
# ---------------------------------------------------------------------------


class XLSTMPairState(NamedTuple):
    m: ssm.MLSTMBlockState
    s: ssm.SLSTMState


def init_xlstm_pair(generator: torch.Generator, cfg: ModelConfig, device):
    pm, sm = ssm.init_mlstm_block(generator, cfg, device)
    ps, ss_ = ssm.init_slstm_block(generator, cfg, device)
    p = {"m": pm, "s": ps, "lnm": init_n(cfg, device)[0], "lns": init_n(cfg, device)[0]}
    s = {"m": sm, "s": ss_, "lnm": init_n(cfg, device)[1], "lns": init_n(cfg, device)[1]}
    return p, s


def apply_xlstm_pair(p, x, cfg: ModelConfig, state: Optional[XLSTMPairState] = None,
                     tp: common.TP = common.SINGLE):
    hm = common.apply_norm(p["lnm"], x, cfg.norm_kind)
    om, ms = ssm.apply_mlstm_block(p["m"], hm, cfg, state.m if state is not None else None, tp)
    x = x + om
    hs = common.apply_norm(p["lns"], x, cfg.norm_kind)
    os_, ss_ = ssm.apply_slstm_block(p["s"], hs, cfg, state.s if state is not None else None, tp)
    x = x + os_
    return x, (XLSTMPairState(ms, ss_) if state is not None else None)


def decode_xlstm_pair(p, x, cfg: ModelConfig, state: XLSTMPairState, tp: common.TP = common.SINGLE):
    hm = common.apply_norm(p["lnm"], x, cfg.norm_kind)
    om, ms = ssm.decode_mlstm_block(p["m"], hm, cfg, state.m, tp)
    x = x + om
    hs = common.apply_norm(p["lns"], x, cfg.norm_kind)
    os_, ss_ = ssm.decode_slstm_block(p["s"], hs, cfg, state.s, tp)
    return x + os_, XLSTMPairState(ms, ss_)


def init_xlstm_m(generator: torch.Generator, cfg: ModelConfig, device):
    """An mLSTM-only layer (xLSTM with ``slstm_every=0``)."""
    p, s = ssm.init_mlstm_block(generator, cfg, device)
    pn, sn = init_n(cfg, device)
    return {"m": p, "lnm": pn}, {"m": s, "lnm": sn}


def apply_xlstm_m(p, x, cfg: ModelConfig, state: Optional[ssm.MLSTMBlockState] = None,
                  tp: common.TP = common.SINGLE):
    o, st = ssm.apply_mlstm_block(p["m"], common.apply_norm(p["lnm"], x, cfg.norm_kind), cfg, state, tp)
    return x + o, st


def decode_xlstm_m(p, x, cfg: ModelConfig, state: ssm.MLSTMBlockState, tp: common.TP = common.SINGLE):
    o, st = ssm.decode_mlstm_block(p["m"], common.apply_norm(p["lnm"], x, cfg.norm_kind), cfg, state, tp)
    return x + o, st
