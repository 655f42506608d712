"""Recurrent sequence mixers, ported from ``repro.models.ssm``: xLSTM's
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory,
sequential), and the Mamba selective SSM of hymba's parallel heads --
their forward and decode (the serving path), on one rank or over a mesh.

mLSTM chunkwise form (intra-chunk work is matmuls, inter-chunk a short
loop over the carried state):

    weight(s->t) = exp(g_t + b_s),  g = cumsum(logsigmoid(f~)),  b = i~ - g
    h_t ~ alpha_t (q_t . C_prev) + sum_{s<=t} exp(b_s - M_t) (q_t.k_s) v_s

with M_t = max(m_prev, cummax b), alpha_t = exp(m_prev - M_t); the carried
(C, n) are stored pre-scaled by exp(-m) for stability.

Where the reference scans with ``lax.scan`` the port loops in Python (over
chunks, or over time for the sLSTM); Mamba's ``lax.associative_scan`` of
the linear recurrence h_t = d_t h_{t-1} + i_t is :func:`linear_scan`, a
log-depth doubling scan. Numerics follow the reference's: ``k / sqrt(dk)``
in the compute dtype, gates and recurrences in float32, the sentinels the
finite values -+1e30, the states float32 (a conv state enters the conv in
the activations' dtype).

Every mixer has a full-sequence entry point (state in and out when given)
and a decode step. The mLSTM decode step can update its (C, n, m) in
place (``inplace=True``, which ``decode_mlstm_block`` uses), in the
reference's order of operations: bitwise the out-of-place form. Mamba's
selective scan carries the reference's manual backward
(:class:`_MambaCore`, a ``torch.autograd.Function``).

Over a mesh (``tp``, ``common.TP`` over the ``model`` axis), each leaf
placed by the reference's specs (``core.sharding.placement``) but where
``MESH_LAYOUT`` says otherwise, the channel dims split where the axis
divides them:

- **Mamba** (the reference's channel constraint, ``ssm.py:622-630``):
  ``win`` ``("fsdp", "mlp")`` packs ``[x | z]``, so a rank holds each
  half's channel block (``MESH_LAYOUT``), the same channels as its blocks of
  ``conv``, ``a_log``, ``dskip``, ``dt_bias`` and its (B, di/P, N) state
  and (B, W-1, di/P) conv window; ``wbc`` and ``wdt`` are row blocks
  (partial sums over the rank's channels, one psum, then each rank's
  channels of dt); the scan is local to the rank's channels over the
  whole sequence; ``wout`` a row block, one psum. In training over
  processes ``bc`` and ``dt`` enter the rank's channels through
  ``TP.vary`` (their gradients summed over the ranks).
- **mLSTM**, by heads: ``wup`` packs ``[x | z]`` (``MESH_LAYOUT``),
  ``conv`` and the conv window by channel; the rank's conv output and x
  are gathered whole, and ``wq`` / ``wk`` / ``wv`` / ``wif`` are placed
  by whole heads (columns; ``wif`` as ``[i | f]`` halves), not by the
  rows their ``("mlp", None)`` specs give: a row split would need the
  whole cell on every rank (its q / k / v / gates partial sums, one
  psum), where by heads each rank holds its heads' (C, n, m) -- a
  quarter at P = 4 (xLSTM-1.3B's 4 heads) -- and no partial sum reaches
  a gate's ``exp``. Each rank runs the cell on its heads, group-norms them,
  gates its channels (its heads' channels are its ``z`` channels) and
  multiplies its ``wdown`` row block, one psum. Where the axis does not
  divide the heads the cell runs whole (once a process on a
  ``SimMesh``).
- **sLSTM** (the reference's ``shard_map`` island, ``ssm.py:355-372``:
  the time loop local, replicated over ``model``): ``wx``'s columns are
  per-head interleaved (``(hh, 4, dh)``: z, i, f, o of each head side
  by side), so a column block is whole heads' four gates; each rank's
  block of the pre-activations is gathered, and the loop runs on the
  whole, once a process (every rank on a ``ProcessGroupMesh``). Its
  gated FFN packs ``wup`` as ``[gelu | linear]`` halves of ``dff``
  (``MESH_LAYOUT``), ``wdown`` row blocks, one psum -- where the axis divides
  ``dff`` (xLSTM-1.3B's 2730 is whole at 4).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import common
from repro_torch.models.common import Params, Specs

#: the finite sentinels of the reference (not infinities)
BIG = 1e30

#: the mLSTM block's causal conv width, fixed whatever ``ssm.conv_dim`` says
MLSTM_CONV = 4

#: where a leaf of these blocks is placed over a mesh other than its spec
#: says, by its last two keys: (the spec to place it by, None for its own;
#: the equal parts its split dim packs side by side -- a rank's block is
#: each part's block, ``core.sharding.block(parts=)``). ``[x | z]`` of
#: Mamba and the mLSTM and the sLSTM FFN's ``[gelu | linear]`` halves; the
#: mLSTM's q / k / v and gate weights by whole heads (columns; the gates
#: ``[i | f]``), where the reference's ``("mlp", None)`` splits rows
MESH_LAYOUT = {
    "mamba/win": (None, 2),
    "m/wup": (None, 2),
    "s/wup": (None, 2),
    "m/wq": (("fsdp", "heads"), 1),
    "m/wk": (("fsdp", "heads"), 1),
    "m/wv": (("fsdp", "heads"), 1),
    "m/wif": (("fsdp", "heads"), 2),
}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dk, dv) scaled by exp(-m)
    n: torch.Tensor  # (B, H, dk)
    m: torch.Tensor  # (B, H)


def init_mlstm_state(b: int, h: int, dk: int, dv: int, dtype=torch.float32, device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((b, h, dk, dv), dtype=dtype, device=device),
        n=torch.zeros((b, h, dk), dtype=dtype, device=device),
        m=torch.full((b, h), -BIG, dtype=dtype, device=device),
    )


def mlstm_chunkwise(
    q: torch.Tensor,  # (B, H, S, dk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, S, dv)
    i_pre: torch.Tensor,  # (B, H, S) input-gate pre-activations
    f_pre: torch.Tensor,  # (B, H, S) forget-gate pre-activations
    state: Optional[MLSTMState] = None,
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, MLSTMState]:
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    k = k / math.sqrt(dk)
    chunk = min(chunk, s)
    orig_s = s
    if s % chunk:
        # pad with identity steps: i~ = -1e30 (no write), f~ = +1e30 (no decay)
        pad = chunk - s % chunk
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        i_pre = F.pad(i_pre, (0, pad), value=-BIG)
        f_pre = F.pad(f_pre, (0, pad), value=BIG)
        s = s + pad
    if state is None:
        state = init_mlstm_state(b, h, dk, dv, device=q.device)
    c_prev, n_prev, m_prev = state
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    outs = []
    run, skipped = common.trips("mlstm", s // chunk, q)
    for j in run:
        if skipped and j == run[-1]:
            outs += common.stand_ins(outs[-1], skipped)
        start = j * chunk
        at = slice(start, start + chunk)
        qf, kf, vf = (a[:, :, at].float() for a in (q, k, v))
        ic, fc = i_pre[:, :, at].float(), f_pre[:, :, at].float()
        logf = F.logsigmoid(fc)  # (B,H,L)
        g = torch.cumsum(logf, dim=-1)  # inclusive
        bvec = ic - g
        mloc = torch.cummax(bvec, dim=-1).values
        m_t = torch.maximum(m_prev[..., None], mloc)  # (B,H,L) = M_t
        alpha = torch.exp(m_prev[..., None] - m_t)

        scores = qf @ kf.transpose(-1, -2)  # (B,H,L,L)
        dmat = torch.exp(bvec[:, :, None, :] - m_t[..., None])  # w[t,s]
        w = torch.where(tri, scores * dmat, 0.0)
        inter_h = (qf @ c_prev) * alpha[..., None]
        inter_n = (qf @ n_prev[..., None])[..., 0] * alpha
        num = w @ vf + inter_h  # (B,H,L,dv)
        den = w.sum(-1) + inter_n  # (B,H,L)
        m_total = g + m_t  # true log-scale at t
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_total))[..., None])

        # chunk-end state
        g_l = g[..., -1:]  # (B,H,1)
        m_new = torch.maximum(m_prev + g_l[..., 0], (g_l + bvec).amax(-1))
        sc = torch.exp(g_l + bvec - m_new[..., None])  # (B,H,L)
        decay = torch.exp(m_prev + g_l[..., 0] - m_new)
        c_prev = decay[..., None, None] * c_prev + (kf * sc[..., None]).transpose(-1, -2) @ vf
        n_prev = decay[..., None] * n_prev + (sc[..., None, :] @ kf)[..., 0, :]
        m_prev = m_new
    out = torch.cat(outs, dim=2)[:, :, :orig_s]
    return out.to(q.dtype), MLSTMState(c_prev, n_prev, m_prev)


def mlstm_decode_step(
    q: torch.Tensor,  # (B, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, dv)
    i_pre: torch.Tensor,  # (B, H)
    f_pre: torch.Tensor,
    state: MLSTMState,
    *,
    inplace: bool = False,
) -> Tuple[torch.Tensor, MLSTMState]:
    """One step. ``inplace``: ``state``'s tensors take the new state
    (C <- fw C + iw (k v^T), n likewise, m <- m_new) and are returned."""
    dk = q.shape[-1]
    k = k / math.sqrt(dk)
    logf = F.logsigmoid(f_pre.float())
    lm = logf + state.m
    m_new = torch.maximum(lm, i_pre.float())
    fw = torch.exp(lm - m_new)
    iw = torch.exp(i_pre - m_new)
    kf, vf, qf = (a.float() for a in (k, v, q))
    write = iw[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    if inplace:
        c = state.c.mul_(fw[..., None, None]).add_(write)
        n = state.n.mul_(fw[..., None]).add_(iw[..., None] * kf)
        m = state.m.copy_(m_new)
    else:
        c = fw[..., None, None] * state.c + write
        n = fw[..., None] * state.n + iw[..., None] * kf
        m = m_new
    num = (qf[..., None, :] @ c)[..., 0, :]
    den = (qf * n).sum(-1)
    hout = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return hout.to(q.dtype), MLSTMState(c, n, m)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def _dense(generator, device):
    return lambda shape: common.dense_init(shape, generator=generator, device=device)


def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig, device) -> Tuple[Params, Specs]:
    d = cfg.d_model
    sc: SSMConfig = cfg.ssm
    di = int(sc.expand * d)
    h = cfg.num_heads
    w = _dense(generator, device)
    gn, gn_spec = common.init_groupnorm(h, di, device)
    p = {
        "wup": w((d, 2 * di)),
        "conv": w((MLSTM_CONV, di)),  # causal depthwise
        "wq": w((di, di)),
        "wk": w((di, di)),
        "wv": w((di, di)),
        "wif": w((di, 2 * h)),
        "gn": gn,
        "wdown": w((di, d)),
    }
    s = {
        "wup": ("fsdp", "mlp"),
        "conv": (None, "mlp"),
        "wq": ("mlp", None),
        "wk": ("mlp", None),
        "wv": ("mlp", None),
        "wif": ("mlp", None),
        "gn": gn_spec,
        "wdown": ("mlp", "fsdp"),
    }
    return p, s


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S. x: (B,S,D), w: (W,D).
    Returns (out, new_state) with state = last W-1 inputs (x's dtype)."""
    wlen = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], wlen - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(wlen))
    new_state = xp[:, -(wlen - 1):] if wlen > 1 else torch.zeros_like(pad)
    return out, new_state


class MLSTMBlockState(NamedTuple):
    cell: MLSTMState
    conv: torch.Tensor  # (B, W-1, di)


def _channels(tp: common.TP, di: int) -> Tuple[bool, List[int], int]:
    """(whether ``tp`` splits the ``di`` channels, the coordinates this
    process computes, each one's channel count)."""
    split = tp.splits(di)
    return split, tp.owners(split), di // tp.p if split else di


def _joined(blocks: List[torch.Tensor], dim: int) -> torch.Tensor:
    """The coordinates' blocks of a state leaf side by side (one: itself)."""
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim)


def _own(a: torch.Tensor, c: int, split: bool, m: int) -> torch.Tensor:
    """Coordinate ``c``'s ``m`` channels (the last dim) of a whole ``a``;
    all of them where the channels are not split."""
    return a.narrow(-1, c * m, m) if split else a


def _mlstm_in(p, x, cfg, conv_state, tp: common.TP):
    """(q, k, v, i~, f~ of each head coordinate, the new conv state, each
    channel coordinate's channels of the output gate's input z). Each
    channel coordinate's block of ``[x | z]`` (``wup``'s parts) and of the
    causal conv, gathered whole; each head coordinate's q / k / v and
    gates from its heads' columns of ``wq`` / ``wk`` / ``wv`` / ``wif``,
    over every channel (no partial sums: the gates enter ``exp``)."""
    dt, h = x.dtype, cfg.num_heads
    b, s_len, d = x.shape
    di = int(cfg.ssm.expand * d)
    dh = di // h
    split, coords, _ = _channels(tp, di)
    ups = tp.col(x, lambda c: tp.parts(p["wup"], 1, c, 2 * di, 2), coords, split=split)
    xcs, convs = [], []
    for c, (xm, _) in zip(coords, ups):
        xc, conv_new = _causal_conv(xm, tp.block(p["conv"], 1, c, di),
                                    None if conv_state is None else tp.block(conv_state, 2, c, di))
        xcs.append(common.silu(xc))
        convs.append(conv_new)
    xc, xm = (tp.gather(t, -1) if split else t[0] for t in (xcs, [xm for xm, _ in ups]))

    def to_heads(a):
        return a.reshape(b, s_len, -1, dh).transpose(1, 2)

    by_heads = tp.splits(h)
    xc, xm = tp.vary(xc, by_heads), tp.vary(xm, by_heads)  # the same on every rank, into the rank's heads
    heads = []
    for c in tp.owners(by_heads):
        cols = [tp.block(p[n], 1, c, di, h) for n in ("wq", "wk", "wv")]  # the coordinate's whole heads
        gates = xc.float() @ torch.cat(tp.parts(p["wif"], 1, c, 2 * h, 2), -1).float()
        i_pre, f_pre = gates.chunk(2, -1)  # (B,S,H')
        heads.append((c, to_heads(xc @ cols[0].to(dt)), to_heads(xc @ cols[1].to(dt)), to_heads(xm @ cols[2].to(dt)),
                      i_pre.transpose(1, 2), f_pre.transpose(1, 2)))
    return heads, _joined(convs, 2), list(zip(coords, (z for _, z in ups)))


def _cell_heads(tp: common.TP, cell: Optional[MLSTMState], c: int, h: int) -> Optional[MLSTMState]:
    """Coordinate ``c``'s heads of a (B, H, ...) mLSTM state."""
    return None if cell is None else MLSTMState(*(tp.block(t, 1, c, h) for t in cell))


def _mlstm_out(p, houts, zs, h, tp: common.TP):
    """Each head coordinate's hout (B, S, H', dh) through the group norm of
    its heads, each channel coordinate's gate channels and ``wdown`` row
    block, one psum."""
    di = p["gn"]["scale"].shape[-1]
    split, _, m = _channels(tp, di)
    by_heads = tp.splits(h)
    ys = {}
    for c, hout in houts:  # the norm's scale is whole: a rank's heads take their channels of it
        scale = {"scale": _own(tp.vary(p["gn"]["scale"], by_heads, c), c, by_heads, m)}
        ys[c] = common.apply_groupnorm(scale, hout, hout.shape[-2])
    parts = []
    for c, z in zs:
        y = ys[c] if by_heads else _own(tp.vary(next(iter(ys.values())), split, c), c, split, m)
        parts.append((y * common.silu(z)) @ tp.block(p["wdown"], 0, c, di).to(y.dtype))
    return tp.reduce(parts, "partial" if split else "whole")


def apply_mlstm_block(
    p: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[MLSTMBlockState] = None,
    tp: common.TP = common.SINGLE,
) -> Tuple[torch.Tensor, Optional[MLSTMBlockState]]:
    """Full-sequence mLSTM block (pre-norm residual handled by caller).
    x: (B, S, d). If ``state`` given, runs statefully and returns new state."""
    s_len, h = x.shape[1], cfg.num_heads
    heads, conv_state, zs = _mlstm_in(p, x, cfg, state.conv if state is not None else None, tp)
    houts, cells = [], []
    for c, q, k, v, i_pre, f_pre in heads:
        cell0 = _cell_heads(tp, state.cell if state is not None else None, c, h)
        hout, cell = mlstm_chunkwise(q, k, v, i_pre, f_pre, cell0, chunk=min(cfg.ssm.chunk, s_len))
        houts.append((c, hout.transpose(1, 2)))
        cells.append(cell)
    out = _mlstm_out(p, houts, zs, h, tp)
    if state is None:
        return out, None
    return out, MLSTMBlockState(MLSTMState(*(_joined(list(t), 1) for t in zip(*cells))), conv_state)


def decode_mlstm_block(
    p: Params, x: torch.Tensor, cfg: ModelConfig, state: MLSTMBlockState, tp: common.TP = common.SINGLE,
) -> Tuple[torch.Tensor, MLSTMBlockState]:
    """Single-token step. x: (B, 1, d). ``state.cell`` is updated in place
    (each head coordinate's view of it)."""
    h = cfg.num_heads
    heads, conv_state, zs = _mlstm_in(p, x, cfg, state.conv, tp)
    houts = []
    for c, q, k, v, i_pre, f_pre in heads:
        hout, _ = mlstm_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], i_pre[:, :, 0], f_pre[:, :, 0],
                                    _cell_heads(tp, state.cell, c, h), inplace=True)
        houts.append((c, hout[:, None]))
    return _mlstm_out(p, houts, zs, h, tp), MLSTMBlockState(state.cell, conv_state)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM)
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    h: torch.Tensor  # (B, D)
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def init_slstm_state(b: int, d: int, device=None) -> SLSTMState:
    def z():
        return torch.zeros((b, d), device=device)

    return SLSTMState(z(), z(), z(), torch.full((b, d), -BIG, device=device))


def init_slstm_block(generator: torch.Generator, cfg: ModelConfig, device) -> Tuple[Params, Specs]:
    d = cfg.d_model
    sc: SSMConfig = cfg.ssm
    hh = sc.slstm_heads
    dh = d // hh
    dff = int(d * 4 / 3)
    w = _dense(generator, device)
    gn, gn_spec = common.init_groupnorm(hh, d, device)
    p = {
        "wx": w((d, 4 * d)),  # z,i,f,o pre-acts
        "r": w((hh, dh, 4 * dh)) / math.sqrt(dh),  # block-diag recurrent, fan-in hh
        "gn": gn,
        "wup": w((d, 2 * dff)),
        "wdown": w((dff, d)),
    }
    s = {
        "wx": ("fsdp", "mlp"),
        "r": (None, None, None),
        "gn": gn_spec,
        "wup": ("fsdp", "mlp"),
        "wdown": ("mlp", "fsdp"),
    }
    return p, s


def _slstm_cell(p, xg: torch.Tensor, st: SLSTMState, hh: int) -> Tuple[torch.Tensor, SLSTMState]:
    """One step. xg: (B, 4d) input pre-activations. The gates in the
    per-head interleaved layout (hh, 4, dh); the per-step op count is what
    a prompt's time goes to, so the recurrent product is one ``bmm`` and
    the updates ``addcmul`` s."""
    b, d4 = xg.shape
    d = d4 // 4
    dh = d // hh
    rec = torch.bmm(st.h.view(b, hh, dh).transpose(0, 1), p["r"].float())  # (hh, B, 4 dh)
    zt, it, ft, ot = (xg.view(b, hh, 4, dh) + rec.transpose(0, 1).view(b, hh, 4, dh)).unbind(2)

    def heads(a):
        return a.view(b, hh, dh)

    lm = F.logsigmoid(ft) + heads(st.m)
    m_new = torch.maximum(lm, it)
    fw = torch.exp(lm - m_new)
    iw = torch.exp(it - m_new)
    c = torch.addcmul(fw * heads(st.c), iw, torch.tanh(zt))
    n = torch.addcmul(iw, fw, heads(st.n))
    h = torch.sigmoid(ot) * c / torch.maximum(n.abs(), torch.exp(-m_new))
    h, c, n, m_new = (a.view(b, d) for a in (h, c, n, m_new))
    return h, SLSTMState(h, c, n, m_new)


def apply_slstm_block(
    p: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[SLSTMState] = None,
    tp: common.TP = common.SINGLE,
) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """The recurrence is a Python loop over the S time steps, on the whole
    pre-activations: each coordinate's column block of ``wx`` (whole
    heads' four gates where the axis divides the heads), gathered; the
    loop runs once a process, replicated over the ``model`` axis. The
    gated FFN after it is tensor-parallel over its ``dff`` (``wup``'s two
    parts, ``wdown``'s rows, one psum) where the axis divides it."""
    hh = cfg.ssm.slstm_heads
    b, s_len, d = x.shape
    keep_state = state is not None
    st = state if keep_state else init_slstm_state(b, d, x.device)
    split = tp.splits(4 * d)
    xg = [a for (a,) in tp.col(x.float(), lambda c: [tp.block(p["wx"], 1, c, 4 * d).float()], tp.owners(split),
                               split=split)]
    xg = tp.gather(xg, -1) if split else xg[0]
    cell = {"r": p["r"].float()}  # cast once, not per step
    hs = []
    steps = xg.unbind(1)
    run, skipped = common.trips("slstm", len(steps), xg)
    for t in run:
        if skipped and t == run[-1]:
            hs += common.stand_ins(hs[-1], skipped)
        h, st = _slstm_cell(cell, steps[t], st, hh)
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,d)
    hn = common.apply_groupnorm(p["gn"], hseq.reshape(b, s_len, hh, d // hh), hh)
    dff = int(d * 4 / 3)
    fsplit = tp.splits(dff)
    coords = tp.owners(fsplit)
    ups = tp.col(hn, lambda c: tp.parts(p["wup"], 1, c, 2 * dff, 2), coords, split=fsplit)
    outs = [(common.gelu(a) * u) @ tp.block(p["wdown"], 0, c, dff).to(x.dtype) for c, (a, u) in zip(coords, ups)]
    return tp.reduce(outs, "partial" if fsplit else "whole"), (st if keep_state else None)


def decode_slstm_block(p, x, cfg, state: SLSTMState, tp: common.TP = common.SINGLE):
    return apply_slstm_block(p, x, cfg, state, tp)


# ---------------------------------------------------------------------------
# Mamba (selective SSM) -- hymba's parallel head
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    h: torch.Tensor  # (B, di, N)
    conv: torch.Tensor  # (B, W-1, di)


def init_mamba_state(b: int, di: int, n: int, w: int, device=None) -> MambaState:
    return MambaState(h=torch.zeros((b, di, n), device=device), conv=torch.zeros((b, w - 1, di), device=device))


def init_mamba(generator: torch.Generator, cfg: ModelConfig, device) -> Tuple[Params, Specs]:
    d = cfg.d_model
    sc: SSMConfig = cfg.ssm
    di = int(sc.expand * d)
    n = sc.state_dim
    w = _dense(generator, device)
    p = {
        "win": w((d, 2 * di)),
        "conv": w((sc.conv_dim, di)),
        "wbc": w((di, 2 * n)),
        "wdt": w((di, di)) * 0.01,
        "dt_bias": torch.zeros((di,), device=device) + torch.log(torch.expm1(torch.tensor(0.01, device=device))),
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)).expand(di, n).clone(),
        "dskip": torch.ones((di,), device=device),
        "wout": w((di, d)),
    }
    s = {
        "win": ("fsdp", "mlp"),
        "conv": (None, "mlp"),
        "wbc": ("mlp", None),
        "wdt": ("mlp", "mlp"),
        "dt_bias": ("mlp",),
        "a_log": ("mlp", None),
        "dskip": ("mlp",),
        "wout": ("mlp", "fsdp"),
    }
    return p, s


def linear_scan(decay: torch.Tensor, inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan over axis 0 of the linear recurrence's combine
    (d1, i1), (d2, i2) -> (d1 d2, i1 d2 + i2) -- ``lax.associative_scan``
    of ``h_t = decay_t h_{t-1} + inc_t`` -- as a Hillis-Steele doubling
    scan: ceil(log2 L) steps, each combining every element with the one
    ``offset`` before it. Returns (cumulative decay, the h of h_{-1} = 0);
    at L = 1 (a decode step) the inputs themselves."""
    if decay.shape[0] == 1:
        return decay, inc
    d, i = decay.clone(), inc.clone()
    offset = 1
    while offset < d.shape[0]:
        # each right-hand side is whole before its write: a step reads only the last step's values
        i[offset:] = i[:-offset] * d[offset:] + i[offset:]
        d[offset:] = d[:-offset] * d[offset:]
        offset *= 2
    return d, i


def _chunk_fwd(decay, inc, h0):
    """Within-chunk scan. decay/inc: (L, B, d, N); h0: (B, d, N)."""
    dcum, icum = linear_scan(decay, inc)
    return dcum * h0[None] + icum


def _mamba_core_fwd_impl(xc, dt, bmat, cmat, a, dskip, h0, chunk: int):
    """Returns (y (B,S,d), h_last, the boundary states: a list of nc (B, d,
    N), h at each chunk's start -- what the reference's backward recomputes
    from; the forward alone keeps them unstacked)."""
    s = xc.shape[1]
    h, ys, bounds = h0, [], []
    run, skipped = common.trips("mamba", s // chunk, xc)
    for j in run:
        if skipped and j == run[-1]:
            ys += common.stand_ins(ys[-1], skipped)
            bounds += common.stand_ins(bounds[-1], skipped)
        start = j * chunk
        xci, dti, bi, ci = (v[:, start:start + chunk].transpose(0, 1) for v in (xc, dt, bmat, cmat))
        decay = torch.exp(dti[..., None] * a)  # (L,B,d,N)
        inc = (dti * xci)[..., None] * bi[:, :, None, :]
        hs = _chunk_fwd(decay, inc, h)
        ys.append((hs @ ci[..., None])[..., 0] + dskip * xci)
        bounds.append(h)
        h = hs[-1]
    y = torch.cat(ys, dim=0).transpose(0, 1)
    return y, h, bounds


def _mamba_core_bwd_impl(xc, dt, bmat, cmat, a, dskip, bounds, dy, dh_last, chunk: int):
    """The reference's manual backward: over the chunks in reverse, each
    chunk's forward recomputed from its boundary state, the reverse
    recurrence ``dh[t] = dhs_local[t] + decay[t+1] dh[t+1]`` as
    :func:`linear_scan` on the flipped time axis, ``da`` and ``dD``
    accumulated in float32; the cotangents cast to the primal dtypes."""
    s = xc.shape[1]
    af, dskf = a.float(), dskip.float()
    dh_carry = dh_last.float()
    da = torch.zeros(a.shape, dtype=torch.float32, device=xc.device)
    dD = torch.zeros(dskip.shape, dtype=torch.float32, device=xc.device)
    outs = []
    run, skipped = common.trips("mamba", s // chunk, xc)
    for ci in reversed(run):
        if skipped and ci == run[-2]:  # the skipped chunks lie between the last and the one before
            outs += list(zip(*(common.stand_ins(t, skipped) for t in outs[-1])))
        start = ci * chunk
        xci, dti, bi, cci, dyi = (v[:, start:start + chunk].transpose(0, 1).float()
                                  for v in (xc, dt, bmat, cmat, dy))
        h_in = bounds[ci]
        decay = torch.exp(dti[..., None] * af)  # (L,B,d,N)
        inc = (dti * xci)[..., None] * bi[:, :, None, :]
        hs = _chunk_fwd(decay, inc, h_in)
        h_prev = torch.cat([h_in[None], hs[:-1]], dim=0)  # h_{t-1}
        dhs_local = dyi[..., None] * cci[:, :, None, :]  # (L,B,d,N)
        dhs_local[-1] += dh_carry
        decay_next = torch.cat([decay[1:], torch.ones_like(decay[:1])], dim=0)
        dh = linear_scan(decay_next.flip(0), dhs_local.flip(0))[1].flip(0)
        d_dta = dh * h_prev * decay  # d/d(dt*a)
        da = da + torch.einsum("lbdn,lbd->dn", d_dta, dti)
        ddt_dec = torch.einsum("lbdn,dn->lbd", d_dta, af)
        ddtx = torch.einsum("lbdn,lbn->lbd", dh, bi)
        dbi = torch.einsum("lbdn,lbd->lbn", dh, dti * xci)
        dci = torch.einsum("lbdn,lbd->lbn", hs, dyi)
        dxci = ddtx * dti + dskf * dyi
        ddti = ddtx * xci + ddt_dec
        dD = dD + torch.einsum("lbd,lbd->d", dyi, xci)
        dh_carry = decay[0] * dh[0]  # into the previous chunk's last h
        outs.append((dxci, ddti, dbi, dci))

    def from_chunks(i, like):  # the chunks' (L, B, ...) in time order -> (B, S, ...)
        return torch.cat([o[i] for o in reversed(outs)], dim=0).transpose(0, 1).to(like.dtype)

    return (from_chunks(0, xc), from_chunks(1, dt), from_chunks(2, bmat), from_chunks(3, cmat),
            da.to(a.dtype), dD.to(dskip.dtype), dh_carry)


class _MambaCore(torch.autograd.Function):
    """The reference's ``_make_mamba_core`` custom VJP: the forward keeps
    the chunks' boundary states, the backward is
    :func:`_mamba_core_bwd_impl`. The forward runs without recording
    (:func:`linear_scan` writes into its clones in place)."""

    @staticmethod
    def forward(ctx, xc, dt, bmat, cmat, a, dskip, h0, chunk: int):
        y, h_last, bounds = _mamba_core_fwd_impl(xc, dt, bmat, cmat, a, dskip, h0, chunk)
        ctx.save_for_backward(xc, dt, bmat, cmat, a, dskip, *bounds)
        ctx.chunk = chunk
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        xc, dt, bmat, cmat, a, dskip, *bounds = ctx.saved_tensors
        grads = _mamba_core_bwd_impl(xc, dt, bmat, cmat, a, dskip, bounds, dy, dh_last, ctx.chunk)
        return (*grads, None)


def mamba_core(xc, dt, bmat, cmat, a, dskip, h0, *, chunk: int):
    """The selective scan y = SSM(xc; dt, B, C, A, D), with the
    reference's manual backward (:class:`_MambaCore`).
    xc/dt: (B, S, d) f32; bmat/cmat: (B, S, N); a: (d, N); h0: (B, d, N).
    S must be a multiple of ``chunk`` (caller pads). Returns (y, h_last)."""
    return _MambaCore.apply(xc, dt, bmat, cmat, a, dskip, h0, chunk)


def _mamba_scan_chunked(decay, inc, h0, chunk: int):
    """h_t = decay_t * h_{t-1} + inc_t, over axis 1 (time).

    decay/inc: (B, S, di, N). A loop over chunks, :func:`linear_scan`
    within each -- bounded memory at long S."""
    s = decay.shape[1]
    chunk = min(chunk, s)
    orig_s = s
    if s % chunk:  # pad with identity elements (decay=1, inc=0)
        pad = chunk - s % chunk
        decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
        inc = F.pad(inc, (0, 0, 0, 0, 0, pad))
        s = s + pad
    dr, ir = decay.transpose(0, 1), inc.transpose(0, 1)  # (S, B, di, N)
    h, hs = h0, []
    run, skipped = common.trips("mamba", s // chunk, dr)
    for j in run:
        if skipped and j == run[-1]:
            hs += common.stand_ins(hs[-1], skipped)
        start = j * chunk
        dcum, icum = linear_scan(dr[start:start + chunk], ir[start:start + chunk])
        hs.append(dcum * h[None] + icum)
        h = hs[-1][-1]
    return torch.cat(hs, dim=0).transpose(0, 1)[:, :orig_s], h


def apply_mamba(
    p: Params, x: torch.Tensor, cfg: ModelConfig, state: Optional[MambaState] = None,
    tp: common.TP = common.SINGLE,
) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """Over a ``model`` axis that divides ``d_inner`` each coordinate
    scans its channel block (the reference's channel constraint): its
    blocks of ``[x | z]`` (``win``'s parts), the conv, ``a_log``,
    ``dskip``, ``dt_bias`` and the state; ``bc = xc @ wbc`` and ``xc @
    wdt`` need every channel, so each coordinate's partial sums over its
    channels go through one psum and each keeps its channels of dt;
    ``wout`` is a row block, one more psum."""
    sc: SSMConfig = cfg.ssm
    b, s_len, d = x.shape
    di = int(sc.expand * d)
    n = sc.state_dim
    dt_ = x.dtype
    keep_state = state is not None
    split, coords, m = _channels(tp, di)
    ups = tp.col(x, lambda c: tp.parts(p["win"], 1, c, 2 * di, 2), coords, split=split)
    xcs, convs, sums = [], [], []
    for c, (xi, _) in zip(coords, ups):
        xc, conv_new = _causal_conv(xi, tp.block(p["conv"], 1, c, di),
                                    tp.block(state.conv, 2, c, di) if keep_state else None)
        xc = common.silu(xc).float()
        xcs.append(xc)
        convs.append(conv_new)
        sums.append((xc @ tp.block(p["wbc"], 0, c, di).float(), xc @ tp.block(p["wdt"], 0, c, di).float()))
    # the sums are the same on every rank; each rank's scan takes its channels
    bc, dt_all = (tp.vary(t) for t in tp.psum_cat(sums)) if split else sums[0]
    bmat, cmat = bc[..., :n], bc[..., n:]
    chunk = min(sc.chunk, s_len)
    pad = (-s_len) % chunk
    outs, hs = [], []
    for c, xc, (_, z) in zip(coords, xcs, ups):
        dt = _softplus(_own(dt_all, c, split, m) + tp.block(p["dt_bias"], 0, c, di))
        a = -torch.exp(tp.block(p["a_log"], 0, c, di).to(dt_))  # (di, N), in the compute dtype
        h0 = tp.block(state.h, 1, c, di) if keep_state else xc.new_zeros((b, m, n))
        if pad:  # identity steps: dt = 0 -> decay = 1, inc = 0
            xc_p, dt_p, b_p, c_p = (F.pad(t, (0, 0, 0, pad)) for t in (xc, dt, bmat, cmat))
        else:
            xc_p, dt_p, b_p, c_p = xc, dt, bmat, cmat
        y, hlast = mamba_core(xc_p, dt_p, b_p, c_p, a, tp.block(p["dskip"], 0, c, di), h0, chunk=chunk)
        y = y[:, :s_len].to(dt_) * common.silu(z)
        outs.append(y @ tp.block(p["wout"], 0, c, di).to(dt_))
        hs.append(hlast)
    out = tp.reduce(outs, "partial" if split else "whole")
    return out, (MambaState(_joined(hs, 1), _joined(convs, 2)) if keep_state else None)


def decode_mamba(p, x, cfg, state: MambaState, tp: common.TP = common.SINGLE):
    return apply_mamba(p, x, cfg, state, tp)
