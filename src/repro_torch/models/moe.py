"""Mixture-of-Experts with capacity dispatch, ported from
``repro.models.moe``.

Routing: a float32 softmax router, top-k with renormalization and the
GShard load-balance aux loss. Capacity-based with drop (``cf * tokens *
k / E`` slots per expert); slots are assigned through a stable argsort,
token priority within each expert, as the reference assigns them.

``dispatch='einsum'``
    Scatter the tokens into an (E, cap, d) buffer, run every expert's FFN
    on its slots as one batched product, gather back (the reference's
    GSPMD path; on one rank its sharding constraint is a no-op).
``dispatch='dense'``
    Every expert on every token, weighted by the gates (small configs).
``dispatch='ring'``
    Falls back to ``einsum`` without a mesh or on one rank, as the
    reference does. MoE over several ranks (the reference's ring exchange
    ``_ring_exchange_ffn`` and its per-group GSPMD dispatch) is ROADMAP
    A15.1b.

Both scatters are deterministic on the card (no atomics): each kept
assignment owns its buffer slot, so the dispatch writes them (dropped
ones land in a spare row that is cut off); the combine un-permutes the
expert outputs to (T, k, d) and sums over k.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common, mlp
from repro_torch.models.common import Params, Specs


def init_moe(generator: torch.Generator, cfg: ModelConfig, device) -> Tuple[Params, Specs]:
    """The router, the experts' stacked (E, ...) FFN weights and the
    shared expert. The expert leaves are :class:`common.Deferred` draws,
    which ``Model.init`` fills in place one expert at a time."""
    mo: MoEConfig = cfg.moe
    d = cfg.d_model
    eff = mo.expert_d_ff or cfg.d_ff
    p = {
        "router": common.dense_init((d, mo.num_experts), generator=generator, device=device),
        "wg": common.Deferred((mo.num_experts, d, eff)),
        "wu": common.Deferred((mo.num_experts, d, eff)),
        "wd": common.Deferred((mo.num_experts, eff, d)),
    }
    s = {
        "router": ("fsdp", None),
        "wg": ("experts", "fsdp", None),
        "wu": ("experts", "fsdp", None),
        "wd": ("experts", None, "fsdp"),
    }
    if mo.num_shared:
        p["shared"], s["shared"] = mlp.init_mlp(generator, d, eff * mo.num_shared, cfg.mlp_kind, device)
    return p, s


def router_topk(x: torch.Tensor, wr: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T, k) float32, indices (T, k) int64, aux
    load-balance loss)."""
    probs = torch.softmax(x.float() @ wr.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # GShard aux: E * sum_e (fraction routed to e) * (mean prob of e)
    e = wr.shape[1]
    frac = F.one_hot(idx, e).float().sum(1).mean(0)  # (E,)
    aux = e * torch.sum(frac * probs.mean(0))
    return w, idx, aux


def _expert_ffn(wg, wu, wd, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (..., C, d) for one expert's weight set, or for (E, ...) stacked
    ones with x's batch dims broadcasting against E: (1, T, d) runs every
    expert on every token, (E, C, d) each expert on its slots."""
    dt = x.dtype
    if kind in mlp.GATED:
        h = mlp._act(x @ wg.to(dt), kind) * (x @ wu.to(dt))
    else:
        h = mlp._act(x @ wu.to(dt), kind)
    return h @ wd.to(dt)


def _dispatch_indices(idx: torch.Tensor, e: int, cap: int):
    """Stable-sort capacity assignment.

    idx: (T, k) expert choices. Returns (order (A,), dest (A,), keep (A,))
    where A = T*k; dest = expert*cap + slot for kept assignments (slot 0
    of the expert for dropped ones, as the reference has it).
    """
    t, k = idx.shape
    a = t * k
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # token priority within expert
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(e, device=idx.device, dtype=sorted_e.dtype), side="left")
    rank = torch.arange(a, device=idx.device) - first[sorted_e]
    keep = rank < cap
    dest = sorted_e * cap + torch.where(keep, rank, 0)
    return order, dest, keep


def _local_dispatch(x2d: torch.Tensor, idx: torch.Tensor, e: int, cap: int):
    """Tokens into the (E, cap, d) buffer; returns it and the routing the
    combine needs. Kept assignments own distinct slots; dropped ones are
    written to row ``E * cap``, cut off (the reference adds an exact 0)."""
    t, k = idx.shape
    order, dest, keep = _dispatch_indices(idx, e, cap)
    tok = order // k
    buf = torch.zeros((e * cap + 1, x2d.shape[-1]), dtype=x2d.dtype, device=x2d.device)
    buf[torch.where(keep, dest, e * cap)] = x2d[tok]
    return buf[:-1].reshape(e, cap, -1), (order, dest, keep, tok)


def _local_combine(buf: torch.Tensor, w: torch.Tensor, routing: tuple, t: int) -> torch.Tensor:
    """Each assignment's expert output times its gate (0 when dropped),
    un-permuted to (T, k, d) and summed over k in a fixed order."""
    order, dest, keep, _ = routing
    k = w.shape[1]
    flat_w = w.reshape(-1)[order]  # (A,) float32
    y = buf.reshape(-1, buf.shape[-1])[dest]  # (A, d)
    y = y * (flat_w * keep).to(y.dtype)[:, None]
    per = torch.empty_like(y)
    per[order] = y
    return per.reshape(t, k, -1).sum(1)


def _capacity(tokens: int, k: int, e: int, cf: float) -> int:
    return max(1, math.ceil(tokens * k * cf / e))


def _apply_moe_gspmd(p, x2d: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's GSPMD capacity dispatch on one rank: one
    data-parallel group, every expert on its (cap, d) slots."""
    mo = cfg.moe
    t = x2d.shape[0]
    cap = _capacity(t, mo.top_k, mo.num_experts, mo.capacity_factor)
    w, idx, aux = router_topk(x2d, p["router"], mo.top_k)
    buf, routing = _local_dispatch(x2d, idx, mo.num_experts, cap)
    y = _expert_ffn(p.get("wg"), p["wu"], p["wd"], buf, cfg.mlp_kind)  # (E, C, d)
    return _local_combine(y, w, routing, t), aux


def _apply_moe_dense(p, x2d: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    mo = cfg.moe
    w, idx, aux = router_topk(x2d, p["router"], mo.top_k)
    all_y = _expert_ffn(p.get("wg"), p["wu"], p["wd"], x2d[None], cfg.mlp_kind)  # (E, T, d)
    gate = torch.einsum("tk,tke->te", w, F.one_hot(idx, mo.num_experts).float())  # (T, E)
    return torch.einsum("te,etd->td", gate.to(x2d.dtype), all_y), aux


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out (B, S, d), aux loss scalar)."""
    mo = cfg.moe
    b, s, d = x.shape
    if mesh is not None and mesh.p > 1:
        raise NotImplementedError(f"not ported yet: MoE over {mesh.p} ranks is ROADMAP A15.1b")
    x2d = x.reshape(b * s, d)
    if mo.dispatch == "dense":
        out, aux = _apply_moe_dense(p, x2d, cfg)
    else:  # "einsum", and "ring" on one rank: the reference's fallback
        out, aux = _apply_moe_gspmd(p, x2d, cfg)
    out = out.reshape(b, s, d)
    if mo.num_shared:
        out = out + mlp.apply_mlp(p["shared"], x, cfg.mlp_kind)
    return out, aux
