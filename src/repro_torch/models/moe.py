"""Mixture-of-Experts with capacity dispatch, ported from
``repro.models.moe``.

Routing: a float32 softmax router, top-k with renormalization and the
GShard load-balance aux loss. Capacity-based with drop (``cf * tokens *
k / E`` slots per expert); slots are assigned through a stable argsort,
token priority within each expert, as the reference assigns them.

``dispatch='einsum'``
    Scatter the tokens into an (E, cap, d) buffer, run every expert's FFN
    on its slots as one batched product, gather back (the reference's
    GSPMD path). Under a mesh the capacity is counted per data-parallel
    group (the product of the ``pod`` / ``data`` axes, 1 when it does not
    divide the tokens), every rank routes and dispatches all of them
    (the activations are replicated), runs the FFN on its block of the
    (G, E, cap, d) buffer -- the experts over the ``model`` axis when
    they divide it, else the capacity dim (the reference's
    ``_buf_constrain``) -- and one all-gather of the expert outputs over
    the mesh (``mesh.gather``) brings every block to every rank for the
    combine: the synchronized collective, the paper's baseline.
``dispatch='ring'``
    The paper's N-scatter applied to the expert all-to-all
    (``_ring_exchange_ffn``). Each rank of the ``model`` axis takes its
    S/P slice of the sequence (and its batch block over a data axis),
    routes and counts capacity on its own tokens, and builds a (P,
    E_loc, cap, d) buffer grouped by the rank that owns the experts; the
    P-1 chunks go straight to their ranks as independent sends, one
    batched FFN runs over what arrived (or one per arrival with
    ``interleave=True``), and the results come home on the mirrored
    ring; the rank's output slice is then gathered back to the
    replicated (B, S, d). Falls back to ``einsum`` without a mesh, on one
    rank, or when P does not divide the experts or the sequence (so a
    decode step, S = 1, always takes the einsum dispatch), as the
    reference does.
``dispatch='dense'``
    Every expert on every token, weighted by the gates (small configs);
    it needs every expert on the rank. Where ranks hold their own rows of
    the batch, its aux is the one over every token (the reference's over
    the whole batch under GSPMD).

The router is whole on every rank; the shared expert is a
tensor-parallel MLP (``mlp.apply_mlp`` over the ``model`` axis). The
expert leaves of a rank: on a ``SimMesh`` the stacks stay whole and each
rank's experts are a view of them; on a ``ProcessGroupMesh`` a rank
holds only its block (``Model.init`` / ``params_from_numpy`` place them,
from the ``"experts"`` specs through ``core.sharding.block``).

Both scatters are deterministic on the card (no atomics): each kept
assignment owns its buffer slot, so the dispatch writes them (dropped
ones land in a spare row that is cut off); the combine un-permutes the
expert outputs to (T, k, d) and sums over k.
"""

from __future__ import annotations

import collections
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import sharding
from repro_torch.models import common, mlp
from repro_torch.models.common import Params, Specs

#: (dispatch that ran, ranks of the mesh) -> calls of ``apply_moe``: which
#: dispatch each call took after the reference's fallbacks ("ring",
#: "einsum", "dense"); clear it before a run to read that run's.
DISPATCHES: collections.Counter = collections.Counter()


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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as CUDA makes it: int64 zeros, then one scatter
    of ones. The CPU's first reads the indices' range back to the host and
    the ``meta`` device's compares against an ``arange``; this is one
    program on every device (``launch.dryrun`` traces it on ``meta``)."""
    return torch.zeros(idx.shape + (n,), dtype=torch.int64, device=idx.device).scatter_(-1, idx[..., None], 1)


def router_topk(x: torch.Tensor, wr: torch.Tensor, k: int, *,
                batch=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (T, k) float32, indices (T, k) int64, aux
    load-balance loss).

    With ``batch`` (``TP.batch``: the mesh and the axes whose ranks hold
    the batch's rows) the aux is the one over every token (the
    reference's over the whole batch): the routed counts, the
    probabilities' sums and the token counts summed over those axes. The
    probabilities are the rank's own, so its rows' share of the aux
    carries their gradient; ``Model.loss`` divides a rank's aux by the
    ranks of those axes (each rank's aux is its group's in the other
    dispatches), so the share enters n times, and the value is the
    global aux on every rank."""
    probs = torch.softmax(x.float() @ wr.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # GShard aux: E * sum_e (fraction routed to e) * (mean prob of e)
    e = wr.shape[1]
    if batch is None:
        frac = _one_hot(idx, e).float().sum(1).mean(0)  # (E,)
        return w, idx, e * torch.sum(frac * probs.mean(0))
    full, axes = batch
    local = torch.cat([_one_hot(idx, e).float().sum((0, 1)), probs.detach().sum(0),
                       probs.new_full((1,), float(x.shape[0]))])
    tot = full.psum([local], axes, activation=True)[0]
    frac, mean, t = tot[:e] / tot[-1], tot[e:2 * e] / tot[-1], tot[-1]
    share = full.axis_size(axes) * e * torch.sum(frac * probs.sum(0)) / t
    return w, idx, share + (e * torch.sum(frac * mean) - share).detach()


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


def _groups(mesh, t: int) -> int:
    """The einsum dispatch's data-parallel groups: the product of the
    mesh's ``pod`` / ``data`` axes, or 1 when that does not divide the
    ``t`` tokens (the reference's ``g``)."""
    g = 1
    if mesh is not None:
        for ax in ("pod", "data"):
            g *= mesh.shape.get(ax, 1)
        if t % g:
            g = 1
    return g


def _experts_of(p, mesh, rank: int, split: bool, e: int):
    """(wg, wu, wd) of the experts ``rank`` runs: every expert unless
    ``split``, else its block of the ``model`` axis -- a view of the whole
    stack on a ``SimMesh``, the leaves themselves on a
    ``ProcessGroupMesh``, which holds only its block."""
    ws = (p.get("wg"), p["wu"], p["wd"])
    n = e // mesh.shape["model"] if split else e
    held = p["wu"].shape[0]
    if held == n and (mesh.caller_holds_block or not split):
        return ws
    if held != e or mesh.caller_holds_block:
        raise ValueError(f"the expert leaves hold {held} experts, rank {rank} runs {n} of {e}: build the params "
                         "for this mesh (Model.init, params_from_numpy(mesh=, specs=))")
    c = mesh.coords(rank)["model"]
    return tuple(None if w is None else w[c * n:(c + 1) * n] for w in ws)


def _block_ffn(ws, xb: torch.Tensor, kind: str) -> torch.Tensor:
    """One rank's (G', E', C', d) block of the dispatch buffer through its
    experts (E', d, f); G' = 1 runs as one (E', C', d) batched product."""
    if xb.shape[0] == 1:
        return _expert_ffn(*ws, xb[0], kind)[None]
    return _expert_ffn(*ws, xb, kind)


def _apply_moe_gspmd(p, x2d: torch.Tensor, cfg: ModelConfig, mesh=None,
                     tp: Optional[common.TP] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's GSPMD capacity dispatch: capacity per data-parallel
    group, every expert on its (cap, d) slots. Over several ranks each
    runs its block of the (G, E, cap, d) buffer and ``mesh.gather`` (an
    all-gather) brings the expert outputs to every rank. The buffer, the
    same on every rank, enters each rank's block through ``tp.vary`` (and
    experts kept whole, where the capacity dim is what splits)."""
    mo = cfg.moe
    e = mo.num_experts
    t = x2d.shape[0]
    g = _groups(mesh, t)
    tl = t // g
    cap = _capacity(tl, mo.top_k, e, mo.capacity_factor)
    routed = []
    for xl in x2d.reshape(g, tl, -1).unbind(0):
        w, idx, aux = router_topk(xl, p["router"], mo.top_k)
        buf, routing = _local_dispatch(xl, idx, e, cap)
        routed.append((w, buf, routing, aux))
    buf = torch.stack([r[1] for r in routed]) if g > 1 else routed[0][1][None]  # (G, E, C, d)
    spec = sharding.resolve(mesh, "batch", "experts", "expert_cap", None, shape=buf.shape) if mesh else ()
    if mesh is None or mesh.p == 1 or not any(spec):  # one rank, or no dim divides: every slot here
        y = _block_ffn((p.get("wg"), p["wu"], p["wd"]), buf, cfg.mlp_kind)
    else:
        split = spec[1] is not None
        # experts kept whole are the same on every rank: they enter each rank's block once
        whole = None if split else tuple(None if w is None else tp.vary(w) for w in (p.get("wg"), p["wu"], p["wd"]))
        blocks = [_block_ffn(whole or _experts_of(p, mesh, rank, split, e), b, cfg.mlp_kind)
                  for rank, b in zip(mesh.local_ranks(), mesh.split(tp.vary(buf), spec))]
        y = mesh.gather(blocks, spec)  # every expert's outputs on every rank
    out = torch.cat([_local_combine(y[i], w, routing, tl) for i, (w, _, routing, _) in enumerate(routed)])
    return out, torch.stack([r[3] for r in routed]).mean()


def _apply_moe_dense(p, x2d: torch.Tensor, cfg: ModelConfig,
                     tp: Optional[common.TP] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, weighted by the gates. Where the
    process holds its rows of the batch (``tp.batch``), the aux is the
    one over every token (:func:`router_topk`'s ``batch``)."""
    mo = cfg.moe
    if p["wu"].shape[0] != mo.num_experts:
        raise ValueError(f"the dense dispatch runs every expert; this rank holds {p['wu'].shape[0]} of "
                         f"{mo.num_experts}")
    w, idx, aux = router_topk(x2d, p["router"], mo.top_k, batch=tp.batch if tp is not None else None)
    all_y = _expert_ffn(p.get("wg"), p["wu"], p["wd"], x2d[None], cfg.mlp_kind)  # (E, T, d)
    gate = torch.einsum("tk,tke->te", w, _one_hot(idx, mo.num_experts).float())  # (T, E)
    return torch.einsum("te,etd->td", gate.to(x2d.dtype), all_y), aux


def _ring_exchange_ffn(ws: Sequence[tuple], bufs: Sequence[torch.Tensor], kind: str, ring, *,
                       interleave: bool = False) -> List[torch.Tensor]:
    """bufs: one (P, E_loc, C, d) dispatch buffer per local rank of the
    1-D ring view ``ring``, grouped by destination rank; ws: each local
    rank's (wg, wu, wd) of its E_loc experts. Chunk s ships *directly* to
    rank me+s (P-1 independent sends, all posted before any is waited
    on: the paper's N-scatter decomposition), the results return on the
    mirrored ring. Returns each rank's (P, E_loc, C, d) expert outputs,
    in its buffer's order.

    Default (interleave=False): one batched FFN over all received chunks,
    (E_loc, P*C, d). With interleave=True the FFN runs on each chunk as
    it lands and its result is sent home at once (the paper's literal
    'compute each chunk as it lands'); the bytes on the wire are the
    same."""
    from repro_torch.core.overlap import ppermute_start

    pn = ring.p
    ranks = ring.local_ranks()

    def post(s: int, pieces, sign: int):  # under autograd a differentiable hop, waited at once
        return ppermute_start(ring, pieces, [(i, (i + sign * s) % pn) for i in range(pn)])

    outs = [torch.empty_like(b) for b in bufs]
    sends = [post(s, [b[(me + s) % pn] for b, me in zip(bufs, ranks)], 1) for s in range(1, pn)]
    if interleave:
        for out, w, b, me in zip(outs, ws, bufs, ranks):
            out[me] = _expert_ffn(*w, b[me], kind)
        backs = []
        for s, pend in enumerate(sends, 1):
            backs.append(post(s, [_expert_ffn(*w, r, kind) for w, r in zip(ws, pend.wait())], -1))
    else:
        # phase 1: the own chunk, then chunk s = the tokens of rank me-s
        recv = [[b[me]] for b, me in zip(bufs, ranks)]
        for pend in sends:
            for got, r in zip(recv, pend.wait()):
                got.append(r)
        # phase 2: one batched FFN, (E_loc, P*C, d)
        e_loc, cap, d = bufs[0].shape[1:]
        done = [_expert_ffn(*w, torch.cat(got, dim=1), kind).view(e_loc, pn, cap, d) for w, got in zip(ws, recv)]
        for out, dn, me in zip(outs, done, ranks):
            out[me] = dn[:, 0]
        # phase 3: the results home on the mirrored ring
        backs = [post(s, [dn[:, s] for dn in done], -1) for s in range(1, pn)]
    for s, pend in enumerate(backs, 1):
        for out, back, me in zip(outs, pend.wait(), ranks):
            out[(me + s) % pn] = back
    return outs


def _apply_moe_ring(p, x: torch.Tensor, cfg: ModelConfig, mesh, tp: common.TP, axis_name: str = "model"):
    """x: (B, S, d), replicated. Each rank takes its island of the
    sequence: its S/P slice over ``axis_name`` (and its batch block over a
    data axis), the sequence-parallel expert parallelism of DeepSeek. The
    aux is the reference's: ``lax.pmean`` over the axis with
    ``out_specs=P()`` keeps the value of data coordinate 0's islands,
    while its transpose (``check_vma=False``) spreads the gradient over
    every island as the mean of all of them -- the value of group 0's
    mean, the gradient of the mean over the mesh. Where the process holds
    its rows (``tp.batch``), its islands are its data group's: its aux
    carries that group's gradient, and its value moves by the same
    constant on every group so that the mean over the groups (what
    ``Model.loss`` takes) is group 0's. ``x`` and the router, the same on
    every rank, enter the islands through ``tp.vary``."""
    mo = cfg.moe
    b, s, d = x.shape
    e, pn = mo.num_experts, mesh.shape[axis_name]
    e_loc = e // pn
    tail = (sharding.resolve(mesh, "batch")[0], axis_name, None)  # the reference's x_spec
    islands = []
    router = tp.vary(p["router"])
    for xl in mesh.split(tp.vary(x), tail):
        bl, sl, _ = xl.shape
        t = bl * sl
        x2d = xl.reshape(t, d)
        cap = _capacity(t, mo.top_k, e, mo.capacity_factor)
        w, idx, aux = router_topk(x2d, router, mo.top_k)
        buf, routing = _local_dispatch(x2d, idx, e, cap)
        islands.append((buf.reshape(pn, e_loc, cap, d), w, routing, aux, xl.shape))
    local = mesh.local_ranks()
    outs: List[Optional[torch.Tensor]] = [None] * len(local)
    for ring, idx in mesh.rings(axis_name):
        ws = [_experts_of(p, mesh, local[k], True, e) for k in idx]
        ys = _ring_exchange_ffn(ws, [islands[k][0] for k in idx], cfg.mlp_kind, ring)
        for k, y in zip(idx, ys):
            _, w, routing, _, shape = islands[k]
            outs[k] = _local_combine(y.reshape(e, -1, d), w, routing, shape[0] * shape[1]).reshape(shape)
    out = mesh.gather(outs, tail)
    auxes = mesh.gather([isl[3].reshape(1, 1) for isl in islands], tail[:2])  # (data, P)
    if tp.batch is not None:  # the process holds its rows: this ring is its data group's
        full, axes = tp.batch
        own = auxes.mean()
        groups = full.all_gather([own.detach()], axes)[0]  # every data group's mean
        return out, own + (groups[0] - groups.mean()).detach()
    return out, auxes.mean() + (auxes[0].mean() - auxes.mean()).detach()


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mesh=None,
              tp: Optional[common.TP] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), the same on every rank of ``mesh``. Returns (out (B,
    S, d), aux loss scalar), the same on every rank. The router stays
    whole; the shared expert is a tensor-parallel MLP over ``tp`` (default
    the mesh's ``model`` axis)."""
    mo = cfg.moe
    b, s, d = x.shape
    tp = common.TP(mesh) if tp is None else tp
    dispatch = mo.dispatch
    if dispatch == "ring":
        pn = mesh.shape.get("model", 1) if mesh is not None else 1
        if mesh is None or pn == 1 or mo.num_experts % pn or s % pn:
            dispatch = "einsum"  # the reference's divisibility fallback
    DISPATCHES[(dispatch, 1 if mesh is None else mesh.p)] += 1
    if dispatch == "ring":
        out, aux = _apply_moe_ring(p, x, cfg, mesh, tp)
    elif dispatch == "dense":
        out, aux = _apply_moe_dense(p, x.reshape(b * s, d), cfg, tp)
    else:
        out, aux = _apply_moe_gspmd(p, x.reshape(b * s, d), cfg, mesh, tp)
    out = out.reshape(b, s, d)
    if mo.num_shared:
        out = out + mlp.apply_mlp(p["shared"], x, cfg.mlp_kind, tp, (mo.expert_d_ff or cfg.d_ff) * mo.num_shared)
    return out, aux
