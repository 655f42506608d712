"""The port's ``models/moe.py`` against ``repro.models.moe`` on the same
numpy inputs and the reference's own weights: the float32 router (top-k
weights, indices, aux loss), the stable-sort capacity assignment in a
case that drops, ``apply_moe`` by the einsum and the dense dispatch
(1e-5 relative to the largest entry, the shared expert included), the
two dispatches equal when the capacity drops nothing, the ``"ring"``
fallback and the dispatches over two ranks, the combine's fixed summation order, and ``init_moe``'s specs
and its expert draws made one expert at a time."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import moe as RMOE
from repro_torch.configs import get_config
from repro_torch.core import SimMesh
from repro_torch.models import common as C
from repro_torch.models import moe as MOE
from repro_torch.models.model import params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

REL_TOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _cfg(arch="deepseek-v3-671b", **moe):
    """A reduced MoE config, float32, MoEConfig fields overridden (the
    port's configs are the reference's field for field)."""
    cfg = dataclasses.replace(r_get_config(arch, reduced=True), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


r_apply = jax.jit(RMOE.apply_moe, static_argnames=("cfg",))
r_router = jax.jit(RMOE.router_topk, static_argnames=("k",))


@pytest.fixture(scope="module")
def weights():
    """The reference's MoE weights for the reduced DeepSeek-V3 (8 experts
    top-2, one shared expert) and Mixtral (4 experts top-2, none)."""
    out = {}
    for arch in ("deepseek-v3-671b", "mixtral-8x22b"):
        rp, rs = RMOE.init_moe(jax.random.PRNGKey(0), _cfg(arch))
        out[arch] = (rp, rs, params_from_numpy(rp, device="cpu"))
    return out


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def test_router_topk_matches_reference(weights):
    rp, _, p = weights["deepseek-v3-671b"]
    x = _x(1, 1, 40, 64)[0]
    w, idx, aux = MOE.router_topk(_t(x), p["router"], 2)
    rw, ridx, raux = r_router(jnp.asarray(x), rp["router"], k=2)
    assert w.dtype == torch.float32 and idx.shape == (40, 2)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert rel(w, rw) <= REL_TOL and abs(float(aux) - float(raux)) <= REL_TOL * float(raux)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert bool((w[:, 0] >= w[:, 1]).all())
    # a bfloat16 input routes in float32 all the same
    w16, idx16, _ = MOE.router_topk(_t(x).to(torch.bfloat16), p["router"], 2)
    assert w16.dtype == torch.float32
    rw16, ridx16, _ = r_router(jnp.asarray(x, jnp.bfloat16), rp["router"], k=2)
    assert np.array_equal(idx16.numpy(), np.asarray(ridx16)) and rel(w16, rw16) <= REL_TOL


@pytest.mark.parametrize("t,k,e,cap", [(24, 2, 4, 5), (8, 8, 256, 1), (16, 2, 8, 8)])
def test_dispatch_indices_equal_reference(t, k, e, cap):
    """Exactly the reference's order, slots and drops, where experts are
    over-subscribed (the first two cases drop) and where they are not."""
    rng = np.random.default_rng(t * 31 + e)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)]).astype(np.int32)
    idx[: t // 2, 0] = 1  # crowd expert 1
    got = MOE._dispatch_indices(_t(idx).long(), e, cap)
    exp = RMOE._dispatch_indices(jnp.asarray(idx), e, cap)
    for g, x in zip(got, exp):
        assert np.array_equal(g.numpy(), np.asarray(x))
    keep = got[2]
    if cap < t * k:
        assert not bool(keep.all())
    kept = got[1][keep]
    assert len(set(kept.tolist())) == len(kept)  # a kept slot holds one token


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x22b"])
@pytest.mark.parametrize("dispatch", ["einsum", "dense"])
def test_apply_moe_matches_reference(weights, arch, dispatch):
    """At the stock capacity factor (1.25: the einsum dispatch drops), with
    DeepSeek's shared expert."""
    rp, _, p = weights[arch]
    cfg = _cfg(arch, dispatch=dispatch)
    x = _x(2, 2, 20, cfg.d_model)
    out, aux = MOE.apply_moe(p, _t(x), cfg)
    rout, raux = r_apply(rp, jnp.asarray(x), cfg=cfg)
    assert out.shape == x.shape and aux.shape == ()
    assert rel(out, rout) <= REL_TOL
    assert abs(float(aux) - float(raux)) <= REL_TOL * float(raux)


def test_apply_moe_bfloat16_matches_reference(weights):
    rp, _, p = weights["deepseek-v3-671b"]
    cfg = dataclasses.replace(_cfg(dispatch="einsum"), dtype="bfloat16")
    x = _x(3, 2, 16, cfg.d_model)
    out, _ = MOE.apply_moe(p, _t(x).to(torch.bfloat16), cfg)
    rout, _ = r_apply(rp, jnp.asarray(x, jnp.bfloat16), cfg=cfg)
    assert out.dtype == torch.bfloat16
    assert rel(out, np.asarray(rout.astype(jnp.float32))) <= 2e-2


def test_einsum_drops_and_equals_dense_without_drops(weights):
    """At capacity_factor = E / k the capacity is every token, nothing
    drops, and the einsum dispatch equals every expert on every token; at
    the stock factor with a crowded expert it does not."""
    rp, _, p = weights["deepseek-v3-671b"]
    x = _x(4, 1, 32, 64)
    mo = _cfg().moe
    full = _cfg(dispatch="einsum", capacity_factor=mo.num_experts / mo.top_k)
    assert MOE._capacity(32, mo.top_k, mo.num_experts, full.moe.capacity_factor) == 32
    dense, _ = MOE.apply_moe(p, _t(x), _cfg(dispatch="dense"))
    einsum, _ = MOE.apply_moe(p, _t(x), full)
    assert rel(einsum, dense) <= REL_TOL
    # a stock-factor dispatch where one expert takes more than its capacity
    crowded = dict(p, router=0.01 * torch.arange(8.0).expand_as(p["router"]).clone())
    crowded["router"][:, 3] = 1.0
    xc = np.abs(x)  # every token routes to experts 3 and 7, 10 slots each
    stock, _ = MOE.apply_moe(crowded, _t(xc), _cfg(dispatch="einsum"))
    rstock, _ = r_apply(dict(rp, router=jnp.asarray(crowded["router"].numpy())), jnp.asarray(xc),
                        cfg=_cfg(dispatch="einsum"))
    assert rel(stock, rstock) <= REL_TOL
    assert rel(stock, MOE.apply_moe(crowded, _t(xc), _cfg(dispatch="dense"))[0]) > 1e-2


def test_ring_falls_back_to_einsum(weights):
    """The reference's fallback: "ring" runs the einsum dispatch without
    a mesh or on one rank. On two ranks of a ``model`` axis it runs the
    ring, which equals the one-rank output where nothing drops; on two of
    a ``data`` axis (no ring) it is the reference's einsum dispatch with
    g = 2 groups, each batch row its own capacity (tests/test_torch_lm_ep.py
    holds both against the reference under a jax mesh)."""
    rp, _, p = weights["deepseek-v3-671b"]
    x = _t(_x(5, 2, 12, 64))
    cfg = _cfg()
    assert cfg.moe.dispatch == "ring"
    einsum, aux = MOE.apply_moe(p, x, _cfg(dispatch="einsum"))
    for mesh in (None, SimMesh(1, "model", device="cpu")):
        out, a = MOE.apply_moe(p, x, cfg, mesh=mesh)
        assert torch.equal(out, einsum) and torch.equal(a, aux)
    rout, _ = r_apply(rp, jnp.asarray(x.numpy()), cfg=cfg)
    assert rel(einsum, rout) <= REL_TOL
    mo = cfg.moe
    full = _cfg(capacity_factor=mo.num_experts / mo.top_k)
    ring, _ = MOE.apply_moe(p, x, full, mesh=SimMesh(2, "model", device="cpu"))
    assert rel(ring, MOE.apply_moe(p, x, full)[0]) <= REL_TOL
    groups, g_aux = MOE.apply_moe(p, x, cfg, mesh=SimMesh(2, "data", device="cpu"))
    per_row = [r_apply(rp, jnp.asarray(x.numpy()[i:i + 1]), cfg=cfg) for i in range(2)]
    assert rel(groups, np.concatenate([np.asarray(o) for o, _ in per_row])) <= REL_TOL
    assert abs(float(g_aux) - np.mean([float(a) for _, a in per_row])) <= REL_TOL * float(g_aux)
    assert rel(groups, einsum) > 1e-3  # 2 x 12 tokens' capacity drops other assignments than 24's


def test_combine_sums_the_top_k_in_a_fixed_order():
    """The combine un-permutes (no scatter-add): each token's output is
    its k gated expert outputs summed, dropped assignments adding 0."""
    idx = torch.tensor([[0, 1], [0, 2], [0, 1]])
    w = torch.tensor([[0.75, 0.25], [0.5, 0.5], [0.625, 0.375]])
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 1
    buf, routing = MOE._local_dispatch(x, idx, 3, 2)  # expert 0 takes tokens 0 and 1; token 2's is dropped
    assert torch.equal(buf[0], x[:2]) and torch.equal(buf[1], x[[0, 2]]) and torch.equal(buf[2, 0], x[1])
    out = MOE._local_combine(buf * 2, w, routing, 3)
    exp = torch.stack([2 * x[0], 2 * x[1], 0.375 * 2 * x[2]])
    assert torch.equal(out, exp)


def test_init_moe_specs_and_deferred_experts():
    """The reference's specs and shapes; the experts are Deferred draws
    that fill a stack one expert at a time, the float32 draw cast."""
    rp, rs = RMOE.init_moe(jax.random.PRNGKey(0), _cfg())
    p, s = MOE.init_moe(torch.Generator().manual_seed(0), get_config("deepseek-v3-671b", reduced=True), "cpu")
    assert s == rs
    assert {k: tuple(v.shape) for k, v in _flat(p).items()} == {k: tuple(v.shape) for k, v in _flat(rp).items()}
    assert isinstance(p["wg"], C.Deferred) and isinstance(p["router"], torch.Tensor)
    g32, g16 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    full = p["wd"].draw(g32, "cpu")
    half = p["wd"].fill(torch.empty((8, 32, 64), dtype=torch.bfloat16), g16)
    assert full.dtype == torch.float32 and torch.equal(full.to(torch.bfloat16), half)
    std = 1 / math.sqrt(8)  # the reference's fan-in is the leading (expert) axis
    assert float(full.abs().max()) <= 3 * std * (1 + 1e-6)
    truncated = std * math.sqrt(1 - 6 * math.exp(-4.5) / math.sqrt(2 * math.pi) / math.erf(3 / math.sqrt(2)))
    assert abs(float(full.std()) - truncated) < 0.02 * truncated
    assert not torch.equal(full[0], full[1])  # each expert its own draw


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}
