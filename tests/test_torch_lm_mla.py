"""The port's MLA (DeepSeek-V3's multi-head latent attention) against
``repro.models.attention`` on the same numpy inputs and the reference's
weights: ``apply_mla``, ``prefill_mla`` and the absorbed ``decode_mla``
(1e-5 relative to the largest entry, ragged rows), the absorbed decode
against attention over the expanded per-head K/V, an idle row past the
latent cache (not written, as JAX drops the write), and the bfloat16
latent cache beside prefill's fresh, unrounded latent."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import attention as RA
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models.attention import AttnSpec, MLACache
from repro_torch.models.model import params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

REL_TOL = 1e-5
SPEC = AttnSpec(causal=True)
RSPEC = RA.AttnSpec(causal=True)

r_apply = jax.jit(RA.apply_mla, static_argnames=("cfg", "spec"))
r_prefill = jax.jit(RA.prefill_mla, static_argnames=("cfg", "spec"))
r_decode = jax.jit(RA.decode_mla, static_argnames=("cfg", "spec"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


@pytest.fixture(scope="module")
def mla():
    """The reduced DeepSeek-V3's MLA (4 heads, q rank 32, kv rank 16,
    rope 8, nope 16, v 16), float32, with the reference's weights."""
    cfg = dataclasses.replace(r_get_config("deepseek-v3-671b", reduced=True), dtype="float32")
    rp, rs = RA.init_mla(jax.random.PRNGKey(0), cfg)
    return cfg, rp, rs, params_from_numpy(rp, device="cpu")


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _rcache(cache: MLACache):
    """A copy of the port's cache for the reference (bfloat16 through
    float32, exactly)."""
    return RA.MLACache(*(jnp.asarray(t.float().numpy() if t.is_floating_point() else t.numpy()).astype(
        str(t.dtype).removeprefix("torch.")) for t in cache))


def test_init_mla_specs_and_shapes(mla):
    cfg, rp, rs, _ = mla
    p, s = A.init_mla(torch.Generator().manual_seed(0), get_config("deepseek-v3-671b", reduced=True), "cpu")
    assert s == rs
    assert {k: tuple(v.shape) for k, v in p.items() if not isinstance(v, dict)} == {
        k: tuple(v.shape) for k, v in rp.items() if not isinstance(v, dict)}
    assert torch.equal(p["kv_norm"]["scale"], torch.zeros(cfg.mla.kv_lora_rank))


@pytest.mark.parametrize("impl", ["chunked", "naive"])
def test_apply_mla_matches_reference(mla, impl):
    cfg, rp, _, p = mla
    x = _x(1, 2, 24, cfg.d_model)
    got = A.apply_mla(p, _t(x), cfg, SPEC, impl=impl)
    assert got.shape == x.shape
    assert rel(got, r_apply(rp, jnp.asarray(x), cfg=cfg, spec=RSPEC)) <= REL_TOL
    offset = np.arange(24) + 5  # explicit positions rotate q_rope and k_rope
    got = A.apply_mla(p, _t(x), cfg, SPEC, positions=_t(offset))
    assert rel(got, r_apply(rp, jnp.asarray(x), cfg=cfg, spec=RSPEC, positions=jnp.asarray(offset))) <= REL_TOL


def test_prefill_and_decode_match_reference(mla):
    """Prefill writes the latent cache in place; decode steps rows at
    different positions (a ragged batch) against it."""
    cfg, rp, _, p = mla
    x = _x(2, 2, 12, cfg.d_model)
    cache = A.init_mla_cache(2, 32, cfg.mla, torch.float32)
    out, cache = A.prefill_mla(p, _t(x[:, :9]), cache, cfg, SPEC)
    rcache = RA.init_mla_cache(2, 32, cfg.mla, jnp.float32)
    rout, rcache = r_prefill(rp, jnp.asarray(x[:, :9]), rcache, cfg=cfg, spec=RSPEC)
    assert rel(out, rout) <= REL_TOL
    assert rel(cache.ckv, rcache.ckv) <= REL_TOL and rel(cache.k_rope, rcache.k_rope) <= REL_TOL
    assert cache.length.tolist() == [9, 9] and cache.length.dtype == torch.int32
    ragged = MLACache(cache.ckv, cache.k_rope, torch.tensor([9, 4], dtype=torch.int32))
    rragged = _rcache(ragged)
    for t in range(3):
        step, ragged = A.decode_mla(p, _t(x[:, 9 + t:10 + t]), ragged, cfg, SPEC)
        rstep, rragged = r_decode(rp, jnp.asarray(x[:, 9 + t:10 + t]), rragged, cfg=cfg, spec=RSPEC)
        assert rel(step, rstep) <= REL_TOL, t
        assert rel(ragged.ckv, rragged.ckv) <= REL_TOL and rel(ragged.k_rope, rragged.k_rope) <= REL_TOL
    assert ragged.length.tolist() == [12, 7]
    assert ragged.ckv is cache.ckv  # written in place


def test_absorbed_decode_equals_expanded_attention(mla):
    """Scoring the latent cache through the absorbed W_uk and summing
    latents before W_uv is attention over the expanded per-head K/V: each
    decode step equals apply_mla's output at that position."""
    cfg, _, _, p = mla
    x = _t(_x(3, 2, 16, cfg.d_model))
    full = A.apply_mla(p, x, cfg, SPEC, impl="naive")
    cache = A.init_mla_cache(2, 16, cfg.mla, torch.float32)
    out, cache = A.prefill_mla(p, x[:, :10], cache, cfg, SPEC)
    np.testing.assert_allclose(out.numpy(), full[:, :10].numpy(), rtol=1e-4, atol=1e-5)
    for t in range(10, 16):
        step, cache = A.decode_mla(p, x[:, t:t + 1], cache, cfg, SPEC)
        assert rel(step, full[:, t:t + 1]) <= REL_TOL, t


def test_decode_past_the_latent_cache_drops_the_write(mla):
    """A row whose length reached S_max (an idle serving slot) is not
    written -- JAX drops the out-of-bounds .at[].set -- and still decodes,
    attending every cached position, as the reference's row does."""
    cfg, rp, _, p = mla
    rng = np.random.default_rng(4)
    s_max = 8
    ckv = rng.standard_normal((2, s_max, cfg.mla.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, s_max, cfg.mla.rope_head_dim)).astype(np.float32)
    length = np.array([3, s_max], np.int32)
    cache = MLACache(_t(ckv), _t(kr), _t(length))
    x = _x(5, 2, 1, cfg.d_model)
    out, new = A.decode_mla(p, _t(x), cache, cfg, SPEC)
    rout, rnew = r_decode(rp, jnp.asarray(x), RA.MLACache(jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(length)),
                          cfg=cfg, spec=RSPEC)
    assert torch.equal(new.ckv[1], _t(ckv[1])) and torch.equal(new.k_rope[1], _t(kr[1]))
    assert not torch.equal(new.ckv[0], _t(ckv[0]))  # row 0 wrote position 3
    assert rel(new.ckv, rnew.ckv) <= REL_TOL and rel(new.k_rope, rnew.k_rope) <= REL_TOL
    assert rel(out, rout) <= REL_TOL and bool(torch.isfinite(out).all())
    assert new.length.tolist() == [4, s_max + 1]
    again, newer = A.decode_mla(p, _t(x), new, cfg, SPEC)  # and further past it
    assert newer.length.tolist() == [5, s_max + 2] and bool(torch.isfinite(again).all())


def test_bf16_latent_cache_and_fresh_prefill(mla):
    """The cache is bfloat16 by default even for a float32 model: prefill
    writes the latent rounded and attends the fresh one (its output is
    apply_mla's, to float32 rounding), the decode steps read the rounded
    cache -- as the reference's."""
    cfg, rp, _, p = mla
    x = _x(6, 2, 10, cfg.d_model)
    cache = A.init_mla_cache(2, 16, cfg.mla)
    assert cache.ckv.dtype == torch.bfloat16 and cache.k_rope.dtype == torch.bfloat16
    out, cache = A.prefill_mla(p, _t(x[:, :9]), cache, cfg, SPEC)
    assert rel(out, A.apply_mla(p, _t(x[:, :9]), cfg, SPEC)) <= REL_TOL
    fresh = A._mla_qkv(p, _t(x[:, :9]), cfg, torch.arange(9))[2]  # the fresh latent
    assert torch.equal(cache.ckv[:, :9], fresh.to(torch.bfloat16)) and not torch.equal(cache.ckv[:, :9].float(), fresh)
    rcache = RA.init_mla_cache(2, 16, cfg.mla)
    rout, rcache = r_prefill(rp, jnp.asarray(x[:, :9]), rcache, cfg=cfg, spec=RSPEC)
    assert rel(out, rout) <= REL_TOL
    assert rel(cache.ckv, np.asarray(rcache.ckv.astype(jnp.float32))) <= 1e-2
    before = _rcache(cache)  # the port's rounded cache, before the step writes it
    step, _ = A.decode_mla(p, _t(x[:, 9:]), cache, cfg, SPEC)
    rstep, _ = r_decode(rp, jnp.asarray(x[:, 9:]), before, cfg=cfg, spec=RSPEC)
    assert rel(step, rstep) <= 1e-4  # the same rounded cache, each package's bf16 -> f32 reads
