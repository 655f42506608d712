"""The port's dense decoder LM against the reference on the same numpy
inputs and the reference's own weights (``params_from_numpy`` of its
``Model.init(PRNGKey(0))``): norms, rope, MLPs, softcap, the attention
cases of ``tests/test_attention.py``, and logits / prefill / decode of
the four dense archs and the two MoE archs (Mixtral, DeepSeek-V3 with
MLA), reduced, in float32 (1e-5 relative to the largest entry; the MoE
router's aux loss and ``Model.init``'s specs as well) and one bfloat16
case (2e-2)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import mlp as RM
from repro.models.model import Model as RModel
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import mlp as M
from repro_torch.models.attention import AttnSpec
from repro_torch.models.model import Model, params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

DENSE = ["qwen2.5-32b", "phi3-medium-14b", "gemma2-9b", "nemotron-4-15b"]
MOE = ["mixtral-8x22b", "deepseek-v3-671b"]
REL_TOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _np_rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------- primitives


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind, dtype):
    rng = _np_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 0.5
    p = {"scale": rng.standard_normal(64).astype(np.float32) * 0.1}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32) * 0.1
    ref = RC.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, dtype), kind)
    got = C.apply_norm({k: _t(v) for k, v in p.items()}, _t(x).to(getattr(torch, dtype)), kind)
    assert str(got.dtype).removeprefix("torch.") == dtype
    assert rel(got, ref.astype(jnp.float32)) <= (REL_TOL if dtype == "float32" else 1e-2)


def test_groupnorm_and_population_variance():
    rng = _np_rng(2)
    x = rng.standard_normal((3, 4, 2, 8)).astype(np.float32) * 2 + 1
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    ref = RC.apply_groupnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 2)
    got = C.apply_groupnorm({"scale": _t(scale)}, _t(x), 2)
    assert rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e6), (0.5, 1e4), (1.0, 0.0)])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope(fraction, theta, per_row):
    rng = _np_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.array([[5], [900]]) if per_row else np.arange(7) + 3
    if per_row:
        x = x[:, :1]
    ref = RC.rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    got = C.rope(_t(x), _t(pos), theta, fraction)
    assert rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_apply_mlp(kind):
    p, _ = RM.init_mlp(jax.random.PRNGKey(4), 32, 96, kind)
    x = _np_rng(4).standard_normal((2, 5, 32)).astype(np.float32)
    ref = RM.apply_mlp(p, jnp.asarray(x), kind)
    got = M.apply_mlp(params_from_numpy(p, device="cpu"), _t(x), kind)
    assert rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_act_is_bitwise_the_reference_in_bfloat16(kind):
    """The activations, spelled op by op (``common.silu`` / ``gelu``), on
    100 000 bf16 values: bitwise the reference's ``jax.nn.silu`` /
    ``jax.nn.gelu`` (one-rounding ``F.silu`` / ``F.gelu`` differ in ~40 %
    of them)."""
    x = (_np_rng(9).standard_normal(100_000) * 4).astype(np.float32)
    exp = np.asarray(RM._act(jnp.asarray(x, jnp.bfloat16), kind).astype(jnp.float32))
    got = M._act(_t(x).to(torch.bfloat16), kind)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), exp)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_apply_mlp_bfloat16(kind):
    """A bfloat16 MLP on the reference's weights (cast once, as
    ``params_from_numpy(dtype=)`` casts them), within the bf16 gate."""
    p, _ = RM.init_mlp(jax.random.PRNGKey(5), 32, 96, kind)
    x = _np_rng(6).standard_normal((2, 5, 32)).astype(np.float32)
    ref = RM.apply_mlp(jax.tree.map(lambda a: a.astype(jnp.bfloat16), p), jnp.asarray(x, jnp.bfloat16), kind)
    got = M.apply_mlp(params_from_numpy(p, device="cpu", dtype=torch.bfloat16), _t(x).to(torch.bfloat16), kind)
    assert got.dtype == torch.bfloat16
    assert rel(got, np.asarray(ref.astype(jnp.float32))) <= 2e-2


def test_softcap_and_sinusoidal():
    x = _np_rng(5).standard_normal(100).astype(np.float32) * 1000
    assert rel(C.softcap(_t(x), 50.0), RC.softcap(jnp.asarray(x), 50.0)) <= REL_TOL
    assert float(C.softcap(_t(x), 50.0).abs().max()) <= 50.0
    assert torch.equal(C.softcap(_t(x), 0.0), _t(x))
    assert rel(C.sinusoidal_positions(12, 16), RC.sinusoidal_positions(12, 16)) == 0.0


def test_trunc_normal_statistics():
    """Fan-in std scale/sqrt(shape[0]), truncated at +-3 std: the
    statistics of the reference's draw (the bits cannot match)."""
    shape, scale = (4096, 256), 2.0
    std = scale / math.sqrt(shape[0])
    g = torch.Generator().manual_seed(0)
    got = C.trunc_normal(shape, scale, generator=g, device="cpu").double()
    ref = np.asarray(RC.trunc_normal(jax.random.PRNGKey(0), shape, scale), np.float64)
    truncated_std = std * math.sqrt(1 - 6 * math.exp(-4.5) / math.sqrt(2 * math.pi) / math.erf(3 / math.sqrt(2)))
    for draw in (got.numpy(), ref):
        assert abs(draw.std() - truncated_std) / truncated_std < 0.01
        assert abs(draw.mean()) < 0.01 * std
        assert np.abs(draw).max() <= 3 * std * (1 + 1e-6)
        assert np.abs(draw).max() > 2.9 * std
    again = C.trunc_normal(shape, scale, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.double(), got)
    assert C.trunc_normal((7,), 1.0, generator=g, device="cpu").abs().max() <= 3.0


# ---------------------------------------------------------------- attention


def _qkv(rng, b, s, h, kvh, d):
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


SPECS = [
    AttnSpec(causal=True),
    AttnSpec(causal=True, window=16),
    AttnSpec(causal=True, softcap=30.0),
    AttnSpec(causal=True, window=12, prefix=4),
    AttnSpec(causal=False),
]


def _rspec(spec):
    return RA.AttnSpec(*spec)


# the reference's attention calls, jitted (eager lax.scan dispatch is slow)
r_chunked = jax.jit(RA.attention_chunked, static_argnames=("spec", "kv_chunk"))
r_attention = jax.jit(RA.attention, static_argnames=("spec", "impl", "kv_chunk"))
r_apply = jax.jit(RA.apply_attention, static_argnames=("cfg", "spec"))
r_prefill = jax.jit(RA.prefill_attention, static_argnames=("cfg", "spec"))
r_decode = jax.jit(RA.decode_attention, static_argnames=("cfg", "spec"))


@pytest.mark.parametrize("spec", SPECS)
def test_chunked_matches_naive_and_reference(spec):
    q, k, v = _qkv(_np_rng(6), 2, 48, 4, 2, 16)
    naive = A.attention_naive(_t(q), _t(k), _t(v), spec)
    got = A.attention_chunked(_t(q), _t(k), _t(v), spec, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=1e-4, atol=1e-5)
    rq, rk, rv = map(jnp.asarray, (q, k, v))
    assert rel(naive, RA.attention_naive(rq, rk, rv, _rspec(spec))) <= REL_TOL
    assert rel(got, r_chunked(rq, rk, rv, spec=_rspec(spec), kv_chunk=16)) <= REL_TOL
    # a chunk that does not divide the keys: the reference pads, the port cuts short
    assert rel(A.attention_chunked(_t(q), _t(k), _t(v), spec, kv_chunk=20),
               r_chunked(rq, rk, rv, spec=_rspec(spec), kv_chunk=20)) <= REL_TOL


@pytest.mark.parametrize("spec", SPECS[:4])
def test_flash_forward_matches_reference(spec):
    q, k, v = _qkv(_np_rng(7), 1, 64, 4, 4, 8)
    ref = RA.flash_attention_train(*map(jnp.asarray, (q, k, v)), _rspec(spec), kv_chunk=16)
    assert rel(A.flash_attention_train(_t(q), _t(k), _t(v), spec, kv_chunk=16), ref) <= REL_TOL


def test_attention_dispatch_matches_reference():
    """impl="naive"; q_offset 0 without valid lengths -> flash forward;
    an offset or valid lengths -> the chunked scan (q_offset per row)."""
    q, k, v = _qkv(_np_rng(8), 2, 32, 4, 2, 16)
    spec = AttnSpec(causal=True, window=8)
    tq, tk, tv = _t(q), _t(k), _t(v)
    rq, rk, rv = map(jnp.asarray, (q, k, v))
    rs = _rspec(spec)
    assert rel(A.attention(tq, tk, tv, spec, impl="naive"), r_attention(rq, rk, rv, spec=rs, impl="naive")) <= REL_TOL
    assert rel(A.attention(tq, tk, tv, spec, kv_chunk=8), r_attention(rq, rk, rv, spec=rs, kv_chunk=8)) <= REL_TOL
    off, valid = np.array([20, 5], np.int32), np.array([24, 9], np.int32)
    got = A.attention(tq[:, :4], tk, tv, spec, q_offset=_t(off), kv_chunk=8, kv_valid_len=_t(valid))
    ref = r_attention(rq[:, :4], rk, rv, spec=rs, q_offset=jnp.asarray(off), kv_chunk=8,
                      kv_valid_len=jnp.asarray(valid))
    assert rel(got, ref) <= REL_TOL
    with pytest.raises(ValueError, match="naive"):
        A.attention(tq, tk, tv, spec, impl="naive", kv_valid_len=_t(valid))


def test_gqa_group_broadcast():
    """GQA with kvh < h equals MHA with repeated KV heads."""
    b, s, h, kvh, d = 1, 24, 4, 2, 8
    q, k, v = map(_t, _qkv(_np_rng(9), b, s, h, kvh, d))
    spec = AttnSpec(causal=True)
    got = A.attention_naive(q, k, v, spec)
    exp = A.attention_naive(q, k.repeat_interleave(h // kvh, dim=2), v.repeat_interleave(h // kvh, dim=2), spec)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=1e-4, atol=1e-5)
    chunked = A.attention_chunked(q, k, v, spec, kv_chunk=8)
    np.testing.assert_allclose(chunked.numpy(), exp.numpy(), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def attn_setup():
    cfg = dataclasses.replace(r_get_config("qwen2.5-32b", reduced=True), dtype="float32")
    rp, _ = RA.init_attention(jax.random.PRNGKey(0), cfg)
    return cfg, rp, params_from_numpy(rp, device="cpu")


def test_decode_matches_full_and_reference(attn_setup):
    cfg, rp, p = attn_setup
    x = _np_rng(10).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    spec = AttnSpec(causal=True)
    full = A.apply_attention(p, _t(x), cfg, spec)
    assert rel(full, r_apply(rp, jnp.asarray(x), cfg=cfg, spec=_rspec(spec))) <= REL_TOL
    cache = A.init_kv_cache(2, 32, cfg.num_kv_heads, cfg.head_dim_, torch.float32)
    out_pre, cache = A.prefill_attention(p, _t(x[:, :11]), cache, cfg, spec)
    np.testing.assert_allclose(out_pre.numpy(), full[:, :11].numpy(), rtol=2e-3, atol=1e-4)
    step, cache = A.decode_attention(p, _t(x[:, 11:12]), cache, cfg, spec)
    np.testing.assert_allclose(step.numpy(), full[:, 11:12].numpy(), rtol=2e-3, atol=2e-4)
    assert cache.length.tolist() == [12, 12]
    rcache = RA.init_kv_cache(2, 32, cfg.num_kv_heads, cfg.head_dim_, jnp.float32)
    _, rcache = r_prefill(rp, jnp.asarray(x[:, :11]), rcache, cfg=cfg, spec=_rspec(spec))
    rstep, rcache = r_decode(rp, jnp.asarray(x[:, 11:12]), rcache, cfg=cfg, spec=_rspec(spec))
    assert rel(step, rstep) <= REL_TOL
    assert rel(cache.k, rcache.k) <= REL_TOL and rel(cache.v, rcache.v) <= REL_TOL


def test_ragged_decode_rows(attn_setup):
    """Rows at different cache positions decode like their aligned runs,
    and as the reference's ragged batch does."""
    cfg, rp, p = attn_setup
    rng = _np_rng(11)
    spec = AttnSpec(causal=True)
    xa, xb = (rng.standard_normal((1, n, cfg.d_model)).astype(np.float32) for n in (8, 5))
    xa_new, xb_new = (rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32) for _ in range(2))
    solo = []
    for x, x_new in ((xa, xa_new), (xb, xb_new)):
        c = A.init_kv_cache(1, 32, cfg.num_kv_heads, cfg.head_dim_, torch.float32)
        _, c = A.prefill_attention(p, _t(x), c, cfg, spec)
        kv = (c.k.clone(), c.v.clone())
        o, _ = A.decode_attention(p, _t(x_new), c, cfg, spec)
        solo.append((o, kv))
    batched = A.KVCache(torch.cat([solo[0][1][0], solo[1][1][0]]), torch.cat([solo[0][1][1], solo[1][1][1]]),
                        torch.tensor([8, 5], dtype=torch.int32))
    out, newc = A.decode_attention(p, _t(np.concatenate([xa_new, xb_new])), batched, cfg, spec)
    np.testing.assert_allclose(out[0:1].numpy(), solo[0][0].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[1:2].numpy(), solo[1][0].numpy(), rtol=1e-4, atol=1e-5)
    assert newc.length.tolist() == [9, 6]
    rb = RA.KVCache(jnp.asarray(batched.k.numpy()), jnp.asarray(batched.v.numpy()), jnp.asarray([8, 5], jnp.int32))
    # batched.k was written in place by the port's decode; the reference rewrites the same rows
    rout, _ = r_decode(rp, jnp.asarray(np.concatenate([xa_new, xb_new])), rb, cfg=cfg, spec=_rspec(spec))
    assert rel(out, rout) <= REL_TOL


def test_decode_past_the_cache_drops_the_write(attn_setup):
    """A row whose length reached S_max (an idle serving slot) is not
    written -- JAX drops the out-of-bounds .at[].set -- and still decodes."""
    cfg, rp, p = attn_setup
    rng = _np_rng(12)
    s_max = 8
    k0 = rng.standard_normal((2, s_max, cfg.num_kv_heads, cfg.head_dim_)).astype(np.float32)
    v0 = rng.standard_normal((2, s_max, cfg.num_kv_heads, cfg.head_dim_)).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    length = np.array([3, s_max], np.int32)
    cache = A.KVCache(_t(k0), _t(v0), _t(length))
    out, new = A.decode_attention(p, _t(x), cache, cfg, AttnSpec(causal=True))
    rcache = RA.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(length))
    rout, rnew = r_decode(rp, jnp.asarray(x), rcache, cfg=cfg, spec=RA.AttnSpec(causal=True))
    assert torch.equal(cache.k[1], _t(k0[1])) and torch.equal(cache.v[1], _t(v0[1]))
    assert rel(new.k, rnew.k) <= REL_TOL and rel(out, rout) <= REL_TOL
    assert new.length.tolist() == [4, s_max + 1]


# -------------------------------------------------------------------- model


def _batch(cfg, seed, b=2, s=12, extra=4):
    rng = _np_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s + extra)).astype(np.int32)


def _jit_init(rmodel, seed: int):
    """The reference model's (weights, specs) from ``PRNGKey(seed)``, its
    init under jit (bitwise the eager init's, at a third of the time); the
    specs read while tracing."""
    box = {}

    def init(key):
        params, box["specs"] = rmodel.init(key)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(seed))
    return params, box["specs"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _cache_leaves(state):
    """Each layer group's cache tensors (K/V or the MLA latent and rope
    keys) and its (L, B) lengths."""
    return [(name, c[:-1], c.length) for name, c in state.items() if name != "pos"]


@pytest.fixture(scope="module", params=DENSE + MOE)
def arch_run(request):
    """One arch, reduced, float32: the reference's weights and its
    logits, aux, specs, prefill and four decode steps on a fixed token
    stream."""
    arch = request.param
    rcfg = dataclasses.replace(r_get_config(arch, reduced=True), dtype="float32")
    rmodel = RModel(rcfg, attn_impl="chunked")
    rparams, rspecs = _jit_init(rmodel, 0)
    toks = _batch(rcfg, seed=13)
    s = toks.shape[1] - 4
    ref = {"logits": np.asarray(jax.jit(rmodel.logits)(rparams, {"tokens": jnp.asarray(toks)})), "specs": rspecs}
    ref["aux"] = float(jax.jit(rmodel.hidden)(rparams, {"tokens": jnp.asarray(toks)})[1])
    state = rmodel.init_decode_state(2, 32, cache_dtype=jnp.float32)
    state, pl = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(toks[:, :s])}, state)
    ref["prefill"] = np.asarray(pl)
    decode = jax.jit(rmodel.decode_step)
    ref["decode"] = []
    for t in range(4):
        lg, state = decode(rparams, jnp.asarray(toks[:, s + t:s + t + 1]), state)
        ref["decode"].append(np.asarray(lg))
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    model = Model(cfg, device="cpu")
    return model, params_from_numpy(rparams, device="cpu"), toks, ref


def test_logits_match_reference(arch_run):
    model, params, toks, ref = arch_run
    got = model.logits(params, {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and got.shape == ref["logits"].shape
    assert rel(got, ref["logits"]) <= REL_TOL


def test_hidden_aux_and_specs_match_reference(arch_run):
    """``hidden`` returns (x, aux) as the reference's does: aux is the sum
    of the MoE blocks' router losses (0 for a dense model); ``init``'s
    specs and shapes are the reference's, MoE, MLA and MTP leaves too."""
    model, params, toks, ref = arch_run
    x, aux = model.hidden(params, {"tokens": _t(toks)})
    assert x.shape == ref["logits"].shape[:2] + (model.cfg.d_model,)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if model.cfg.moe is None:
        assert float(aux) == ref["aux"] == 0.0
    else:
        assert ref["aux"] > 0 and abs(float(aux) - ref["aux"]) <= REL_TOL * ref["aux"]
    got, specs = model.init(torch.Generator().manual_seed(0))
    assert _flat(specs) == _flat(ref["specs"])
    assert {k: tuple(v.shape) for k, v in _flat(got).items()} == {k: tuple(v.shape) for k, v in _flat(params).items()}


def test_prefill_and_decode_match_reference(arch_run):
    model, params, toks, ref = arch_run
    s = toks.shape[1] - 4
    state = model.init_decode_state(2, 32, cache_dtype=torch.float32)
    state, pl = model.prefill(params, {"tokens": _t(toks[:, :s])}, state)
    assert rel(pl, ref["prefill"]) <= REL_TOL
    assert state["pos"] == s
    assert [length.tolist() for _, _, length in _cache_leaves(state)] == [[[s, s]] * g.count for g in model.groups]
    for t in range(4):
        lg, state = model.decode_step(params, _t(toks[:, s + t:s + t + 1]), state)
        assert rel(lg, ref["decode"][t]) <= REL_TOL, t
        # and the full sequence's logits at that position, where no
        # capacity drop couples the tokens (MoE: test_moe_without_drops...)
        if model.cfg.moe is None:
            assert rel(lg, ref["logits"][:, s + t]) <= 1e-4, t
    assert state["pos"] == s + 4


def test_moe_config_without_moe_layers_matches_reference():
    """first_k_dense = num_layers: the MoE group has no layer (an empty
    stack in both packages) and the model is dense."""
    rcfg = dataclasses.replace(r_get_config("deepseek-v3-671b", reduced=True), dtype="float32")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, first_k_dense=rcfg.num_layers))
    rmodel = RModel(rcfg)
    rparams, rspecs = _jit_init(rmodel, 3)
    model = Model(rcfg, device="cpu")
    assert [(g.name, g.count) for g in model.groups] == [("dense_prefix", 3), ("moe", 0)]
    params, specs = model.init(torch.Generator().manual_seed(3))
    assert _flat(specs) == _flat(rspecs)
    assert {k: tuple(v.shape) for k, v in _flat(params).items()} == {k: tuple(v.shape) for k, v in _flat(rparams).items()}
    toks = _batch(rcfg, seed=16)
    got = model.logits(params_from_numpy(rparams, device="cpu"), {"tokens": _t(toks)})
    assert rel(got, jax.jit(rmodel.logits)(rparams, {"tokens": jnp.asarray(toks)})) <= REL_TOL


@pytest.mark.parametrize("arch", MOE)
def test_moe_without_drops_decodes_like_the_full_sequence(arch):
    """At the stock capacity factor the experts drop assignments, which
    couples a token to the others in its dispatch (both packages); at
    ``capacity_factor = E / k`` nothing drops, and prefill + decode equal
    the whole sequence's logits, as for a dense model -- and the
    reference's decode."""
    rcfg = dataclasses.replace(r_get_config(arch, reduced=True), dtype="float32")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=rcfg.moe.num_experts / rcfg.moe.top_k))
    rmodel = RModel(rcfg)
    rparams, _ = _jit_init(rmodel, 2)
    toks = _batch(rcfg, seed=15)
    s = toks.shape[1] - 4
    model = Model(rcfg, device="cpu")
    params = params_from_numpy(rparams, device="cpu")
    full = model.logits(params, {"tokens": _t(toks)})
    assert rel(full, jax.jit(rmodel.logits)(rparams, {"tokens": jnp.asarray(toks)})) <= REL_TOL
    state = model.init_decode_state(2, 32, cache_dtype=torch.float32)
    state, pl = model.prefill(params, {"tokens": _t(toks[:, :s])}, state)
    assert rel(pl, full[:, s - 1]) <= 1e-4
    rstate = rmodel.init_decode_state(2, 32, cache_dtype=jnp.float32)
    rstate, _ = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(toks[:, :s])}, rstate)
    r_decode_step = jax.jit(rmodel.decode_step)
    for t in range(4):
        lg, state = model.decode_step(params, _t(toks[:, s + t:s + t + 1]), state)
        rlg, rstate = r_decode_step(rparams, jnp.asarray(toks[:, s + t:s + t + 1]), rstate)
        assert rel(lg, full[:, s + t]) <= 1e-4, t
        assert rel(lg, rlg) <= REL_TOL, t


def test_prefill_attends_fresh_kv_and_decode_reads_the_bf16_cache(arch_run):
    """The engine's cache is bfloat16 even for a float32 model: prefill's
    logits do not see it, the decode steps do."""
    model, params, toks, ref = arch_run
    s = toks.shape[1] - 4
    state = model.init_decode_state(2, 32)
    assert all(t.dtype == torch.bfloat16 for _, leaves, _ in _cache_leaves(state) for t in leaves)
    state, pl = model.prefill(params, {"tokens": _t(toks[:, :s])}, state)
    assert rel(pl, ref["prefill"]) <= REL_TOL
    lg, _ = model.decode_step(params, _t(toks[:, s:s + 1]), state)
    err = rel(lg, ref["decode"][0])
    assert 0 < err <= 2e-2  # the rounded cache moves the logits, within bf16's reach


def test_bfloat16_model_matches_reference():
    arch = "qwen2.5-32b"
    rcfg = r_get_config(arch, reduced=True)
    assert rcfg.dtype == "bfloat16"
    rmodel = RModel(rcfg)
    rparams, _ = _jit_init(rmodel, 1)
    toks = _batch(rcfg, seed=14, extra=2)
    s = toks.shape[1] - 2
    rstate = rmodel.init_decode_state(2, 32)
    rstate, rpl = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(toks[:, :s])}, rstate)
    rlg, _ = jax.jit(rmodel.decode_step)(rparams, jnp.asarray(toks[:, s:s + 1]), rstate)
    rlogits = jax.jit(rmodel.logits)(rparams, {"tokens": jnp.asarray(toks)})

    model = Model(get_config(arch, reduced=True), device="cpu")
    params = params_from_numpy(rparams, device="cpu", dtype=torch.bfloat16)
    assert params["layers"]["ffn"]["wg"].dtype == torch.bfloat16
    assert model._cast(params)["layers"]["ffn"]["wg"] is params["layers"]["ffn"]["wg"]  # cast once
    assert rel(model.logits(params, {"tokens": _t(toks)}), rlogits) <= 2e-2
    state = model.init_decode_state(2, 32)
    state, pl = model.prefill(params, {"tokens": _t(toks[:, :s])}, state)
    assert rel(pl, rpl) <= 2e-2
    lg, _ = model.decode_step(params, _t(toks[:, s:s + 1]), state)
    assert rel(lg, rlg) <= 2e-2


def test_init_makes_the_compute_dtype_one_layer_at_a_time():
    cfg = get_config("gemma2-9b", reduced=True)
    model = Model(cfg, device="cpu")
    p32, _ = model.init(torch.Generator().manual_seed(3))
    p16, _ = model.init(torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    a, b = p32["layers"]["ffn"]["wg"], p16["layers"]["ffn"]["wg"]
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
    assert torch.equal(a.to(torch.bfloat16), b)  # the same draw, cast slice by slice
    assert not torch.equal(a[0], a[1])  # each layer its own draw
    assert torch.equal(p16["layers"]["ln1"]["scale"], torch.zeros_like(p16["layers"]["ln1"]["scale"]))
    assert torch.isfinite(model.logits(p16, {"tokens": torch.arange(6)[None]})).all()
