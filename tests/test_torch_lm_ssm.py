"""The port's SSM and hybrid serving path against the reference on the
same numpy inputs and the reference's own weights: ``models/ssm.py``
(the mLSTM chunkwise form and decode step, the causal conv, the sLSTM
block, Mamba and its scans), the hymba and xLSTM blocks with their
states, and ``Model``'s logits / hidden / prefill + decode for
``xlstm-1.3b``, ``hymba-1.5b`` (at 4 layers: layer 1 windowed, past its
reduced window of 32 plus 8 meta tokens) and an ``slstm_every=0`` xLSTM
(the ``xlstm_m`` group), reduced, in float32 (1e-5 relative to the
largest entry) and in bfloat16 (2e-2). The reference's calls are jitted;
its weights come from its ``Model.init`` under jit."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import attention as RA
from repro.models import blocks as RB
from repro.models import common as RC
from repro.models import ssm as RS
from repro.models.model import Model as RModel
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import common as C
from repro_torch.models import ssm as S
from repro_torch.models.model import Model, params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

REL_TOL = 1e-5
BF16_TOL = 2e-2
PORT_TYPES = {c.__name__: c for c in (S.MLSTMState, S.MLSTMBlockState, S.SLSTMState, S.MambaState, B.HymbaState,
                                      B.XLSTMPairState, A.KVCache)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]


def to_port(tree):
    """A reference state tree (NamedTuples of arrays) as the port's."""
    if isinstance(tree, tuple):
        return PORT_TYPES[type(tree).__name__](*(to_port(a) for a in tree))
    return _t(tree)


def assert_states(got, exp, tol=REL_TOL):
    got, exp = leaves(got), leaves(exp)
    assert len(got) == len(exp)
    for i, (g, e) in enumerate(zip(got, exp)):
        assert tuple(g.shape) == e.shape, i
        e = np.asarray(e)
        if np.issubdtype(e.dtype, np.integer):
            assert np.array_equal(g.numpy(), e), i
        elif np.abs(e).max() > 0:
            assert rel(g, e) <= tol, (i, rel(g, e))
        else:
            assert float(g.abs().max()) == 0, i


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _cfg(arch, **kw):
    return dataclasses.replace(r_get_config(arch, reduced=True), **{"dtype": "float32", **kw})


def _jit(fn, cfg, **kw):
    """``fn(p, x, cfg, *state, **kw)`` of the reference, jitted."""
    return jax.jit(lambda p, x, *state: fn(p, x, cfg, *state, **kw))


def _weights(init, cfg, seed):
    """One block's weights from the port's ``init`` (a seeded generator) as
    both packages' trees: the same numbers in each. (The reference's
    eager init of a block takes seconds; the model tests carry the
    reference's own Model.init weights.)"""
    p, _ = init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return jax.tree.map(lambda a: jnp.asarray(a.numpy()), p), p


# --------------------------------------------------------------- mLSTM core


def _mlstm_inputs(seed, s, b=2, h=2, dk=8, dv=6):
    q, k = _np(seed, b, h, s, dk), _np(seed + 1, b, h, s, dk)
    v = _np(seed + 2, b, h, s, dv)
    i_pre, f_pre = _np(seed + 3, b, h, s, scale=2.0), _np(seed + 4, b, h, s, scale=2.0) + 2.0
    state = (_np(seed + 5, b, h, dk, dv, scale=0.3), _np(seed + 6, b, h, dk, scale=0.3), _np(seed + 7, b, h))
    return (q, k, v, i_pre, f_pre), state


@pytest.mark.parametrize("s,carried", [(7, False), (17, True), (23, True)])
def test_mlstm_chunkwise_matches_reference(s, carried):
    """Lengths that the chunk (5) does not divide: identity padding; with
    and without a carried (C, n, m)."""
    args, state = _mlstm_inputs(s, s)
    r_state = RS.MLSTMState(*map(jnp.asarray, state)) if carried else None
    p_state = S.MLSTMState(*map(_t, state)) if carried else None
    exp, r_final = jax.jit(functools.partial(RS.mlstm_chunkwise, chunk=5))(*map(jnp.asarray, args), r_state)
    got, final = S.mlstm_chunkwise(*map(_t, args), p_state, chunk=5)
    assert got.shape == exp.shape and rel(got, exp) <= REL_TOL
    assert_states(final, r_final)


def test_mlstm_chunkwise_equals_its_decode_steps():
    """The chunkwise form and the recurrence step by step (the reference's
    own tests/test_ssm.py check, at its 2e-4)."""
    (q, k, v, i_pre, f_pre), _ = _mlstm_inputs(3, 19)
    got, final = S.mlstm_chunkwise(*map(_t, (q, k, v, i_pre, f_pre)), chunk=4)
    st = S.init_mlstm_state(2, 2, 8, 6)
    for t in range(19):
        h, st = S.mlstm_decode_step(*(_t(a[:, :, t]) for a in (q, k, v, i_pre, f_pre)), st)
        assert rel(h, got[:, :, t]) <= 2e-4, t
    assert all(rel(a, b) <= 2e-4 for a, b in zip(st, final))


def test_mlstm_decode_step_matches_reference_and_in_place():
    """Out of place against the reference; in place bitwise equal to out
    of place, writing into the state's own tensors."""
    (q, k, v, i_pre, f_pre), state = _mlstm_inputs(11, 1)
    step = [a[:, :, 0] for a in (q, k, v, i_pre, f_pre)]
    exp, r_st = jax.jit(RS.mlstm_decode_step)(*map(jnp.asarray, step), RS.MLSTMState(*map(jnp.asarray, state)))
    got, st = S.mlstm_decode_step(*map(_t, step), S.MLSTMState(*map(_t, state)))
    assert rel(got, exp) <= REL_TOL
    assert_states(st, r_st)
    mine = S.MLSTMState(*map(_t, state))
    got2, st2 = S.mlstm_decode_step(*map(_t, step), mine, inplace=True)
    assert torch.equal(got2, got) and all(torch.equal(a, b) for a, b in zip(st2, st))
    assert all(a is b for a, b in zip(st2, mine))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    x, w = _np(1, 2, 5, 8), _np(2, 4, 8)
    state = _np(3, 2, 3, 8) if with_state else None
    exp, exp_st = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), None if state is None else jnp.asarray(state))
    got, got_st = S._causal_conv(_t(x), _t(w), None if state is None else _t(state))
    assert rel(got, exp) <= REL_TOL and rel(got_st, exp_st) <= REL_TOL and got_st.shape == exp_st.shape


# ------------------------------------------------------------------ sLSTM


@pytest.fixture(scope="module")
def xcfg():
    return _cfg("xlstm-1.3b")


# ------------------------------------------------------------------ Mamba


@pytest.fixture(scope="module")
def hcfg():
    return _cfg("hymba-1.5b", num_layers=4)


def _sequential(decay, inc, h0):
    h, out = h0, []
    for t in range(decay.shape[0]):
        h = decay[t] * h + inc[t]
        out.append(h)
    return torch.stack(out)


def _doubling_out_of_place(decay, inc):
    d, i, off = decay, inc, 1
    while off < d.shape[0]:
        d, i = (torch.cat([d[:off], d[:-off] * d[off:]]), torch.cat([i[:off], i[:-off] * d[off:] + i[off:]]))
        off *= 2
    return d, i


def _scan_inputs(length):
    decay = _t(np.exp(-np.abs(_np(length, length, 2, 3, 4))))
    return decay, _t(_np(length + 1, length, 2, 3, 4)), _t(_np(length + 2, 2, 3, 4))


@pytest.mark.parametrize("length", [1, 2, 5, 8, 13])
def test_linear_scan_matches_a_sequential_loop(length):
    """The doubling scan against h_t = d_t h_{t-1} + i_t step by step, and
    its in-place updates bitwise equal to the out-of-place doubling."""
    decay, inc, h0 = _scan_inputs(length)
    dcum, icum = S.linear_scan(decay, inc)
    assert rel(dcum * h0[None] + icum, _sequential(decay, inc, h0)) <= REL_TOL
    d2, i2 = _doubling_out_of_place(decay, inc)
    assert torch.equal(dcum, d2) and torch.equal(icum, i2)


def test_chunk_scan_matches_reference():
    """``_chunk_fwd`` (the doubling scan from h0) against the reference's
    ``lax.associative_scan``."""
    args = _scan_inputs(13)
    exp = jax.jit(RS._chunk_fwd)(*(jnp.asarray(a.numpy()) for a in args))
    assert rel(S._chunk_fwd(*args), exp) <= REL_TOL


@pytest.mark.parametrize("s,chunk", [(11, 4), (8, 8), (6, 16)])
def test_mamba_scan_chunked_matches_reference(s, chunk):
    decay = np.exp(-np.abs(_np(s, 2, s, 3, 4)))
    inc, h0 = _np(s + 1, 2, s, 3, 4), _np(s + 2, 2, 3, 4)
    exp, exp_last = jax.jit(functools.partial(RS._mamba_scan_chunked, chunk=chunk))(
        *(jnp.asarray(a) for a in (decay, inc, h0)))
    got, last = S._mamba_scan_chunked(_t(decay), _t(inc), _t(h0), chunk)
    assert got.shape == exp.shape and rel(got, exp) <= REL_TOL and rel(last, exp_last) <= REL_TOL


# ----------------------------------------------------------------- blocks


def _random_state(tree, seed):
    """A reference state tree with every float leaf drawn at random (a
    state carried in), its integer leaves (cache lengths) kept."""
    out, i = [], seed
    for leaf in leaves(tree):
        i += 1
        out.append(leaf if jnp.issubdtype(leaf.dtype, jnp.integer) else jnp.asarray(_np(i, *leaf.shape, scale=0.3)))
    it = iter(out)

    def rebuild(t):
        return type(t)(*(rebuild(a) for a in t)) if isinstance(t, tuple) else next(it)

    return rebuild(tree)


def test_hymba_block_and_mamba_match_reference(hcfg):
    """A windowed layer's prefill (S = 40, past the window of 32, the first
    8 the meta prefix; not a multiple of Mamba's chunk of 16) and decode
    step from a carried Mamba state (h and conv window at random, the KV
    cache empty): the block, and ``apply_mamba`` / ``decode_mamba`` on the
    block's normalized input. The model tests run the trunk and the
    global layers."""
    rp, p = _weights(B.init_hymba_block, hcfg, 3)
    x = _np(9, 2, 41, hcfg.d_model)
    di = int(hcfg.ssm.expand * hcfg.d_model)
    r_st0 = RB.HymbaState(RA.init_kv_cache(2, 48, hcfg.num_kv_heads, hcfg.head_dim_, jnp.float32),
                          _random_state(RS.init_mamba_state(2, di, hcfg.ssm.state_dim, hcfg.ssm.conv_dim), 20))
    glob = dict(is_global=False)

    def ref(rp, x, st):
        norm = functools.partial(RC.apply_norm, rp["ln1"], kind=hcfg.norm_kind)
        mamba = RS.apply_mamba(rp["mamba"], norm(x[:, :40]), hcfg, st.mamba)
        out, st = RB.prefill_hymba_block(rp, x[:, :40], hcfg, st, **glob)
        mamba_step = RS.decode_mamba(rp["mamba"], norm(x[:, 40:]), hcfg, st.mamba)
        return (mamba, out, mamba_step) + RB.decode_hymba_block(rp, x[:, 40:], hcfg, st, **glob)

    mamba, out, mamba_step, step, r_st = jax.jit(ref)(rp, jnp.asarray(x), r_st0)
    st = to_port(r_st0)
    norm = functools.partial(C.apply_norm, p["ln1"], kind=hcfg.norm_kind)
    got, mst = S.apply_mamba(p["mamba"], norm(_t(x[:, :40])), hcfg, st.mamba)
    assert rel(got, mamba[0]) <= REL_TOL
    assert_states(mst, mamba[1])
    got, st = B.prefill_hymba_block(p, _t(x[:, :40]), hcfg, st, **glob)
    assert rel(got, out) <= REL_TOL
    got, mst = S.decode_mamba(p["mamba"], norm(_t(x[:, 40:])), hcfg, st.mamba)
    assert rel(got, mamba_step[0]) <= REL_TOL
    assert_states(mst, mamba_step[1])
    got, st = B.decode_hymba_block(p, _t(x[:, 40:]), hcfg, st, **glob)
    assert rel(got, step) <= REL_TOL
    assert_states(st, r_st)


def test_xlstm_pair_and_slstm_match_reference(xcfg):
    """The stateful full sequence (S = 21, past the mLSTM chunk of 16) and a
    decode step from a carried state (every leaf at random): the pair,
    and the sLSTM block full and decode (S = 1) on the pair's own
    normalized input. The decode writes the mLSTM cell in place; the
    model tests run the trunk."""
    rp, p = _weights(B.init_xlstm_pair, xcfg, 4)
    x = _np(10, 2, 22, xcfg.d_model)
    di = int(xcfg.ssm.expand * xcfg.d_model)
    dh = di // xcfg.num_heads
    r_st0 = _random_state(RB.XLSTMPairState(
        RS.MLSTMBlockState(RS.init_mlstm_state(2, xcfg.num_heads, dh, dh), jnp.zeros((2, 3, di), jnp.float32)),
        RS.init_slstm_state(2, xcfg.d_model)), 30)

    def slstm_in(rp, x, om):
        return RC.apply_norm(rp["lns"], x + om, xcfg.norm_kind)

    def ref(rp, x, st):
        om = RS.apply_mlstm_block(rp["m"], RC.apply_norm(rp["lnm"], x[:, :21], xcfg.norm_kind), xcfg, st.m)[0]
        slstm = RS.apply_slstm_block(rp["s"], slstm_in(rp, x[:, :21], om), xcfg, st.s)
        out, st = RB.apply_xlstm_pair(rp, x[:, :21], xcfg, st)
        om = RS.decode_mlstm_block(rp["m"], RC.apply_norm(rp["lnm"], x[:, 21:], xcfg.norm_kind), xcfg, st.m)[0]
        slstm_step = RS.decode_slstm_block(rp["s"], slstm_in(rp, x[:, 21:], om), xcfg, st.s)
        return (slstm, out, st, slstm_step) + RB.decode_xlstm_pair(rp, x[:, 21:], xcfg, st)

    slstm, out, r_mid, slstm_step, step, r_st = jax.jit(ref)(rp, jnp.asarray(x), r_st0)

    def port_slstm(x, st):
        hm = C.apply_norm(p["lnm"], x, xcfg.norm_kind)
        om = (S.apply_mlstm_block if x.shape[1] > 1 else S.decode_mlstm_block)(p["m"], hm, xcfg, st.m)[0]
        return C.apply_norm(p["lns"], x + om, xcfg.norm_kind)

    st = to_port(r_st0)
    got, sst = S.apply_slstm_block(p["s"], port_slstm(_t(x[:, :21]), to_port(r_st0)), xcfg, st.s)
    assert rel(got, slstm[0]) <= REL_TOL
    assert_states(sst, slstm[1])
    got, st = B.apply_xlstm_pair(p, _t(x[:, :21]), xcfg, st)
    assert rel(got, out) <= REL_TOL
    assert_states(st, r_mid)
    got, sst = S.decode_slstm_block(p["s"], port_slstm(_t(x[:, 21:]), to_port(r_mid)), xcfg, st.s)
    assert rel(got, slstm_step[0]) <= REL_TOL
    assert_states(sst, slstm_step[1])
    cell = st.m.cell
    got, st = B.decode_xlstm_pair(p, _t(x[:, 21:]), xcfg, st)
    assert rel(got, step) <= REL_TOL
    assert all(a is b for a, b in zip(st.m.cell, cell))  # in place
    assert_states(st, r_st)


# ------------------------------------------------------------------ Model

ARCHS = {
    "xlstm-1.3b": {},
    "hymba-1.5b": {"num_layers": 4},  # layers 0, 2, 3 global, 1 windowed
    "xlstm-1.3b slstm_every=0": {},
}


def _arch_cfg(name, **kw):
    arch = name.split()[0]
    cfg = _cfg(arch, **{**ARCHS[name], **kw})
    if "slstm_every=0" in name:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, slstm_every=0))
    return cfg


def _serve(rmodel, init=False, whole=True):
    """One jitted reference run on ``toks`` (B, S): the whole sequence's
    logits (``whole``), a prefill of all but the last ``n_decode`` tokens
    and decode steps over those (``lax.scan``); with ``init`` first its
    Model.init (eager takes ~3 x the time) from the key passed for the
    params, its specs read while tracing. Returns (the jitted run, a dict
    that holds the specs once it ran)."""
    box = {}

    def run(params_or_key, toks, state, n_decode):
        params = params_or_key
        if init:
            params, box["specs"] = rmodel.init(params_or_key)
        s = toks.shape[1] - n_decode
        logits = rmodel.logits(params, {"tokens": toks}) if whole else None
        state, pl = rmodel.prefill(params, {"tokens": toks[:, :s]}, state)

        def step(st, tok):
            lg, st = rmodel.decode_step(params, tok[:, None], st)
            return st, lg

        state, decoded = lax.scan(step, state, toks[:, s:].T)
        return params, logits, pl, decoded, state

    return jax.jit(run, static_argnums=3), box


S_PROMPT, N_DECODE = 41, 4


@functools.lru_cache(maxsize=None)
def _reference(name):
    """One arch, reduced, float32: the reference's weights (its Model.init
    at PRNGKey(0)), specs, state layout, logits, prefill and four decode
    steps with the state after them, on a fixed stream of 45 tokens."""
    cfg = _arch_cfg(name)
    rmodel = RModel(cfg)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, S_PROMPT + N_DECODE)).astype(np.int32)
    state = rmodel.init_decode_state(2, 64, cache_dtype=jnp.float32)
    run, box = _serve(rmodel, init=True)
    rparams, logits, pl, decoded, final = run(jax.random.PRNGKey(0), jnp.asarray(toks), state, N_DECODE)
    ref = {"logits": np.asarray(logits), "prefill": np.asarray(pl), "decode": np.asarray(decoded),
           "specs": box["specs"], "init_state": {k: v for k, v in state.items() if k != "pos"},
           "state": {k: v for k, v in final.items() if k != "pos"}}
    return cfg, rparams, toks, ref


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_run(request):
    cfg, rparams, toks, ref = _reference(request.param)
    return Model(cfg, device="cpu"), params_from_numpy(rparams, device="cpu"), toks, ref


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def test_groups_logits_and_hidden_match_reference(arch_run):
    model, params, toks, ref = arch_run
    kinds = {"xlstm_pair", "xlstm_m", "hymba"}
    assert len(model.groups) == 1 and model.groups[0].kind in kinds
    got = model.logits(params, {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and got.shape == ref["logits"].shape
    assert rel(got, ref["logits"]) <= REL_TOL
    x, aux = model.hidden(params, {"tokens": _t(toks)})
    assert x.shape == toks.shape + (model.cfg.d_model,) and float(aux) == 0.0


def test_init_specs_and_state_layout_match_reference(arch_run):
    """``init``'s specs and leaf shapes, and ``init_decode_state``'s tree
    (types, shapes, dtypes and the -1e30 sentinels), are the reference's."""
    model, params, toks, ref = arch_run
    got, specs = model.init(torch.Generator().manual_seed(0))
    assert _flat(specs) == _flat(ref["specs"])
    assert {k: tuple(v.shape) for k, v in _flat(got).items()} == {k: tuple(v.shape) for k, v in _flat(params).items()}
    state = model.init_decode_state(2, 64, cache_dtype=torch.float32)
    assert state["pos"] == 0 and set(state) - {"pos"} == set(ref["init_state"])
    for name, exp in ref["init_state"].items():
        assert type(state[name]).__name__ == type(exp).__name__
        for g, e in zip(leaves(state[name]), leaves(exp)):
            assert tuple(g.shape) == e.shape and str(g.dtype).split(".")[1] == str(e.dtype)
            assert np.array_equal(g.numpy(), np.asarray(e))


def test_prefill_and_decode_match_reference(arch_run):
    """Prefill + four decode steps: the reference's logits and its state
    after them (every leaf written back into the stacks), and the whole
    sequence's logits."""
    model, params, toks, ref = arch_run
    state = model.init_decode_state(2, 64, cache_dtype=torch.float32)
    state, pl = model.prefill(params, {"tokens": _t(toks[:, :S_PROMPT])}, state)
    assert rel(pl, ref["prefill"]) <= REL_TOL
    assert state["pos"] == S_PROMPT + model.cfg.meta_tokens
    for t in range(N_DECODE):
        lg, state = model.decode_step(params, _t(toks[:, S_PROMPT + t:S_PROMPT + t + 1]), state)
        assert rel(lg, ref["decode"][t]) <= REL_TOL, t
        assert rel(lg, ref["logits"][:, S_PROMPT + t]) <= 1e-4, t
    for name, exp in ref["state"].items():
        assert_states(state[name], exp, tol=1e-4)


@pytest.mark.parametrize("name", ["xlstm-1.3b", "hymba-1.5b"])
def test_bfloat16_model_matches_reference(name):
    """In bfloat16 (every float leaf rounded to bf16 by ``_cast``:
    ``a_log``, ``dt_bias``, ``dskip``, the sLSTM's ``r``, the norms) on
    the float32 fixture's weights, against the reference: a prefill and
    a decode step, at 2e-2."""
    cfg, rparams, _, _ = _reference(name)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 38)).astype(np.int32)
    run, _ = _serve(RModel(cfg), whole=False)
    _, _, rpl, rlg, _ = run(rparams, jnp.asarray(toks), RModel(cfg).init_decode_state(2, 48), 1)

    model = Model(cfg, device="cpu")
    params = params_from_numpy(rparams, device="cpu", dtype=torch.bfloat16)
    state = model.init_decode_state(2, 48)
    state, pl = model.prefill(params, {"tokens": _t(toks[:, :-1])}, state)
    assert rel(pl, rpl) <= BF16_TOL
    lg, _ = model.decode_step(params, _t(toks[:, -1:]), state)
    assert rel(lg, rlg[0]) <= BF16_TOL


def test_init_draws_one_layer_at_a_time_in_the_compute_dtype():
    """The stacks are drawn layer by layer (each its own draw), cast slice
    by slice; the deterministic leaves are the reference's values."""
    cfg = get_config("hymba-1.5b", reduced=True)
    model = Model(cfg, device="cpu")
    p32, _ = model.init(torch.Generator().manual_seed(3))
    p16, _ = model.init(torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    a, b = p32["hymba"]["mamba"]["wdt"], p16["hymba"]["mamba"]["wdt"]
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)
    assert not torch.equal(a[0], a[1])
    di, n = p32["hymba"]["mamba"]["a_log"].shape[1:]
    mamba = {k: p32["hymba"]["mamba"][k][1].numpy() for k in ("dt_bias", "a_log", "dskip")}
    # the reference's expressions (repro/models/ssm.py init_mamba)
    assert np.array_equal(mamba["dt_bias"], np.asarray(jnp.zeros((di,), jnp.float32) + jnp.log(jnp.expm1(0.01))))
    assert np.array_equal(mamba["dskip"], np.ones(di, np.float32))
    a_log = jnp.log(jnp.broadcast_to(jnp.arange(1, n + 1, dtype=jnp.float32), (di, n)))
    assert rel(mamba["a_log"], a_log) <= 1e-7  # neither library's float32 log rounds exactly
    assert torch.isfinite(model.logits(p16, {"tokens": torch.arange(6)[None]})).all()
