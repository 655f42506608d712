"""The port's encoder-decoder (whisper) against the reference on the
same numpy inputs and the reference's own weights: the cross-attention
in the decoder block, the encoder block, and ``Model``'s hidden / logits
/ prefill (the encoder once, every layer's cross K/V in
``state["cross"]``) / decode, at ``whisper_medium.reduced()`` (2 encoder
+ 2 decoder layers, d_model 64), in float32 (1e-5 relative to the
largest entry) and bfloat16 (2e-2); the reference's prefill / decode
consistency form (``tests/test_models_smoke.py``); and the model on
``SimMesh(2)`` and ``SimMesh(4)`` (heads and ``d_ff`` split; an odd
vocabulary whole) within 1e-5 of one rank. The reference's calls are
jitted, its weights made by its ``Model.init`` under jit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models.model import Model as RModel
from repro_torch.configs import get_config
from repro_torch.core import SimMesh
from repro_torch.models import blocks as B
from repro_torch.models.model import Model, params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

ARCH = "whisper-medium"
REL_TOL = 1e-5
BF16_TOL = 2e-2
B_, S_ENC, S_DEC, N_DECODE = 2, 24, 6, 2


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B_, S_ENC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B_, S_DEC + N_DECODE)).astype(np.int32)
    return enc, toks


def _ref_run(rmodel, dtype_params=None):
    """One jitted reference run: hidden and logits of the whole decoder
    sequence, a prefill of its first S_DEC tokens and N_DECODE decode
    steps (float32 cache), the state's cross K/V."""
    def run(params, enc, toks):
        batch = {"enc_embeds": enc, "tokens": toks}
        hidden, _ = rmodel.hidden(params, batch)
        logits = rmodel.logits(params, batch)
        state = rmodel.init_decode_state(B_, S_DEC + N_DECODE, cache_dtype=jnp.float32)
        state, pl = rmodel.prefill(params, {"enc_embeds": enc, "tokens": toks[:, :S_DEC]}, state)
        cross = state["cross"]
        steps = []
        for t in range(N_DECODE):
            lg, state = rmodel.decode_step(params, toks[:, S_DEC + t:S_DEC + t + 1], state)
            steps.append(lg)
        return hidden, logits, pl, jnp.stack(steps), cross

    return jax.jit(run)


@pytest.fixture(scope="module")
def ref():
    cfg = dataclasses.replace(r_get_config(ARCH, reduced=True), dtype="float32")
    rmodel = RModel(cfg)
    rparams = jax.jit(lambda key: rmodel.init(key)[0])(jax.random.PRNGKey(0))
    enc, toks = _inputs(cfg)
    out = _ref_run(rmodel)(rparams, jnp.asarray(enc), jnp.asarray(toks))
    return cfg, rparams, enc, toks, [np.asarray(a) if not isinstance(a, tuple) else tuple(map(np.asarray, a))
                                     for a in out]


def _run(model, params, enc, toks):
    """The port's hidden, logits, prefill, decode steps and cross K/V on
    the inputs of ``_ref_run``."""
    enc, toks = _t(enc), _t(toks)
    batch = {"enc_embeds": enc, "tokens": toks}
    hidden, aux = model.hidden(params, batch)
    assert float(aux) == 0.0
    logits = model.logits(params, batch)
    state = model.init_decode_state(B_, S_DEC + N_DECODE, cache_dtype=torch.float32)
    assert set(state) == {"pos", "decoder"}  # no state for the encoder; the cross K/V come with prefill
    state, pl = model.prefill(params, {"enc_embeds": enc, "tokens": toks[:, :S_DEC]}, state)
    assert state["pos"] == S_DEC
    cross = tuple(t.clone() for t in state["cross"])
    steps = []
    for t in range(N_DECODE):
        lg, state = model.decode_step(params, toks[:, S_DEC + t:S_DEC + t + 1], state)
        steps.append(lg)
    return hidden, logits, pl, torch.stack(steps), cross


@pytest.fixture(scope="module")
def port_run(ref):
    cfg, rparams, enc, toks, _ = ref
    model = Model(dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32"), device="cpu")
    params = params_from_numpy(rparams, device="cpu")
    return model, params, _run(model, params, enc, toks)


def test_groups_specs_and_leaves_match_reference(ref, port_run):
    """The encoder and the cross decoder groups; ``init``'s tree (``cross``
    and ``lnc`` in every decoder layer) and specs are the reference's."""
    cfg, rparams, _, _, _ = ref
    model, params, _ = port_run
    assert [(g.name, g.kind, g.count, g.cross) for g in model.groups] == [("encoder", "enc", 2, False),
                                                                          ("decoder", "dec", 2, True)]
    got, specs = model.init(torch.Generator().manual_seed(0))
    assert _flat(specs) == _flat(_ref_specs(cfg))
    shapes = {k: tuple(v.shape) for k, v in _flat(got).items()}
    assert shapes == {k: tuple(np.shape(v)) for k, v in _flat(rparams).items()}
    assert shapes["decoder/cross/wq"] == (2, 64, 64) and shapes["decoder/lnc/scale"] == (2, 64)


def _ref_specs(cfg):
    """The reference's specs, read while tracing its init (no weights made)."""
    box = {}

    def init(key):
        params, box["specs"] = RModel(cfg).init(key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["specs"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}".lstrip("/")).items()}
    return {prefix: tree}


@pytest.mark.parametrize("what", ["hidden", "logits", "prefill", "decode"])
def test_float32_matches_reference(ref, port_run, what):
    i = ["hidden", "logits", "prefill", "decode"].index(what)
    got, exp = port_run[2][i], ref[4][i]
    assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
    assert rel(got, exp) <= REL_TOL


def test_cross_kv_state_matches_reference(ref, port_run):
    """``state["cross"]``: the reference's (L, B, S_enc, KVH, hd) K and V,
    in the model's dtype (float32 here, beside a float32 cache)."""
    got, exp = port_run[2][4], ref[4][4]
    assert len(got) == len(exp) == 2
    for g, e in zip(got, exp):
        assert tuple(g.shape) == e.shape == (2, B_, S_ENC, 4, 16) and g.dtype == torch.float32
        assert rel(g, e) <= 1e-6


def test_cross_kv_is_the_models_dtype_in_bfloat16():
    cfg = get_config(ARCH, reduced=True)
    model = Model(cfg, device="cpu")
    params, _ = model.init(torch.Generator().manual_seed(2), dtype=torch.bfloat16)
    enc, toks = _inputs(cfg, 3)
    state = model.init_decode_state(B_, S_DEC + 1)
    state, _ = model.prefill(params, {"enc_embeds": _t(enc), "tokens": _t(toks[:, :S_DEC])}, state)
    assert isinstance(state["cross"], B.CrossKV) and state["cross"].k.dtype == torch.bfloat16
    assert state["decoder"].k.dtype == torch.bfloat16


def test_bfloat16_matches_reference(ref):
    """The bf16 model on the float32 fixture's weights (cast once): logits,
    a prefill and two decode steps (the default bf16 cache), within 2e-2."""
    cfg, rparams, enc, toks, _ = ref
    rcfg = dataclasses.replace(cfg, dtype="bfloat16")
    rmodel = RModel(rcfg)

    def run(params, enc, toks):
        batch = {"enc_embeds": enc, "tokens": toks}
        state = rmodel.init_decode_state(B_, S_DEC + N_DECODE)
        state, pl = rmodel.prefill(params, {"enc_embeds": enc, "tokens": toks[:, :S_DEC]}, state)
        lg, _ = rmodel.decode_step(params, toks[:, S_DEC:S_DEC + 1], state)
        return rmodel.logits(params, batch), pl, lg

    exp = [np.asarray(a) for a in jax.jit(run)(rparams, jnp.asarray(enc), jnp.asarray(toks))]
    model = Model(get_config(ARCH, reduced=True), device="cpu")
    params = params_from_numpy(rparams, device="cpu", dtype=torch.bfloat16)
    logits = model.logits(params, {"enc_embeds": _t(enc), "tokens": _t(toks)})
    state = model.init_decode_state(B_, S_DEC + N_DECODE)
    state, pl = model.prefill(params, {"enc_embeds": _t(enc), "tokens": _t(toks[:, :S_DEC])}, state)
    lg, _ = model.decode_step(params, _t(toks[:, S_DEC:S_DEC + 1]), state)
    for got, e in zip((logits, pl, lg), exp):
        assert rel(got, e) <= BF16_TOL


def test_prefill_decode_consistency(ref, port_run):
    """tests/test_models_smoke.py's form on the port: the prefill's logits
    within 2e-2 of the whole sequence's last, and a greedy decode step
    within 3e-2 of the whole sequence extended by its token."""
    model, params, _ = port_run
    cfg = model.cfg
    rng = np.random.default_rng(4)
    b, s = 2, 16
    batch = {"enc_embeds": _t(rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)),
             "tokens": _t(rng.integers(0, cfg.vocab_size, (b, s // 4)).astype(np.int32))}
    full = model.logits(params, batch)[:, -1]
    state = model.init_decode_state(b, 64, cache_dtype=torch.float32)
    state, pl = model.prefill(params, batch, state)
    assert float((pl - full).abs().max()) / (float(full.abs().max()) + 1e-9) < 2e-2
    nxt = torch.argmax(pl, -1).to(torch.int32)[:, None]
    lg, state = model.decode_step(params, nxt, state)
    ext = dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1))
    exp = model.logits(params, ext)[:, -1]
    assert float((lg - exp).abs().max()) / (float(exp.abs().max()) + 1e-9) < 3e-2
    assert torch.isfinite(lg).all()


@pytest.mark.parametrize("p", [2, 4])
def test_on_a_mesh_matches_one_rank(ref, port_run, p):
    """Model(cfg, SimMesh((1, p))): 4 heads and d_ff 128 split, the
    vocabulary of 256 split (each rank's block of the logits gathered);
    hidden runs the sequence-parallel rings on the encoder (24 frames) and
    the decoder (8 tokens), prefill and decode the psum form. Within 1e-5
    of one rank's on the same weights."""
    model, params, one = port_run
    cfg, _, enc, toks, _ = ref
    mesh_model = Model(model.cfg, SimMesh((1, p), axis_names=("data", "model"), device="cpu"), device="cpu")
    assert mesh_model.seq_parallel(S_ENC) and mesh_model.seq_parallel(S_DEC + N_DECODE)
    got = _run(mesh_model, params, enc, toks)
    for g, e in zip(got[:4], one[:4]):
        assert rel(g, e) <= REL_TOL
    for g, e in zip(got[4], one[4]):
        assert rel(g, e) <= REL_TOL


def test_odd_vocabulary_stays_whole_on_a_mesh():
    """whisper-medium's vocabulary (51865) is odd: on SimMesh(4) the
    embedding and unembedding stay whole while the heads split; the
    logits equal one rank's within 1e-5."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32", vocab_size=255)
    one = Model(cfg, device="cpu")
    params, _ = one.init(torch.Generator().manual_seed(5))
    mesh = Model(cfg, SimMesh(4, device="cpu"), device="cpu")
    assert not mesh.tp.splits(cfg.vocab_size) and mesh.tp.splits(cfg.num_heads)
    enc, toks = _inputs(cfg, 6)
    exp = _run(one, params, enc, toks)
    got = _run(mesh, params, enc, toks)
    for g, e in zip(got[1:4], exp[1:4]):
        assert rel(g, e) <= REL_TOL
