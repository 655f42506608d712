"""The port's one-rank training path against the reference on the same
numpy inputs: the data pipeline (bitwise), the LR schedule and AdamW
(1e-6), int8 compression (bitwise), the chunked cross-entropy and its
gradient, the flash and Mamba custom backward passes (against the
reference's ``jax.grad`` and against autograd through a plain version:
1e-5 in float32, 2e-2 in bfloat16), ``Model.loss`` and the gradient of
every leaf at reduced widths with the reference's weights carried across
(1e-5 of each leaf's largest reference gradient), ``_remat``, three
train steps, the microbatch step, a checkpoint written by the reference
and resumed here, and the train launcher with an injected failure. Then
the step over a model axis of 2 (``SimMesh((1, 2))``) against the
one-rank step, and through it the reference's; the rows a rank of a
batch axis trains on; the launcher's ``--model-parallel 2``. The
reference's calls are jitted; its weights come from its own ``init``
under jit."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_config as r_get_config
from repro.data import DataConfig as RDataConfig
from repro.data import Prefetcher as RPrefetcher
from repro.data import SyntheticLM as RSyntheticLM
from repro.models import attention as RA
from repro.models import losses as RL
from repro.models import ssm as RS
from repro.models.model import Model as RModel
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro.optim import schedule as rschedule
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import SimMesh
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM, make_batch_arrays
from repro_torch.models import attention as A
from repro_torch.models import losses as L
from repro_torch.models import ssm as S
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.optim import adamw, compress, schedule
from repro_torch.train import init_train_state, make_train_step, train_state_from_numpy
from torch_train_common import (SPLIT_ARCHS, SPLIT_SEQ, SPLIT_STEPS, assert_flat_params_match, assert_params_match,
                                 assert_split_matches, grad_noise, one_thread, split_batches, split_cfg, split_init,
                                 split_run, split_tcfg)
from torch_train_common import flat as _flat
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

REL_TOL = 1e-5
BF16_TOL = 2e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def rel(got, exp) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(jnp.asarray(exp, jnp.float32) if hasattr(exp, "dtype") and exp.dtype == jnp.bfloat16 else exp,
                     np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


# ------------------------------------------------------------------- data


def test_synthetic_batches_are_the_references_bitwise():
    cfg = dict(vocab_size=257, seq_len=24, global_batch=8, seed=3)
    for idx, count in ((0, 1), (0, 2), (1, 2), (3, 4)):
        ours = SyntheticLM(DataConfig(**cfg), process_index=idx, process_count=count)
        ref = RSyntheticLM(RDataConfig(**cfg), process_index=idx, process_count=count)
        for step in (0, 7, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32 and np.array_equal(a[k], b[k]), (idx, count, step, k)
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(**cfg), process_count=3)


def test_prefetcher_order_resume_and_device():
    ds = SyntheticLM(DataConfig(256, 32, 8))
    ref = RSyntheticLM(RDataConfig(256, 32, 8))
    pf = Prefetcher(ds, start_step=5, depth=2, device="cpu")
    rpf = RPrefetcher(ref, start_step=5, depth=2)
    try:
        for want in (5, 6, 7):
            (s, b), (rs, rb) = pf.next(), rpf.next()
            assert s == rs == want
            assert isinstance(b["tokens"], torch.Tensor) and np.array_equal(b["tokens"].numpy(), rb["tokens"])
    finally:
        pf.stop()
        rpf.stop()
    batch = make_batch_arrays(ds.batch_at(2), SimMesh((1, 1), axis_names=("data", "model"), device="cpu"))
    assert batch["labels"].dtype == torch.int32 and np.array_equal(batch["labels"].numpy(), ds.batch_at(2)["labels"])


# --------------------------------------------------------- schedule, AdamW


def test_warmup_cosine_and_constant_match_reference():
    kw = dict(peak=3e-3, warmup=10, total=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = schedule.warmup_cosine(step, **kw)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(rschedule.warmup_cosine(step, **kw))) <= 1e-6 * 3e-3, step
        assert float(schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)) == float(got)
    assert float(schedule.constant(3, peak=0.5)) == 0.5


def _tree(seed, scale=1.0):
    return {"a": _np(seed, 5, 7, scale=scale), "b": {"c": _np(seed + 1, 11, scale=scale), "d": _np(seed + 2, 3, 2)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_and_clip_match_reference(state_dtype):
    tcfg = TrainConfig(weight_decay=0.1, b1=0.9, b2=0.95)
    rtcfg = RTrainConfig(weight_decay=0.1, b1=0.9, b2=0.95)
    params = _tree(0)
    p, rp = jax.tree.map(_t, params), jax.tree.map(jnp.asarray, params)
    st, rst = adamw.init(p, state_dtype), radamw.init(rp, state_dtype)
    assert st.mu["a"].dtype == getattr(torch, state_dtype) and int(st.count) == 0
    rupd = jax.jit(functools.partial(radamw.update, cfg=rtcfg))
    for step in range(3):
        grads = _tree(10 + step, scale=30.0)
        g, gn = adamw.clip_by_global_norm(jax.tree.map(_t, grads), 1.0)
        rg, rgn = radamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
        assert abs(float(gn) - float(rgn)) <= 1e-6 * float(rgn)
        assert abs(float(adamw.global_norm(g)) - float(radamw.global_norm(rg))) <= 1e-6
        lr = schedule.warmup_cosine(step, peak=1e-2, warmup=1, total=10)
        p, st = adamw.update(g, st, p, lr=lr, cfg=tcfg, inplace=step == 2)
        rp, rst = rupd(rg, rst, rp, lr=rschedule.warmup_cosine(step, peak=1e-2, warmup=1, total=10))
    assert int(st.count) == int(rst.count) == 3
    for name, e in _flat(rp).items():
        assert rel(_flat(p)[name], e) <= 1e-6, name
    for got, exp in ((st.mu, rst.mu), (st.nu, rst.nu)):
        for name, e in _flat(exp).items():
            assert _flat(got)[name].dtype == getattr(torch, state_dtype)
            assert rel(_flat(got)[name], e) <= 1e-6, name
    small = {"a": torch.tensor([1e-3])}
    same, _ = adamw.clip_by_global_norm(small, 1.0)
    assert torch.equal(same["a"], small["a"])


# ------------------------------------------------------------- compression


def test_quantize_int8_is_the_references_bitwise():
    r = np.random.default_rng(0)
    cases = [r.standard_normal(257).astype(np.float32) * s for s in (1e-3, 1.0, 50.0)]
    cases.append(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 63.5, -64.5], np.float32))  # ties at .5
    cases.append(np.zeros(8, np.float32))
    for g in cases:
        q, s = compress.quantize_int8(_t(g))
        rq, rs = rcompress.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        assert np.array_equal(compress.dequantize_int8(q, s).numpy(), np.asarray(rcompress.dequantize_int8(rq, rs)))


def test_error_feedback_and_single_rank_compressed_psum():
    """The reference's own error-feedback check, and the one-rank
    ``compressed_psum`` against its shard_map on one device, bitwise."""
    g = torch.linspace(-1e-3, 1e-3, 32)
    err, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        with_fb = g + err
        q, s = compress.quantize_int8(with_fb)
        deq = compress.dequantize_int8(q, s)
        err, total = with_fb - deq, total + deq
    assert float((total - 50 * g).abs().max()) <= float(s) * 1.5
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.compat import shard_map

    x, e = _np(1, 6, 5), _np(2, 6, 5, scale=1e-3)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    fn = shard_map(lambda g, e: rcompress.compressed_psum(g, "data", e), mesh=mesh, in_specs=(P(), P()),
                   out_specs=(P(), P()), check_vma=False)
    rout, rerr = jax.jit(fn)(jnp.asarray(x), jnp.asarray(e))
    out, new = compress.compressed_psum([_t(x)], SimMesh(1, "data", device="cpu"), "data", [_t(e)])
    assert np.array_equal(out[0].numpy(), np.asarray(rout))
    # the residual g - q * scale: the reference's XLA may fuse it into one fma (one rounding of g's size)
    assert np.abs(new[0].numpy() - np.asarray(rerr)).max() <= 1e-6 * np.abs(x).max()
    trees, errs = compress.compressed_psum_tree([{"w": _t(x)}], SimMesh(1, "data", device="cpu"), "data",
                                                [compress.init_error_state({"w": _t(x)})])
    assert trees[0]["w"].shape == (6, 5) and errs[0]["w"].dtype == torch.float32


# ------------------------------------------------------------------ losses


def _unemb(d, v, seed):
    w = _np(seed, d, v)
    return w, (lambda x: x @ _t(w)), (lambda x: x @ jnp.asarray(w))


@pytest.mark.parametrize("seq_chunk", [4, 7, 16, 64])
def test_chunked_xent_matches_reference(seq_chunk):
    b, s, d, v = 2, 33, 8, 50
    x = _np(0, b, s, d)
    labels = np.random.default_rng(1).integers(0, v, (b, s)).astype(np.int32)
    labels[0, 5:9] = -1
    w, un, run = _unemb(d, v, 2)
    for cap in (0.0, 5.0):
        got = L.chunked_xent(_t(x), _t(labels), un, seq_chunk=seq_chunk, z_loss=1e-3, final_softcap=cap)
        exp = jax.jit(lambda x, l: RL.chunked_xent(x, l, run, seq_chunk=seq_chunk, z_loss=1e-3,
                                                   final_softcap=cap))(jnp.asarray(x), jnp.asarray(labels))
        full = L.full_xent(_t(x), _t(labels), un, z_loss=1e-3, final_softcap=cap)
        for a, e, f in zip(got, exp, full):
            assert abs(float(a) - float(e)) <= 1e-5 * abs(float(e)) and abs(float(f) - float(e)) <= 1e-5 * abs(float(e))


def test_chunked_xent_gradient_matches_reference():
    b, s, d, v = 2, 12, 6, 25
    x, w = _np(3, b, s, d), _np(4, d, v)
    labels = np.random.default_rng(5).integers(0, v, (b, s)).astype(np.int32)
    labels[1, :3] = -1
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    nll, zl = L.chunked_xent(xt, _t(labels), lambda h: h @ wt, seq_chunk=5, z_loss=1e-2, final_softcap=4.0)
    got = torch.autograd.grad(nll + zl, (xt, wt))

    def f(x, w):
        a, z = RL.chunked_xent(x, jnp.asarray(labels), lambda h: h @ w, seq_chunk=5, z_loss=1e-2, final_softcap=4.0)
        return a + z

    exp = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    for a, e in zip(got, exp):
        assert rel(a, e) <= REL_TOL


# ----------------------------------------------------------- flash backward

FLASH_SPECS = {
    "causal": A.AttnSpec(),
    "window+prefix": A.AttnSpec(window=6, prefix=3),
    "softcap": A.AttnSpec(softcap=5.0),
    "full": A.AttnSpec(causal=False),
}


def _flash_inputs(seed, dv=8, dtype=np.float32):
    return _np(seed, 2, 19, 4, 8).astype(dtype), _np(seed + 1, 2, 19, 2, 8).astype(dtype), \
        _np(seed + 2, 2, 19, 2, dv).astype(dtype)


@functools.lru_cache(maxsize=None)
def _flash_ref(name, dv, bf16):
    spec = FLASH_SPECS[name]
    rspec = RA.AttnSpec(*spec)
    q, k, v = _flash_inputs(7, dv)
    w = _np(9, 2, 19, 4, dv)
    dt = jnp.bfloat16 if bf16 else jnp.float32

    def f(q, k, v):
        out = RA.flash_attention_train(q, k, v, rspec, kv_chunk=5)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a, dt) for a in (q, k, v)))
    return (q, k, v, w), out, grads


@pytest.mark.parametrize("name,dv", [(n, 8) for n in FLASH_SPECS] + [("causal", 6)])
def test_flash_backward_matches_reference_and_naive(name, dv):
    """``dv != d`` is MLA's shape (values narrower than the keys)."""
    spec = FLASH_SPECS[name]
    (q, k, v, w), rout, rgrads = _flash_ref(name, dv, False)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = A.attention(qt, kt, vt, spec, impl="chunked", kv_chunk=5)
    assert torch.equal(out.detach(), A.attention_chunked(*(_t(a) for a in (q, k, v)), spec, kv_chunk=5))
    got = torch.autograd.grad((out * _t(w)).sum(), (qt, kt, vt))
    qn, kn, vn = (_t(a).requires_grad_() for a in (q, k, v))
    naive = torch.autograd.grad((A.attention_naive(qn, kn, vn, spec) * _t(w)).sum(), (qn, kn, vn))
    assert rel(out, rout) <= REL_TOL
    for a, e, n in zip(got, rgrads, naive):
        assert rel(a, e) <= REL_TOL and rel(a, n.numpy()) <= REL_TOL


@pytest.mark.parametrize("name", ["causal", "softcap"])
def test_flash_backward_bfloat16_matches_reference(name):
    (q, k, v, w), _, rgrads = _flash_ref(name, 8, True)
    ts = [_t(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]
    out = A.flash_attention_train(*ts, FLASH_SPECS[name], kv_chunk=5)
    got = torch.autograd.grad((out.float() * _t(w)).sum(), ts)
    for a, e in zip(got, rgrads):
        assert a.dtype == torch.bfloat16 and rel(a, e) <= BF16_TOL


# ----------------------------------------------------------- Mamba backward


def _mamba_inputs(seed, s=24, b=2, d=6, n=4):
    xc, dt = _np(seed, b, s, d), np.abs(_np(seed + 1, b, s, d, scale=0.3))
    bm, cm = _np(seed + 2, b, s, n), _np(seed + 3, b, s, n)
    a = -np.exp(_np(seed + 4, d, n, scale=0.5))
    dskip, h0 = _np(seed + 5, d), _np(seed + 6, b, d, n, scale=0.5)
    wy, wh = _np(seed + 7, b, s, d), _np(seed + 8, b, d, n)
    return (xc, dt, bm, cm, a, dskip, h0), (wy, wh)


def _sequential(xc, dt, bm, cm, a, dskip, h):
    """The recurrence one step at a time, no in-place writes."""
    ys = []
    for t in range(xc.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * xc[:, t])[..., None] * bm[:, t, None, :]
        ys.append((h * cm[:, t, None, :]).sum(-1) + dskip * xc[:, t])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("low", [False, True])
def test_mamba_backward_matches_reference_and_sequential(low):
    """``low``: ``a`` and ``dskip`` in bfloat16, as a bfloat16 model's
    cast leaves reach the core (their cotangents come back bfloat16)."""
    args, (wy, wh) = _mamba_inputs(3)
    ldt = (torch.bfloat16, jnp.bfloat16) if low else (torch.float32, jnp.float32)
    rargs = [jnp.asarray(x, ldt[1] if i in (4, 5) else jnp.float32) for i, x in enumerate(args)]

    def f(*xs):
        y, hl = RS.mamba_core(*xs, chunk=8)
        return jnp.sum(y * wy) + jnp.sum(hl * wh)

    rgrads = jax.jit(jax.grad(f, argnums=tuple(range(7))))(*rargs)
    ts = [_t(x).to(ldt[0] if i in (4, 5) else torch.float32).requires_grad_() for i, x in enumerate(args)]
    y, hl = S.mamba_core(*ts, chunk=8)
    got = torch.autograd.grad((y * _t(wy)).sum() + (hl * _t(wh)).sum(), ts)
    plain = [_t(x).requires_grad_() for x in args]
    ys, hs = _sequential(*plain)
    seq = torch.autograd.grad((ys * _t(wy)).sum() + (hs * _t(wh)).sum(), plain)
    tol = BF16_TOL if low else REL_TOL
    for i, (a, e, p) in enumerate(zip(got, rgrads, seq)):
        assert a.dtype == ts[i].dtype, i
        assert rel(a, e) <= tol and rel(a, p) <= tol, (i, rel(a, e), rel(a, p))


# ------------------------------------------------------- Model.loss, grads

LOSS_ARCHS = {
    "qwen2.5-32b": {},
    "gemma2-9b": {},
    "deepseek-v3-671b": {},
    "hymba-1.5b": dict(num_layers=4),
    "xlstm-1.3b": {},
    "whisper-medium": {},
}


def _cfg(arch, **kw):
    return dataclasses.replace(r_get_config(arch, reduced=True), **{"dtype": "float32", **LOSS_ARCHS[arch], **kw})


def _batch(cfg, seed=0, b=2, s=40):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    if cfg.is_encdec:
        batch["enc_embeds"] = _np(seed + 1, b, 24, cfg.d_model)
    return batch


@functools.lru_cache(maxsize=None)
def _loss_ref(arch):
    cfg = _cfg(arch)
    rmodel = RModel(cfg)
    batch = _batch(cfg)

    def run(key, batch):
        params, _ = rmodel.init(key)
        (loss, metrics), grads = jax.value_and_grad(rmodel.loss, has_aux=True)(params, batch)
        return params, metrics, grads

    params, metrics, grads = jax.jit(run)(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch))
    return cfg, batch, params, metrics, grads


@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_model_loss_and_every_gradient_match_reference(arch):
    """Every leaf's gradient within 1e-5 of that leaf's largest reference
    gradient. Hymba at 4 layers: layer 1 windowed past its reduced window
    with the meta tokens; DeepSeek-V3: MLA, the MoE router's aux loss and
    MTP; whisper: the encoder and the cross-attention."""
    cfg, batch, rparams, rmetrics, rgrads = _loss_ref(arch)
    model = Model(cfg, device="cpu")
    params = params_from_numpy(rparams, device="cpu")
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, {k: _t(v) for k, v in batch.items()})
    assert sorted(metrics) == sorted(rmetrics)
    for k, e in rmetrics.items():
        got_k = float(metrics[k].detach())
        assert abs(got_k - float(e)) <= REL_TOL * max(abs(float(e)), 1e-3), (k, got_k, float(e))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    got = dict(zip(_flat(params), grads))
    for name, e in _flat(rgrads).items():
        g = got[name]
        if np.abs(np.asarray(e)).max() == 0:
            assert g is None or float(g.abs().max()) == 0, name
            continue
        assert rel(g, e) <= REL_TOL, (name, rel(g, e))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v3-671b"])
def test_remat_modes_give_the_same_gradients(arch):
    cfg, batch, rparams, _, _ = _loss_ref(arch)
    out = {}
    for mode in ("full", "dots", "none"):
        model = Model(dataclasses.replace(cfg, remat=mode), device="cpu")
        params = params_from_numpy(rparams, device="cpu")
        flat = [p.requires_grad_(True) for p in adamw.leaves(params)]
        loss, _ = model.loss(params, {k: _t(v) for k, v in batch.items()})
        out[mode] = (loss.detach(), torch.autograd.grad(loss, flat))
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30), mode


def test_serving_records_no_graph():
    cfg, batch, rparams, _, _ = _loss_ref("qwen2.5-32b")
    model = Model(cfg, device="cpu")
    params = params_from_numpy(rparams, device="cpu")
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    toks = _t(batch["tokens"])
    assert not model.logits(params, {"tokens": toks}).requires_grad
    state, logits = model.prefill(params, {"tokens": toks}, model.init_decode_state(2, 48, cache_dtype=torch.float32))
    assert not logits.requires_grad
    assert model.hidden(params, {"tokens": toks})[0].requires_grad


# ------------------------------------------------------------- train steps

STEP_ARCH = "qwen2.5-32b"
N_STEPS = 3


def _tcfg(cls, **kw):
    return cls(learning_rate=1e-2, warmup_steps=2, total_steps=10, **kw)


@pytest.fixture(scope="module")
def step_ref(tmp_path_factory):
    """The reference's TrainState at init (jitted), three jitted steps on
    SyntheticLM batches with their metrics and the gradients each step
    took, and a checkpoint of the state after the first step (its
    CheckpointManager)."""
    cfg = dataclasses.replace(r_get_config(STEP_ARCH, reduced=True), dtype="float32")
    rmodel = RModel(cfg)
    tcfg = _tcfg(RTrainConfig)
    state0 = jax.jit(lambda k: r_init_train_state(rmodel, k, tcfg)[0])(jax.random.PRNGKey(0))
    ds = RSyntheticLM(RDataConfig(cfg.vocab_size, 16, 4, seed=1))
    step = jax.jit(r_make_train_step(rmodel, tcfg, None))
    grad = jax.jit(jax.grad(lambda p, b: rmodel.loss(p, b)[0]))
    ckdir = str(tmp_path_factory.mktemp("ref_ckpt"))
    mgr = RCheckpointManager(ckdir, keep=3)
    state, states, metrics, grads = state0, [], [], []
    for s in range(N_STEPS):
        batch = jax.tree.map(jnp.asarray, ds.batch_at(s))
        grads.append(_flat(jax.tree.map(np.asarray, grad(state.params, batch))))
        state, m = step(state, batch)
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
        if s == 0:
            mgr.save(1, state, blocking=True)
    return cfg, jax.tree.map(np.asarray, state0), states, metrics, ckdir, grads


def test_train_steps_match_reference(step_ref):
    cfg, state0, states, metrics, _, grads = step_ref
    model = Model(dataclasses.replace(get_config(STEP_ARCH, reduced=True), dtype="float32"), device="cpu")
    state = train_state_from_numpy(state0, "cpu")
    step = make_train_step(model, _tcfg(TrainConfig))
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    lrs = [m["lr"] for m in metrics]
    for s in range(N_STEPS):
        state, m = step(state, make_batch_arrays(ds.batch_at(s), device="cpu"))
        assert sorted(m) == sorted(metrics[s])
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - metrics[s][k]) <= 1e-6 * max(abs(metrics[s][k]), 1.0), (s, k)
        assert_params_match(state.params, states[s].params, REL_TOL, lrs[:s + 1], grad_noise(grads[:s + 1]))
    assert int(state.step) == int(state.opt.count) == N_STEPS


def test_reference_checkpoint_resumes_here(step_ref, tmp_path):
    """The reference's TrainState checkpoint (after step 1) restores into
    the port's TrainState, and one more step matches the reference's;
    the port's own checkpoint of that state names the same leaves."""
    cfg, _, states, metrics, ckdir, grads = step_ref
    model = Model(dataclasses.replace(get_config(STEP_ARCH, reduced=True), dtype="float32"), device="cpu")
    tcfg = _tcfg(TrainConfig)
    target, _ = init_train_state(model, torch.Generator().manual_seed(5), tcfg)
    step_no, state = CheckpointManager(ckdir).restore_latest(target)
    assert step_no == 1 and int(state.step) == 1 and state.step.dtype == torch.int32
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    state, m = make_train_step(model, tcfg)(state, make_batch_arrays(ds.batch_at(1), device="cpu"))
    assert abs(float(m["loss"]) - metrics[1]["loss"]) <= 1e-6 * metrics[1]["loss"]
    assert_params_match(state.params, states[1].params, REL_TOL, [metrics[1]["lr"]], grad_noise(grads[1:2]))
    mine = CheckpointManager(str(tmp_path))
    mine.save(2, state, blocking=True)
    back = RCheckpointManager(str(tmp_path)).restore(2, states[1])
    for name, e in _flat(back.params).items():
        assert np.array_equal(np.asarray(e), _flat(state.params)[name].numpy()), name


def test_microbatch_step_matches_the_whole_batch():
    """The reference's system test: gradient accumulation over 4
    microbatches against the one-batch step (< 5e-4), here beside the
    reference's own microbatch step."""
    cfg = dataclasses.replace(get_config("nemotron-4-15b", reduced=True), dtype="float32")
    model = Model(cfg, device="cpu")
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 16, 8, seed=2))
    batch = make_batch_arrays(ds.batch_at(0), device="cpu")
    out = {}
    for micro in (0, 4):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, microbatch=micro)
        state, _ = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
        out[micro] = make_train_step(model, tcfg)(state, batch)
    worst = max(float((a - b).abs().max()) for a, b in zip(adamw.leaves(out[0][0].params),
                                                          adamw.leaves(out[4][0].params)))
    assert worst < 5e-4, worst
    assert sorted(out[4][1]) == ["grad_norm", "loss", "lr"]
    assert abs(float(out[4][1]["loss"]) - float(out[0][1]["loss"])) < 1e-3


def test_a_rank_trains_on_each_microbatchs_block_of_rows():
    """Over ``('pod', 'data')`` axes of processes a rank trains on, in each
    microbatch, that microbatch's block of rows at its coordinate -- the
    reference's ``_split_micro`` first, then the jit's data shard of each
    microbatch, the groups its MoE dispatch counts capacity on -- not its
    own contiguous block of the whole batch. A batch the axes do not
    split raises. A step over a mesh must be the model's own."""
    from repro.train.step import _split_micro as r_split_micro
    from repro_torch.train.step import microbatch_rows

    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3), "labels": -torch.arange(8)[:, None].repeat(1, 3)}
    rows = microbatch_rows(batch, 2, index=1, count=2)
    ref = r_split_micro({k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 2)
    for i, got in enumerate(rows):
        for k in batch:
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k][i])[2:4]), (i, k)
    assert [r["tokens"][:, 0].tolist() for r in rows] == [[2, 3], [6, 7]]
    assert [r["tokens"][:, 0].tolist() for r in microbatch_rows(batch, 0, 1, 2)] == [[4, 5, 6, 7]]
    assert [r["tokens"][:, 0].tolist() for r in microbatch_rows(batch, 4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="do not split"):
        microbatch_rows(batch, 2, 0, 3)
    with pytest.raises(ValueError, match="the model's mesh"):
        make_train_step(Model(get_config(STEP_ARCH, reduced=True), device="cpu"), TrainConfig(),
                        SimMesh((1, 2), axis_names=("data", "model"), device="cpu"))


# ------------------------------------------------- the step over a model axis


def _split_state(arch, step_ref):
    """The initial numpy state: the reference's for STEP_ARCH (through the
    one-rank step, the split step is held to the reference), the port's
    seeded init for the others."""
    return step_ref[1] if arch == STEP_ARCH else split_init(arch)[0]


@pytest.mark.parametrize("arch,micro", [(a, 0) for a in SPLIT_ARCHS] + [(STEP_ARCH, 2)])
def test_split_step_on_sim_mesh_matches_one_rank(step_ref, arch, micro):
    """``make_train_step`` on ``Model(cfg, SimMesh((1, 2)))`` against the
    one-rank step from the same state, SPLIT_STEPS steps in float32: every
    leaf's gradient within 1e-5 of its largest one-rank entry at every
    step, loss and gradient norm within 1e-6 relative, the parameters
    within 1e-5 (and Adam's amplification of the gradients'
    disagreement). SPLIT_ARCHS: sequence parallelism (qwen, mixtral), the
    einsum MoE dispatch with split experts (mixtral), hymba's context
    partition beside Mamba's channels;
    ``micro``: 2 microbatches. For STEP_ARCH the split step also meets
    the reference's step (its metrics and parameters, ``step_ref``)."""
    cfg = split_cfg(arch)
    state_np, tcfg, batches = _split_state(arch, step_ref), split_tcfg(microbatch=micro), split_batches(cfg)
    mesh = SimMesh((1, 2), axis_names=("data", "model"), device="cpu")
    model = Model(cfg, mesh, device="cpu")
    assert model.seq_parallel(SPLIT_SEQ) == (arch != "hymba-1.5b")  # the hybrid keeps its activations whole
    assert A.use_context_parallel(cfg, model.tp) == (arch == "hymba-1.5b")
    with one_thread():
        one = split_run(Model(cfg, device="cpu"), state_np, batches, tcfg)
        got = split_run(model, state_np, batches, tcfg)
    lrs = [m["lr"] for m in one[1]]
    assert_split_matches(got, one, lrs)
    if arch == STEP_ARCH and not micro:
        _, _, states, metrics, _, rgrads = step_ref
        for s in range(SPLIT_STEPS):
            for k in ("loss", "grad_norm"):
                assert abs(got[1][s][k] - metrics[s][k]) <= 1e-6 * metrics[s][k], (s, k)
        assert_flat_params_match(got[2], _flat(states[SPLIT_STEPS - 1].params), REL_TOL, lrs,
                                 grad_noise(rgrads[:SPLIT_STEPS]))


# ----------------------------------------------------------------- launcher


def test_train_launcher_recovers_from_an_injected_failure(tmp_path):
    """The port of the reference's system test: 12 steps, checkpoints every
    4, a failure injected at step 6, one restart from step 4. The resumed
    run ends bitwise where the same 12 steps without a failure end: the
    asynchronous checkpoint writes hold copies, not the state that the
    next steps update in place."""
    from repro_torch.launch.train import build_argparser, train

    def run(name, *extra):
        args = build_argparser().parse_args([
            "--arch", "phi3-medium-14b", "--reduced", "--steps", "12", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path / name), "--ckpt-every", "4", "--device", "cpu", *extra,
        ])
        assert args.reduced
        return train(args), np.load(tmp_path / name / "step_0000000012" / "proc0.npz")

    assert build_argparser().parse_args(["--arch", "x"]).ckpt_dir is None
    assert build_argparser().parse_args(["--arch", "x"]).reduced is False
    hist, failed = run("failed", "--fail-at", "6")
    assert hist["restarts"] == 1
    assert len(hist["loss"]) >= 12 and np.isfinite(hist["loss"]).all()
    assert sorted(CheckpointManager(str(tmp_path / "failed")).valid_steps()) == [4, 8, 12]
    clean_hist, clean = run("clean")
    assert clean_hist["restarts"] == 0 and hist["loss"][-6:] == clean_hist["loss"][-6:]
    assert sorted(failed.files) == sorted(clean.files)
    for name in clean.files:
        assert np.array_equal(failed[name], clean[name]), name


def test_train_launcher_model_parallel_matches_one_rank(tmp_path, monkeypatch):
    """``--model-parallel 2`` trains on a ``SimMesh((1, 2))`` (what
    ``make_local_mesh`` builds: the departure of ROADMAP queue C) with the
    losses of ``--model-parallel 1``: within 1e-5 in float32, and within
    2e-3 in the reduced config's own bfloat16, where the split products'
    sums round in another order (4e-4 measured)."""
    import repro_torch.launch.train as launch
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, "cpu")
    assert isinstance(mesh, SimMesh) and mesh.shape == {"data": 1, "model": 2}

    def run(mp, name):
        args = launch.build_argparser().parse_args([
            "--arch", STEP_ARCH, "--reduced", "--steps", "4", "--batch", "4", "--seq", "16", "--model-parallel",
            str(mp), "--ckpt-dir", str(tmp_path / f"{name}{mp}"), "--device", "cpu"])
        hist = launch.train(args)
        assert hist["restarts"] == 0 and len(hist["loss"]) == 4
        return hist["loss"]

    for name, tol in (("bfloat16", 2e-3), ("float32", 1e-5)):
        if name == "float32":
            get = launch.get_config
            monkeypatch.setattr(launch, "get_config", lambda *a, **k: dataclasses.replace(get(*a, **k),
                                                                                        dtype="float32"))
        with one_thread():
            one, two = run(1, name), run(2, name)
        assert all(abs(a - b) <= tol * abs(b) for a, b in zip(two, one)), (name, one, two)
