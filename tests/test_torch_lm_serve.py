"""The port's LM ``ServeEngine`` and ``launch/serve.py`` against the
reference's: the streams of ``tests/test_serve.py`` run through both
engines on the reference's weights give identical greedy tokens, as does
an idle slot whose cache length runs past the cache (two ``run()`` calls
on one engine) -- for Qwen2.5, for the MoE archs (Mixtral, DeepSeek-V3
with its MLA latent cache), capacity drops included, and for the SSM and
hybrid archs (xLSTM, hymba: nested state trees). The reference is imported inside fixtures, so the
``cuda``-marked cases also run on a GPU machine without jax
(``pytest -m cuda tests/test_torch_lm_serve.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ServeConfig, get_config
from repro_torch.launch import serve as launch
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serve import ServeEngine
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

ARCH = "qwen2.5-32b"
MOE = ["mixtral-8x22b", "deepseek-v3-671b"]
SSM = ["xlstm-1.3b", "hymba-1.5b"]


def _reference(arch, **moe):
    """The reference engine's module, model and weights (float32; its init
    under jit, bitwise the eager init's at a third of the time);
    ``moe`` overrides MoEConfig fields."""
    jax = pytest.importorskip("jax")
    from repro.configs import ServeConfig as RServeConfig
    from repro.configs import get_config as r_get_config
    from repro.models import Model as RModel
    from repro.serve import ServeEngine as RServeEngine

    cfg = dataclasses.replace(r_get_config(arch, reduced=True), dtype="float32")
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    model = RModel(cfg, attn_impl="chunked")
    params = jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0))
    return RServeEngine, RServeConfig, model, params


def _port_of(ref):
    """The port's model on the reference's config and weights."""
    return Model(ref[2].cfg, attn_impl="chunked", device="cpu"), params_from_numpy(ref[3], device="cpu")


@pytest.fixture(scope="module")
def ref():
    return _reference(ARCH)


@pytest.fixture(scope="module")
def port(ref):
    return _port_of(ref)


@pytest.fixture(scope="module", params=MOE)
def moe_ref(request):
    return _reference(request.param)


@pytest.fixture(scope="module")
def moe_port(moe_ref):
    return _port_of(moe_ref)


@pytest.fixture(scope="module", params=SSM)
def ssm_ref(request):
    return _reference(request.param)


@pytest.fixture(scope="module")
def ssm_port(ssm_ref):
    return _port_of(ssm_ref)


def both(ref, port, prompts_runs, **scfg):
    """Serve each list of prompts in ``prompts_runs`` in turn on one
    reference engine and one port engine; returns both result lists."""
    r_engine_cls, r_scfg_cls, rmodel, rparams = ref
    r_eng = r_engine_cls(rmodel, rparams, r_scfg_cls(**scfg))
    eng = ServeEngine(port[0], port[1], ServeConfig(**scfg))
    got, exp = [], []
    for prompts, max_new in prompts_runs:
        exp.append(r_eng.run(prompts, max_new=max_new))
        got.append(eng.run(prompts, max_new=max_new))
    return got, exp, eng


def _vocab(port):
    return port[0].cfg.vocab_size


def test_single_request(ref, port):
    prompt = np.arange(5, dtype=np.int32) % _vocab(port)
    (got,), (exp,), _ = both(ref, port, [([prompt], 6)], max_batch=2, max_seq=64)
    assert got == exp and len(got) == 1
    (tokens,) = got.values()
    assert len(tokens) == 6 and all(0 <= t < _vocab(port) for t in tokens)


def test_batched_matches_single(ref, port):
    """A request decoded alongside others equals its solo decode (slot
    isolation: per-row cache lengths), in both packages."""
    v = _vocab(port)
    pa = (np.arange(7) * 3 % v).astype(np.int32)
    pb = (np.arange(4) * 5 % v).astype(np.int32)
    (solo,), (r_solo,), _ = both(ref, port, [([pa], 5)], max_batch=2, max_seq=64)
    (pair,), (r_pair,), _ = both(ref, port, [([pa, pb], 5)], max_batch=2, max_seq=64)
    assert solo == r_solo and pair == r_pair
    assert pair[0] == list(solo.values())[0]


def test_more_requests_than_slots(ref, port):
    prompts = [(np.arange(3 + i) % _vocab(port)).astype(np.int32) for i in range(5)]
    (got,), (exp,), _ = both(ref, port, [(prompts, 4)], max_batch=2, max_seq=64)
    assert got == exp and len(got) == 5 and all(len(v) == 4 for v in got.values())


def test_greedy_deterministic(port):
    p = (np.arange(6) % _vocab(port)).astype(np.int32)
    r1 = ServeEngine(port[0], port[1], ServeConfig(max_batch=1, max_seq=64)).run([p], max_new=5)
    r2 = ServeEngine(port[0], port[1], ServeConfig(max_batch=1, max_seq=64)).run([p], max_new=5)
    assert list(r1.values()) == list(r2.values())


def test_idle_slot_past_the_cache_matches_reference(ref, port):
    """Every step decodes all slots, so an idle slot's cache length keeps
    growing: in the second run slot 1 idles past max_seq. JAX drops its
    out-of-bounds cache writes; the port must too (torch would raise)."""
    v = _vocab(port)
    first = [(np.arange(5) * 7 % v).astype(np.int32), (np.arange(4) * 3 % v).astype(np.int32)]
    second = [(np.arange(3) * 11 % v).astype(np.int32)]
    got, exp, eng = both(ref, port, [(first, 8), (second, 12)], max_batch=2, max_seq=16)
    assert got == exp
    lengths = eng.state["layers"].length
    assert int(lengths[:, 1].min()) > 16  # the idle row ran past the 16-entry cache
    assert torch.isfinite(eng.state["layers"].k.float()).all()


def test_temperature_sampling_is_seeded(port):
    """Sampling draws from softmax(logits / T) with a torch.Generator
    seeded as the reference seeds its key: repeatable, not the
    reference's stream."""
    p = (np.arange(6) % _vocab(port)).astype(np.int32)
    runs = [ServeEngine(port[0], port[1], ServeConfig(max_batch=2, max_seq=64, temperature=1.0)).run(
        [p, p[:4]], max_new=6) for _ in range(2)]
    assert runs[0] == runs[1]
    greedy = ServeEngine(port[0], port[1], ServeConfig(max_batch=2, max_seq=64)).run([p, p[:4]], max_new=6)
    assert all(runs[0][u][0] == greedy[u][0] for u in greedy)  # the first token is greedy, as there
    assert runs[0] != greedy


def test_launcher_runs_on_the_cpu(capsys):
    launch.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 12 tokens in ") and out[0].endswith(" tok/s aggregate)")
    assert [line.split(":")[0] for line in out[1:]] == ["  req 0", "  req 1", "  req 2"]


def test_launcher_prompts_are_the_references(ref):
    """The same rng(0) stream of lengths and tokens as the reference
    launcher draws."""
    cfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(0)
    exp = [rng.integers(0, cfg.vocab_size, rng.integers(4, 16 + 1)).astype(np.int32) for _ in range(8)]
    got = launch.prompt_stream(cfg, 8, 16)
    assert len(got) == 8 and all(np.array_equal(a, b) and a.dtype == np.int32 for a, b in zip(got, exp))


def test_launcher_no_reduced_reaches_the_full_config(monkeypatch):
    """``--reduced`` defaults to true, as in the reference, but here
    ``--no-reduced`` reaches the full config."""
    seen = []

    def fake_build(cfg, scfg, **kw):
        seen.append((cfg, scfg, kw))
        raise SystemExit(0)

    monkeypatch.setattr(launch, "build_engine", fake_build)
    for argv, full in ((["--arch", ARCH, "--no-reduced"], True), (["--arch", ARCH], False)):
        with pytest.raises(SystemExit):
            launch.main(argv)
        assert (seen[-1][0] == get_config(ARCH)) is full
    assert seen[-1][1] == ServeConfig(max_batch=4, max_seq=128) and seen[-1][2] == {"device": None}


def _mesh_batch(cfg, seed: int = 0) -> dict:
    """A small batch of the arch's inputs: frame embeddings and decoder
    tokens (encoder-decoder), embeddings (a vision stub), or tokens."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int64))
    if cfg.is_encdec:
        return {"enc_embeds": torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)),
                "tokens": toks}
    if cfg.input_kind == "embeddings":
        return {"embeds": torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))}
    return {"tokens": toks}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_builds_on_a_mesh(arch):
    """Nothing is refused: every arch in configs/ (reduced, float32; MoE
    with nothing dropped) builds on SimMesh(2), and its logits equal one
    rank's on the same weights within 1e-5."""
    from repro_torch.core import SimMesh

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts
                                                               / cfg.moe.top_k))
    model = Model(cfg, SimMesh(2, device="cpu"), device="cpu")
    assert model.tp.p == 2
    params, _ = model.init(torch.Generator().manual_seed(0))
    batch = _mesh_batch(cfg)
    got, exp = model.logits(params, batch), Model(cfg, device="cpu").logits(params, batch)
    assert got.shape == exp.shape and torch.isfinite(got).all()
    assert float((got - exp).abs().max() / exp.abs().max()) <= 1e-5


# ------------------------------------------------------------------- MoE


def test_moe_single_request(moe_ref, moe_port):
    prompt = np.arange(5, dtype=np.int32) % _vocab(moe_port)
    (got,), (exp,), _ = both(moe_ref, moe_port, [([prompt], 6)], max_batch=2, max_seq=64)
    assert got == exp and len(got) == 1 and len(list(got.values())[0]) == 6


def test_moe_batched(moe_ref, moe_port):
    """A pair of requests: the reference's tokens, capacity drops
    included (at the stock factor a token's slot depends on the other
    rows of its dispatch, idle rows too)."""
    v = _vocab(moe_port)
    pa = (np.arange(7) * 3 % v).astype(np.int32)
    pb = (np.arange(4) * 5 % v).astype(np.int32)
    (pair,), (r_pair,), _ = both(moe_ref, moe_port, [([pa, pb], 5)], max_batch=2, max_seq=64)
    assert pair == r_pair and len(pair) == 2


def test_moe_more_requests_than_slots(moe_ref, moe_port):
    prompts = [(np.arange(3 + i) % _vocab(moe_port)).astype(np.int32) for i in range(5)]
    (got,), (exp,), _ = both(moe_ref, moe_port, [(prompts, 4)], max_batch=2, max_seq=64)
    assert got == exp and len(got) == 5 and all(len(v) == 4 for v in got.values())


def test_moe_idle_slot_past_the_cache(moe_ref, moe_port):
    """As test_idle_slot_past_the_cache_matches_reference, on the MoE
    archs: DeepSeek-V3's idle row runs past its MLA latent cache."""
    v = _vocab(moe_port)
    first = [(np.arange(5) * 7 % v).astype(np.int32), (np.arange(4) * 3 % v).astype(np.int32)]
    second = [(np.arange(3) * 11 % v).astype(np.int32)]
    got, exp, eng = both(moe_ref, moe_port, [(first, 8), (second, 12)], max_batch=2, max_seq=16)
    assert got == exp
    for name, cache in eng.state.items():
        if name != "pos":
            assert int(cache.length[:, 1].min()) > 16, name
            assert all(torch.isfinite(t.float()).all() for t in cache[:-1])


@pytest.mark.parametrize("arch", MOE)
def test_moe_slots_isolated_without_drops(arch):
    """At ``capacity_factor = E / k`` nothing drops, so a request's greedy
    tokens among other slots equal its solo tokens, in both packages."""
    mo = get_config(arch, reduced=True).moe
    r = _reference(arch, capacity_factor=mo.num_experts / mo.top_k)
    port = _port_of(r)
    v = _vocab(port)
    pa = (np.arange(7) * 3 % v).astype(np.int32)
    pb = (np.arange(4) * 5 % v).astype(np.int32)
    (solo, pair), (r_solo, r_pair), _ = both(r, port, [([pa], 5), ([pa, pb], 5)], max_batch=2, max_seq=64)
    assert solo == r_solo and pair == r_pair
    assert pair[1] == solo[0]  # uid 1: pa again, beside pb


@pytest.mark.parametrize("arch", MOE)
def test_moe_launcher_runs_on_the_cpu(arch, capsys):
    launch.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 12 tokens in ") and out[0].endswith(" tok/s aggregate)")


def test_a_mesh_of_several_ranks_is_refused():
    """A mesh of several ranks refuses nothing now: a dense model builds
    and runs there, tensor-parallel (tests/test_torch_lm_tp.py holds it to
    the reference), as a MoE model runs expert-parallel
    (tests/test_torch_lm_ep.py) and the SSM and hybrid models split by
    channel (their logits equal one rank's here)."""
    from repro_torch.core import SimMesh

    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
    model = Model(cfg, SimMesh(2, device="cpu"), device="cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.arange(6)[None] * 37 % cfg.vocab_size}
    got, exp = model.logits(params, batch), Model(cfg, device="cpu").logits(params, batch)
    assert got.shape == (1, 6, cfg.vocab_size)
    assert float((got - exp).abs().max() / exp.abs().max()) <= 1e-5
    for arch in SSM:
        scfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        params, _ = Model(scfg, device="cpu").init(torch.Generator().manual_seed(1))
        got = Model(scfg, SimMesh(2, device="cpu"), device="cpu").logits(params, batch)
        exp = Model(scfg, device="cpu").logits(params, batch)
        assert float((got - exp).abs().max() / exp.abs().max()) <= 1e-5
        assert Model(get_config(arch, reduced=True), SimMesh(1, device="cpu"), device="cpu").mesh.p == 1
    assert Model(get_config(ARCH, reduced=True), SimMesh(1, device="cpu"), device="cpu").mesh.p == 1
    for arch in MOE:
        assert Model(get_config(arch, reduced=True), SimMesh(2, device="cpu"), device="cpu").mesh.p == 2


# ------------------------------------------------------------ SSM, hybrid


def test_ssm_engine_matches_reference(ssm_ref, ssm_port):
    """xLSTM's and hymba's nested decode states through the engine, on one
    engine per package: a batched pair, then more requests than slots,
    then one request beside an idle slot (hymba's meta tokens count in
    ``slot_pos``: 8 of the 24 positions)."""
    v = _vocab(ssm_port)
    pair = [(np.arange(7) * 3 % v).astype(np.int32), (np.arange(4) * 5 % v).astype(np.int32)]
    many = [(np.arange(n) * (i + 2) % v).astype(np.int32) for i, n in enumerate((4, 7, 4, 7, 4))]
    alone = [(np.arange(7) * 11 % v).astype(np.int32)]
    got, exp, eng = both(ssm_ref, ssm_port, [(pair, 5), (many, 4), (alone, 12)], max_batch=2, max_seq=24)
    assert got == exp
    assert [len(r) for r in got] == [2, 5, 1] and all(len(t) == 4 for t in got[1].values())
    for leaf in (t for name, st in eng.state.items() if name != "pos" for t in _leaves(st)):
        assert torch.isfinite(leaf.float()).all()


def _leaves(tree):
    return [leaf for sub in tree for leaf in _leaves(sub)] if isinstance(tree, tuple) else [tree]


@pytest.mark.parametrize("arch", SSM)
def test_ssm_launcher_runs_on_the_cpu(arch, capsys):
    """launch/serve.py serves both archs unchanged."""
    launch.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 12 tokens in ") and out[0].endswith(" tok/s aggregate)")


def test_no_fallback_to_the_cpu(monkeypatch):
    """Model, and so the engine and the launcher, run on cuda unless the
    caller passes device="cpu"; without a GPU they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config(ARCH, reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", ARCH])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda_device):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
    cpu = Model(cfg, device="cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda_device)
    v = cfg.vocab_size
    prompts = [(np.arange(7) * 3 % v).astype(np.int32), (np.arange(4) * 5 % v).astype(np.int32)]
    exp = ServeEngine(cpu, params, ServeConfig(max_batch=2, max_seq=64)).run(prompts, max_new=5)
    def to_card(tree):
        return {k: to_card(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(cuda_device)

    got = ServeEngine(card, to_card(params), ServeConfig(max_batch=2, max_seq=64)).run(prompts, max_new=5)
    assert got == exp


def _tree_to(tree, device):
    return {k: _tree_to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_on_the_card_matches_the_cpu(cuda_device, arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    cpu = Model(cfg, device="cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda_device)
    v = cfg.vocab_size
    prompts = [(np.arange(7) * 3 % v).astype(np.int32), (np.arange(4) * 5 % v).astype(np.int32),
               (np.arange(9) * 7 % v).astype(np.int32)]
    exp = ServeEngine(cpu, params, ServeConfig(max_batch=2, max_seq=16)).run(prompts, max_new=12)
    got = ServeEngine(card, _tree_to(params, cuda_device), ServeConfig(max_batch=2, max_seq=16)).run(
        prompts, max_new=12)
    assert got == exp


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SSM)
def test_ssm_engine_on_the_card_matches_the_cpu(cuda_device, arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    cpu = Model(cfg, device="cpu")
    params, _ = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda_device)
    v = cfg.vocab_size
    prompts = [(np.arange(7) * 3 % v).astype(np.int32), (np.arange(4) * 5 % v).astype(np.int32),
               (np.arange(9) * 7 % v).astype(np.int32)]
    exp = ServeEngine(cpu, params, ServeConfig(max_batch=2, max_seq=32)).run(prompts, max_new=12)
    got = ServeEngine(card, _tree_to(params, cuda_device), ServeConfig(max_batch=2, max_seq=32)).run(
        prompts, max_new=12)
    assert got == exp
