"""Expert-parallel MoE over the port's meshes against the reference's
``apply_moe`` and ``Model`` under a jax mesh.

One subprocess over 8 host devices runs the reference (the style of
``tests/test_moe.py``'s ring test) on the reduced configs in float32 and
saves its weights and outputs; the port runs the same weights and numpy
inputs on a ``SimMesh`` of the same axes:

- the ring (DeepSeek-V3, 8 experts, P = 4, capacity_factor 8.0: nothing
  drops), batched and ``interleave=True``, and at the stock factor,
  where each rank counts capacity on its own tokens: its drops are held
  exactly, per rank;
- the einsum dispatch on a ``("data", "model")`` (2, 4) mesh: capacity
  per data-parallel group (g = 2), drops included;
- Mixtral (4 experts) on P = 8: the experts do not divide the axis, so
  the capacity dim takes it;
- ``Model(cfg, mesh)`` prefill (the ring) and two decode steps (the
  einsum dispatch: S = 1) for both archs, float32 caches.

Tolerances: 1e-5 relative to the largest entry, 1e-4 for interleaved
against batched (the reference's own test). One gloo spawn at P = 4 runs
every process-group case: the ring and the einsum dispatch on a
``ProcessGroupMesh`` against ``SimMesh(4)``; the SPMD ``ServeEngine``
on the reference's weights against the reference engine's greedy tokens
(DeepSeek-V3 and Mixtral at capacity_factor = E / k, and Mixtral's
einsum dispatch at the stock factor, drops included), identical on every
rank; a rank that adds another prompt makes every rank raise
``StreamMismatch``; and ``Model(cfg, mesh).init`` keeps each rank's
experts bitwise equal to the one-rank model's."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import REPO, SRC
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core import SimMesh
from repro_torch.core import sharding
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model, params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

REL_TOL = 1e-5
INTERLEAVE_TOL = 1e-4  # interleaved against batched, as tests/test_moe.py holds the reference
P = 4
DS, MX = "deepseek-v3-671b", "mixtral-8x22b"
DATA_MODEL = ("data", "model")

REF_CODE = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import Model, moe as M

def cfg_of(arch, **moe):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg

def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}

def unflat(out, prefix):
    tree = {}
    for k, v in out.items():
        if k.startswith(prefix + "/"):
            *path, leaf = k[len(prefix) + 1:].split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(v)
    return tree

dev = jax.devices()
mesh4 = Mesh(np.array(dev[:4]).reshape(1, 4), ("data", "model"))
grid = Mesh(np.array(dev).reshape(2, 4), ("data", "model"))
mesh8 = Mesh(np.array(dev).reshape(1, 8), ("data", "model"))
out = {}
rng = np.random.default_rng(0)
x16 = rng.standard_normal((2, 16, 64)).astype(np.float32)
x32 = rng.standard_normal((2, 32, 64)).astype(np.float32)
for arch in ("deepseek-v3-671b", "mixtral-8x22b"):
    out.update(flat(M.init_moe(jax.random.PRNGKey(0), cfg_of(arch))[0], f"moe/{arch}"))
pd, pm = unflat(out, "moe/deepseek-v3-671b"), unflat(out, "moe/mixtral-8x22b")

def run(name, p, x, cfg, mesh):
    o, a = jax.jit(lambda p, x: M.apply_moe(p, x, cfg, mesh=mesh))(p, jnp.asarray(x))
    out[name], out[name + "_aux"] = np.asarray(o), np.asarray(a)

ring = cfg_of("deepseek-v3-671b", capacity_factor=8.0)
run("ring", pd, x16, ring, mesh4)
orig = M._ring_exchange_ffn
M._ring_exchange_ffn = lambda *a, **k: orig(*a, **{**k, "interleave": True})
run("ring_interleave", pd, x16, ring, mesh4)
M._ring_exchange_ffn = orig
run("ring_stock", pd, x16, cfg_of("deepseek-v3-671b"), mesh4)
keeps = []  # each island's drops: its own tokens, its own capacity (moe.py:292-293)
for s in range(4):
    xl = jnp.asarray(x16[:, s * 4:(s + 1) * 4].reshape(8, 64))
    idx = M.router_topk(xl, pd["router"], 2)[1]
    keeps.append(np.asarray(M._dispatch_indices(idx, 8, M._capacity(8, 2, 8, 1.25))[2]))
out["ring_stock_keep"] = np.stack(keeps)
run("einsum_grid", pd, x16, cfg_of("deepseek-v3-671b", dispatch="einsum"), grid)
run("mixtral_p8", pm, x32, cfg_of("mixtral-8x22b"), mesh8)

toks = rng.integers(0, 256, (2, 18)).astype(np.int32)
out["toks"] = toks
for arch, mesh in (("deepseek-v3-671b", mesh4), ("mixtral-8x22b", mesh8)):
    model = Model(cfg_of(arch), mesh, attn_impl="chunked")
    params, _ = model.init(jax.random.PRNGKey(0))
    out.update(flat(params, f"model/{arch}"))
    state = model.init_decode_state(2, 18, cache_dtype=jnp.float32)
    state, pl = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(toks[:, :16])}, state)
    logits = [np.asarray(pl)]
    decode = jax.jit(model.decode_step)
    for t in (16, 17):
        lg, state = decode(params, jnp.asarray(toks[:, t:t + 1]), state)
        logits.append(np.asarray(lg))
    out[f"logits/{arch}"] = np.stack(logits)
np.savez(OUT, **out)
print("PASS")
"""


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp.float() if isinstance(exp, torch.Tensor) else exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _cfg(arch, **moe):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


def _no_drop(arch, **moe):
    mo = get_config(arch, reduced=True).moe
    return _cfg(arch, capacity_factor=mo.num_experts / mo.top_k, **moe)


def _unflat(arrays, prefix):
    tree = {}
    for k in arrays:
        if k.startswith(prefix + "/"):
            *path, leaf = k[len(prefix) + 1:].split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = np.asarray(arrays[k])
    return tree


def _mesh(*dims):
    """A SimMesh with the reference's ("data", "model") axes."""
    return SimMesh(dims, axis_names=DATA_MODEL, device="cpu")


@pytest.fixture(scope="module")
def ref_process(tmp_path_factory):
    """REF_CODE started in a subprocess over 8 host devices (it runs while
    ``engine_refs`` serves the reference engine in this process)."""
    d = tmp_path_factory.mktemp("ep")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(d / "out.txt", "w") as out, open(d / "err.txt", "w") as err:  # files: no pipe to fill
        proc = subprocess.Popen([sys.executable, "-c", f"OUT = {str(d / 'ref.npz')!r}\n" + REF_CODE], cwd=REPO,
                                env=env, stdout=out, stderr=err)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(ref_process, engine_refs):
    proc, d = ref_process
    proc.wait(timeout=600)
    out, err = (d / "out.txt").read_text(), (d / "err.txt").read_text()
    assert proc.returncode == 0 and "PASS" in out, f"STDOUT:\n{out}\nSTDERR:\n{err[-4000:]}"
    return dict(np.load(d / "ref.npz"))


def _moe_params(ref, arch):
    return params_from_numpy(_unflat(ref, f"moe/{arch}"), device="cpu")


def _inputs():
    rng = np.random.default_rng(0)
    x16 = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))
    x32 = torch.from_numpy(rng.standard_normal((2, 32, 64)).astype(np.float32))
    return x16, x32


def _interleaved():
    return functools.partial(MOE._ring_exchange_ffn, interleave=True)


def test_ring_matches_reference_batched_and_interleaved(ref, monkeypatch):
    p, (x, _) = _moe_params(ref, DS), _inputs()
    cfg = _cfg(DS, capacity_factor=8.0)
    assert cfg.moe.dispatch == "ring"
    out, aux = MOE.apply_moe(p, x, cfg, mesh=_mesh(1, P))
    assert rel(out, ref["ring"]) <= REL_TOL and abs(float(aux) - float(ref["ring_aux"])) <= REL_TOL * float(aux)
    one, _ = MOE.apply_moe(p, x, cfg)  # nothing drops: the one-rank dispatch
    assert rel(out, one) <= REL_TOL
    monkeypatch.setattr(MOE, "_ring_exchange_ffn", _interleaved())
    inter, _ = MOE.apply_moe(p, x, cfg, mesh=_mesh(1, P))
    assert rel(inter, ref["ring_interleave"]) <= REL_TOL and rel(inter, out) <= INTERLEAVE_TOL


def test_ring_drops_per_rank_match_reference(ref, monkeypatch):
    """At the stock factor each rank counts capacity on its own 8 tokens
    (3 slots an expert): the same assignments drop, rank by rank."""
    p, (x, _) = _moe_params(ref, DS), _inputs()
    keeps, dispatch = [], MOE._dispatch_indices

    def recorded(idx, e, cap):
        got = dispatch(idx, e, cap)
        keeps.append(got[2])
        return got

    monkeypatch.setattr(MOE, "_dispatch_indices", recorded)
    out, aux = MOE.apply_moe(p, x, _cfg(DS), mesh=_mesh(1, P))
    assert rel(out, ref["ring_stock"]) <= REL_TOL
    assert abs(float(aux) - float(ref["ring_stock_aux"])) <= REL_TOL * float(aux)
    exp = ref["ring_stock_keep"]
    assert len(keeps) == P and not exp.all()  # some rank drops
    for got, e in zip(keeps, exp):
        assert np.array_equal(got.numpy(), e)
    whole, _ = MOE.apply_moe(p, x, _cfg(DS))  # capacity over all 32 tokens drops others
    assert rel(out, whole) > 1e-3


def test_einsum_over_a_data_model_grid_matches_reference(ref):
    """g = 2 data-parallel groups, each its own capacity, the experts
    over the model axis; drops included."""
    p, (x, _) = _moe_params(ref, DS), _inputs()
    cfg = _cfg(DS, dispatch="einsum")
    mesh = _mesh(2, P)
    assert MOE._groups(mesh, 32) == 2
    out, aux = MOE.apply_moe(p, x, cfg, mesh=mesh)
    assert rel(out, ref["einsum_grid"]) <= REL_TOL
    assert abs(float(aux) - float(ref["einsum_grid_aux"])) <= REL_TOL * float(aux)


def test_fewer_experts_than_ranks_split_the_capacity(ref):
    """Mixtral's 4 experts on P = 8: the experts stay whole and the
    capacity dim (40 slots) takes the model axis."""
    p, (_, x) = _moe_params(ref, MX), _inputs()
    cfg, mesh = _cfg(MX), _mesh(1, 8)
    cap = MOE._capacity(64, 2, 4, cfg.moe.capacity_factor)
    assert sharding.resolve(mesh, "batch", "experts", "expert_cap", None, shape=(1, 4, cap, 64)) == (
        "data", None, "model", None)
    out, aux = MOE.apply_moe(p, x, cfg, mesh=mesh)
    assert rel(out, ref["mixtral_p8"]) <= REL_TOL
    assert abs(float(aux) - float(ref["mixtral_p8_aux"])) <= REL_TOL * float(aux)
    one, one_aux = MOE.apply_moe(p, x, cfg)  # g = 1: the one-rank dispatch, drops included
    assert rel(out, one) <= REL_TOL and float(aux) == float(one_aux)


@pytest.mark.parametrize("arch,dims", [(DS, (1, P)), (MX, (1, 8))])
def test_model_on_a_mesh_matches_reference(ref, arch, dims):
    """Prefill of 16 tokens (DeepSeek-V3: the ring) and two decode steps
    (the einsum dispatch), stock factor, float32 caches."""
    model = Model(_cfg(arch), _mesh(*dims), attn_impl="chunked", device="cpu")
    params = params_from_numpy(_unflat(ref, f"model/{arch}"), device="cpu")
    toks = torch.from_numpy(ref["toks"])
    state = model.init_decode_state(2, 18, cache_dtype=torch.float32)
    state, pl = model.prefill(params, {"tokens": toks[:, :16]}, state)
    logits = [pl]
    for t in (16, 17):
        lg, state = model.decode_step(params, toks[:, t:t + 1], state)
        logits.append(lg)
    exp = ref[f"logits/{arch}"]
    for got, e in zip(logits, exp):
        assert rel(got, e) <= REL_TOL


def test_decode_and_indivisible_prompts_take_the_einsum_dispatch(ref):
    """The reference's fallback: the ring only where P divides the
    experts and the sequence, so a decode step (S = 1) and a 6-token
    prompt run the einsum dispatch over the ranks (``moe.DISPATCHES``
    counts the dispatch each call took)."""
    p, (x, _) = _moe_params(ref, DS), _inputs()
    cfg, mesh = _no_drop(DS), SimMesh(P, device="cpu")
    one, _ = MOE.apply_moe(p, x, cfg)
    for s, took in ((16, "ring"), (6, "einsum"), (1, "einsum")):
        MOE.DISPATCHES.clear()
        out, _ = MOE.apply_moe(p, x[:, :s], cfg, mesh=mesh)
        assert MOE.DISPATCHES == {(took, P): 1} and rel(out, one[:, :s]) <= REL_TOL
    # 8 experts on 3 ranks: never the ring; the capacity dim does not divide either
    MOE.DISPATCHES.clear()
    out, _ = MOE.apply_moe(p, x[:, :12], cfg, mesh=SimMesh(3, device="cpu"))
    assert MOE.DISPATCHES == {("einsum", 3): 1} and rel(out, one[:, :12]) <= REL_TOL


def test_process_group_holds_only_its_experts():
    """params_from_numpy on a process-group mesh cuts each expert leaf to
    the rank's block; the dense dispatch, which needs every expert,
    refuses it."""
    class OneRankOfFour(SimMesh):  # a rank's view of a 4-rank group
        caller_holds_block = True

        def axis_index(self, axis_name):
            return 2

    mesh = OneRankOfFour(P, device="cpu")
    cfg = _cfg(DS)
    p, s = MOE.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    tree = {k: (v.draw(torch.Generator().manual_seed(1), "cpu") if hasattr(v, "draw") else v)
            for k, v in p.items() if k != "shared"}
    s = {k: v for k, v in s.items() if k != "shared"}
    got = params_from_numpy({k: v.numpy() for k, v in tree.items()}, device="cpu", mesh=mesh, specs=s)
    assert torch.equal(got["wg"], tree["wg"][4:6]) and torch.equal(got["router"], tree["router"])
    with pytest.raises(ValueError, match="specs"):
        params_from_numpy({k: v.numpy() for k, v in tree.items()}, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="every expert"):
        MOE.apply_moe(got, torch.zeros(1, 4, 64), _cfg(DS, dispatch="dense"), mesh=mesh)


# ---------------------------------------------------------------------------
# one gloo spawn at P = 4
# ---------------------------------------------------------------------------

ENGINE_RUNS = ((DS, True), (MX, True), (MX, False))  # (arch, capacity_factor = E / k)
SCFG = dict(max_batch=2, max_seq=32)
MAX_NEW = 4


def _prompts():
    """Length 8 prefills through the ring at P = 4, 5 through the einsum
    dispatch (two lengths: one reference compile each)."""
    return [(np.arange(n) * (3 + n + i) % 256).astype(np.int32) for i, n in enumerate((8, 5, 8, 5))]


def _run_key(arch, no_drop):
    return f"{arch}/{'no_drop' if no_drop else 'stock'}"


@pytest.fixture(scope="module")
def engine_refs(tmp_path_factory, ref_process):
    """The reference engine's greedy tokens on each ENGINE_RUNS config
    (no mesh: at E / k nothing drops, and its einsum dispatch is the one
    rank's), and its weights, saved for the spawn."""
    jax = pytest.importorskip("jax")
    from repro.configs import ServeConfig as RServeConfig
    from repro.configs import get_config as r_get_config
    from repro.models import Model as RModel
    from repro.serve import ServeEngine as RServeEngine

    tokens, arrays = {}, {}
    for arch, no_drop in ENGINE_RUNS:
        cfg = dataclasses.replace(r_get_config(arch, reduced=True), dtype="float32")
        if no_drop:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        model = RModel(cfg, attn_impl="chunked")
        params = jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0))  # bitwise the eager init
        res = RServeEngine(model, params, RServeConfig(**SCFG)).run(_prompts(), max_new=MAX_NEW)
        tokens[_run_key(arch, no_drop)] = {str(k): v for k, v in res.items()}
        arrays.update({f"{arch}/{k}": v for k, v in _flat(params).items()})
    out = tmp_path_factory.mktemp("ep_engine")
    np.savez(out / "weights.npz", **arrays)
    (out / "tokens.json").write_text(json.dumps(tokens))
    return str(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix.lstrip("/"): np.asarray(tree)}


def _gathered(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _dispatch_cases(mesh, ran):
    """The ring (batched, interleaved) and the einsum dispatch on the
    ProcessGroupMesh, each rank's output equal to SimMesh(4)'s."""
    sim = SimMesh(P, device="cpu")
    x, _ = _inputs()
    for arch in (DS, MX):
        cfg = _cfg(arch)
        p, s = MOE.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
        whole = {k: (v.draw(torch.Generator().manual_seed(1), "cpu") if hasattr(v, "draw") else v)
                 for k, v in p.items()}
        own = params_from_numpy(_flat_np(whole), device="cpu", mesh=mesh, specs=s)
        assert own["wu"].shape[0] == cfg.moe.num_experts // P
        for dispatch in ("ring", "einsum"):
            c = _cfg(arch, dispatch=dispatch)
            for interleave in ((False, True) if dispatch == "ring" else (False,)):
                f = _interleaved() if interleave else MOE._ring_exchange_ffn
                orig, MOE._ring_exchange_ffn = MOE._ring_exchange_ffn, f
                try:
                    got, aux = MOE.apply_moe(own, x, c, mesh=mesh)
                    exp, exp_aux = MOE.apply_moe(whole, x, c, mesh=sim)
                finally:
                    MOE._ring_exchange_ffn = orig
                assert rel(got, exp) <= 1e-6 and abs(float(aux) - float(exp_aux)) <= 1e-6 * float(exp_aux), (
                    arch, dispatch, interleave)
    ran.append("dispatches over gloo")


def _flat_np(tree):
    return {k: (_flat_np(v) if isinstance(v, dict) else v.numpy()) for k, v in tree.items()}


def _engine_cases(mesh, ran, ref_dir):
    from repro_torch.serve import ServeEngine

    arrays = np.load(f"{ref_dir}/weights.npz")
    tokens = json.loads(open(f"{ref_dir}/tokens.json").read())
    for arch, no_drop in ENGINE_RUNS:
        cfg = _no_drop(arch) if no_drop else _cfg(arch)
        model = Model(cfg, mesh, attn_impl="chunked", device="cpu")
        specs = Model(cfg, attn_impl="chunked", device="cpu").init(torch.Generator().manual_seed(0))[1]
        params = params_from_numpy(_unflat(arrays, arch), device="cpu", mesh=mesh, specs=specs, cfg=cfg)
        eng = ServeEngine(model, params, ServeConfig(**SCFG))
        got = {str(k): v for k, v in eng.run(_prompts(), max_new=MAX_NEW).items()}
        assert got == tokens[_run_key(arch, no_drop)], (arch, no_drop, got)
        assert eng.agreements >= len(_prompts()) + MAX_NEW
        assert all(g == got for g in _gathered(got))
    ran.append("SPMD engine equals the reference")


def _mismatch_case(mesh, ran):
    from repro_torch.serve import ServeEngine, StreamMismatch

    cfg = _cfg(MX)
    model = Model(cfg, mesh, device="cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, ServeConfig(**SCFG))
    prompt = _prompts()[0].copy()
    if mesh.rank == 1:
        prompt[0] += 1
    t0 = time.perf_counter()
    with pytest.raises(StreamMismatch, match="admit"):
        eng.add_request(prompt, MAX_NEW)
    assert time.perf_counter() - t0 < 10.0
    ran.append("mismatch raises on every rank")


def _init_case(mesh, ran):
    """Model(cfg, mesh).init keeps this rank's experts, bitwise the
    one-rank model's slice; every other leaf its tensor-parallel block
    (``core.sharding.block``: heads, d_ff, vocabulary) or, placed nowhere,
    whole and equal."""
    from repro_torch.models.model import head_units

    for arch in (DS, MX):
        cfg = _cfg(arch)
        own, specs = Model(cfg, mesh, device="cpu").init(torch.Generator().manual_seed(3))
        whole, _ = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
        n = cfg.moe.num_experts // P
        for key, (a, b) in _pairs(own, whole):
            spec = _spec_at(specs, key)
            where = sharding.block(mesh, spec, b.shape, head_units(cfg))
            if "experts" in spec:
                dim = spec.index("experts")
                assert where == [(dim, mesh.rank * n, n, 1)], key
            for dim, first, count, _ in where or ():
                b = b.narrow(dim, first, count)
            assert torch.equal(a, b), key
    ran.append("init keeps the rank's experts")


def _pairs(a, b, prefix=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), (a, b)


def _spec_at(specs, key):
    for k in key.split("/"):
        specs = specs[k]
    return specs


def _worker(rank, world, init_method, tmp, ref_dir):
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, device="cpu", timeout_s=60)
    try:
        ran = []
        _dispatch_cases(mesh, ran)
        _init_case(mesh, ran)
        _engine_cases(mesh, ran, ref_dir)
        _mismatch_case(mesh, ran)
        with open(f"{tmp}/ran{rank}.json", "w") as fh:
            json.dump(ran, fh)
    finally:
        dist.destroy_process_group()


def test_expert_parallel_over_a_process_group(tmp_path, engine_refs):
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(P, f"file://{tmp_path / 'rendezvous'}", str(tmp_path), engine_refs), nprocs=P, join=True)
    for rank in range(P):
        ran = json.loads((tmp_path / f"ran{rank}.json").read_text())
        assert ran == ["dispatches over gloo", "init keeps the rank's experts", "SPMD engine equals the reference",
                       "mismatch raises on every rank"], (rank, ran)
