"""Tensor-parallel attention, dense layers and vocabulary over the port's
meshes against the reference's ``Model(cfg, mesh)`` under a jax mesh.

Three subprocesses over 8 host devices run the reference (GSPMD) on the
reduced configs in float32 and saves its weights and outputs; the port
runs the same weights and tokens on a ``SimMesh`` of the same
``("data", "model")`` axes:

- ``qwen2.5-32b`` on (1, 4): 4 heads split, its 2 KV heads do not divide
  4, so ``wk`` / ``wv`` stay whole and the cache is cut along its head
  dim (the reference's ``decode_state_shardings``); the same with
  ``attn_partition="context"``; and on the (2, 2) grid, whose ``model``
  axis of 2 splits the KV heads and the cache too;
- ``gemma2-9b`` on (1, 2): heads and KV heads split, softcaps,
  alternating windows, tied embeddings;
- ``mixtral-8x22b`` and ``deepseek-v3-671b`` on (1, 4), tensor- and
  expert-parallel, drops included at the stock factor (DeepSeek-V3: MLA
  and the dense prefix), and DeepSeek-V3 on the (2, 2) grid, whose run
  also holds its latent cache's sequence cut (``seq_shard``);
- ``xlstm-1.3b``, ``hymba-1.5b`` and ``whisper-medium`` on (1, 2) and
  (1, 4): the SSM mixers split by channel (Mamba's and the mLSTM's
  ``[x | z]`` halves, the sLSTM's gathered pre-activations), hymba's
  attention (4 heads, 2 KV heads: ``wk`` / ``wv`` whole at 4, the cache
  cut along its head dim, as mixtral's) and the encoder-decoder's
  encoder, cross-attention and vocabulary;
- the reference's ``flash_decode_combine`` under ``shard_map``
  (``tests/test_attention.py``'s case) against the port's over
  ``SimMesh(4)``.

``logits`` at S = 16 runs the Megatron sequence-parallel rings (not the
SSM and hybrid models: their residual stream stays whole), prefill and
two decode steps the psum form; each within 1e-5 of the reference,
relative to the largest entry. One gloo spawn at P = 4 runs every
process-group case: ``psum`` / ``pmax`` bitwise equal on every rank (on
the 1-D mesh and the model rings of a (2, 2) grid); a rank holds exactly
its blocks, bitwise the one-rank model's slice after ``init`` and the
reference's after ``params_from_numpy`` (for the SSM leaves each packed
half's block: ``win`` / ``wup``); ``logits``, prefill and decode within
1e-5 of the one-rank model in both attention partitions, and for xLSTM,
hymba and whisper, every rank's logits bitwise equal; a rank's cut cache
(Qwen's (B, S, KVH, hd / 4)) against the one-rank cache's slice, and
reduced hymba with one KV head on a (2, 2) grid at batch 1 with
``seq_shard`` (both cuts: a quarter of the cache a rank), and reduced
DeepSeek-V3 there (half the latent cache a rank); the dense MoE dispatch
on a (4, 1) grid, each rank on its row of the batch, against the
reference's ``_apply_moe_dense`` on the whole batch; and the SPMD
``ServeEngine`` serving Qwen's and hymba's reduced configs gives the
reference engine's greedy tokens on every rank.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, SRC
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core import SimMesh, overlap, sharding
from repro_torch.models import attention as A
from repro_torch.models.model import Model, head_units, params_from_numpy
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

REL_TOL = 1e-5
P = 4
QWEN = "qwen2.5-32b"
DATA_MODEL = ("data", "model")
#: (name, arch, ("data", "model") dims, config overrides); REF_GROUPS
#: splits them over three reference subprocesses that run at once
CASES = (
    ("qwen", QWEN, (1, 4), {}),
    ("qwen_context", QWEN, (1, 4), {"attn_partition": "context"}),
    ("qwen_grid", QWEN, (2, 2), {}),
    ("gemma", "gemma2-9b", (1, 2), {}),
    ("mixtral", "mixtral-8x22b", (1, 4), {}),
    ("deepseek", "deepseek-v3-671b", (1, 4), {}),
    ("deepseek_grid", "deepseek-v3-671b", (2, 2), {}),
    ("xlstm", "xlstm-1.3b", (1, 2), {}),
    ("xlstm_4", "xlstm-1.3b", (1, 4), {}),
    ("hymba", "hymba-1.5b", (1, 2), {}),
    ("hymba_4", "hymba-1.5b", (1, 4), {}),
    ("whisper", "whisper-medium", (1, 2), {}),
    ("whisper_4", "whisper-medium", (1, 4), {}),
)
#: (name, arch, dims, overrides, the CASES entry whose reference run it is held to): the cache's sequence over
#: ``data`` (``seq_shard``) on a SimMesh, which holds the whole batch at every ``data`` coordinate; the
#: reference's values do not depend on where its cache lies, so these cases need no run of their own. They do
#: depend on the mesh's shape where a MoE routes (its capacity groups and ring islands follow the ``data`` and
#: ``model`` axes): DeepSeek-V3's sequence cut is held to the run on its own (2, 2) grid
SEQ_CASES = (("hymba_seq", "hymba-1.5b", (2, 2), {}, "hymba"), ("gemma_seq", "gemma2-9b", (2, 2), {}, "gemma"),
             ("deepseek_seq", "deepseek-v3-671b", (2, 2), {}, "deepseek_grid"))
REF_GROUPS = (("deepseek", "deepseek_grid"), ("mixtral", "gemma", "flash"), ("qwen", "qwen_context", "qwen_grid"),
              ("xlstm", "xlstm_4", "hymba", "hymba_4", "whisper", "whisper_4"))
#: whisper's frame embeddings (B, S_ENC, d_model of the reduced config)
S_ENC = 16

REF_CODE = r"""
import dataclasses, math
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config
from repro.core.compat import make_mesh, shard_map
from repro.models import Model
from repro.models import attention as A

def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}

dev = jax.devices()
out = {}
rng = np.random.default_rng(0)
toks = rng.integers(0, 256, (2, 18)).astype(np.int32)
out["toks"] = toks
out["enc"] = enc = rng.standard_normal((2, S_ENC, 64)).astype(np.float32)
saved = set()

def batch(cfg, t):
    return {"enc_embeds": jnp.asarray(enc), "tokens": t} if cfg.is_encdec else {"tokens": t}

for name, arch, (d, m), kw in CASES:
    if name not in GROUP:
        continue
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **kw)
    model = Model(cfg, Mesh(np.array(dev[:d * m]).reshape(d, m), ("data", "model")), attn_impl="chunked")
    params = jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0))  # eager init: ~3 x the time
    if arch not in saved:
        out.update(flat(params, f"w/{arch}"))
        saved.add(arch)
    out[f"{name}/logits"] = np.asarray(jax.jit(model.logits)(params, batch(cfg, jnp.asarray(toks[:, :16]))))
    state = model.init_decode_state(2, 18, cache_dtype=jnp.float32)
    state, pl = jax.jit(model.prefill)(params, batch(cfg, jnp.asarray(toks[:, :16])), state)
    steps = [np.asarray(pl)]
    decode = jax.jit(model.decode_step)
    for t in (16, 17):
        lg, state = decode(params, jnp.asarray(toks[:, t:t + 1]), state)
        steps.append(np.asarray(lg))
    out[f"{name}/steps"] = np.stack(steps)

if "flash" not in GROUP:
    np.savez(OUT, **out)
    print("PASS")
    raise SystemExit
# tests/test_attention.py::test_flash_decode_combine_seqshard's case
mesh = make_mesh((4,), ("data",))
B, S, H, D = 2, 64, 4, 16
q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, 1, H, D), (B, S, H, D), (B, S, H, D)))
out.update({"flash/q": q, "flash/k": k, "flash/v": v})

def shard_fn(q, k, v):
    s = jnp.einsum("bqhd,bkhd->bhqk", q / math.sqrt(D), k)[:, :, 0]
    m = s.max(-1)
    p = jnp.exp(s - m[..., None])
    l = p.sum(-1)
    return A.flash_decode_combine(jnp.einsum("bhk,bkhd->bhd", p, v)[:, None], m, l, "data")

out["flash/out"] = np.asarray(jax.jit(shard_map(shard_fn, mesh=mesh, in_specs=(P(), P(None, "data"), P(None, "data")),
                                                out_specs=P(), check_vma=False))(q, k, v))
np.savez(OUT, **out)
print("PASS")
"""


def rel(got, exp) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    exp = np.asarray(exp.float() if isinstance(exp, torch.Tensor) else exp, np.float64)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **kw)


def _mesh(*dims):
    return SimMesh(dims, axis_names=DATA_MODEL, device="cpu")


def _unflat(arrays, prefix=""):
    """The tree of ``arrays``' keys under ``prefix`` (all of them for "")."""
    tree = {}
    head = prefix + "/" if prefix else ""
    for k in arrays:
        if k.startswith(head):
            *path, leaf = k[len(head):].split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = np.asarray(arrays[k])
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix.lstrip("/"): np.asarray(tree)}


def _run(model, params, toks, enc=None, *, seq_shard=False):
    """logits of the first 16 tokens, and a prefill of them + two decode
    steps (float32 cache), and the state after them; ``enc``: whisper's
    frame embeddings."""
    def batch(t):
        return {"tokens": t} if enc is None else {"enc_embeds": enc, "tokens": t}

    logits = model.logits(params, batch(toks[:, :16]))
    state = model.init_decode_state(toks.shape[0], 18, cache_dtype=torch.float32, seq_shard=seq_shard)
    state, pl = model.prefill(params, batch(toks[:, :16]), state)
    steps = [pl]
    for t in (16, 17):
        lg, state = model.decode_step(params, toks[:, t:t + 1], state)
        steps.append(lg)
    return logits, steps, state


@pytest.fixture(scope="module")
def ref_process(tmp_path_factory):
    """REF_CODE started in one subprocess over 8 host devices per
    REF_GROUPS entry; they run while the reference engine and the gloo
    spawn run in this process."""
    d = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for i, group in enumerate(REF_GROUPS):
        code = f"OUT = {str(d / f'ref{i}.npz')!r}\nCASES = {CASES!r}\nGROUP = {group!r}\nS_ENC = {S_ENC}\n" + REF_CODE
        with open(d / f"out{i}.txt", "w") as out, open(d / f"err{i}.txt", "w") as err:  # files: no pipe to fill
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=out, stderr=err))
    yield procs, d
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(ref_process):
    procs, d = ref_process
    arrays = {}
    for i, proc in enumerate(procs):
        proc.wait(timeout=600)
        out, err = (d / f"out{i}.txt").read_text(), (d / f"err{i}.txt").read_text()
        assert proc.returncode == 0 and "PASS" in out, f"STDOUT:\n{out}\nSTDERR:\n{err[-4000:]}"
        arrays.update(np.load(d / f"ref{i}.npz"))
    return arrays


# ---------------------------------------------------------------------------
# one gloo spawn at P = 4 (first: the reference subprocess runs meanwhile)
# ---------------------------------------------------------------------------

SCFG = dict(max_batch=2, max_seq=32)
MAX_NEW = 4
ENGINE_ARCHS = (QWEN, "hymba-1.5b")
#: the reduced xLSTM with 4 mLSTM heads of 32: split one a rank at P = 4
XLSTM_4_HEADS = {"num_heads": 4, "num_kv_heads": 4}
#: the spawn's model cases beyond Qwen's: the SSM and hybrid models and whisper
MESH_ARCHS = (("xlstm-1.3b", {}), ("xlstm-1.3b", XLSTM_4_HEADS), ("hymba-1.5b", {}), ("whisper-medium", {}))


def _prompts():
    """Lengths 8 and 5: through the sequence-parallel rings' divisible and
    indivisible prefill lengths alike (prefill runs the psum form)."""
    return [(np.arange(n) * (3 + n + i) % 256).astype(np.int32) for i, n in enumerate((8, 5, 8, 5))]


@pytest.fixture(scope="module")
def engine_refs(tmp_path_factory, ref_process):
    """The reference engine's greedy tokens on the reduced configs of
    ENGINE_ARCHS (no mesh: the reference's launcher builds none) and its
    weights and specs, saved for the spawn, one directory an arch."""
    jax = pytest.importorskip("jax")
    from repro.configs import ServeConfig as RServeConfig
    from repro.configs import get_config as r_get_config
    from repro.models import Model as RModel
    from repro.serve import ServeEngine as RServeEngine

    out = tmp_path_factory.mktemp("tp_engine")
    for arch in ENGINE_ARCHS:
        model = RModel(dataclasses.replace(r_get_config(arch, reduced=True), dtype="float32"), attn_impl="chunked")
        box = {}

        def init(key):
            params, box["specs"] = model.init(key)
            return params

        params = jax.jit(init)(jax.random.PRNGKey(0))  # the specs read while tracing; eager init: ~3 x the time
        res = RServeEngine(model, params, RServeConfig(**SCFG)).run(_prompts(), max_new=MAX_NEW)
        (out / arch).mkdir()
        np.savez(out / arch / "weights.npz", **_flat(params))
        (out / arch / "tokens.json").write_text(json.dumps({str(k): v for k, v in res.items()}))
        (out / arch / "specs.json").write_text(json.dumps(box["specs"]))
    return str(out)


def _gathered(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _collective_cases(mesh, ran):
    """psum / pmax bitwise equal on every rank and within 1e-6 of
    SimMesh's rank-order sum; the same over the model rings of a (2, 2)
    grid (its data rows sum apart)."""
    from repro_torch.core import ProcessGroupMesh

    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal((3, 40)).astype(np.float32)) for r in range(P)]
    mine = xs[mesh.rank]
    for op in ("psum", "pmax"):
        got = getattr(mesh, op)([mine])[0]
        assert got is not mine and torch.equal(mine, xs[mesh.rank])  # the caller's block is left as it was
        exp = getattr(SimMesh(P, device="cpu"), op)(xs)[0]
        assert rel(got, exp) <= 1e-6, op
        assert all(torch.equal(torch.from_numpy(g), got) for g in _gathered(got.numpy())), op
    grid = ProcessGroupMesh(device="cpu", grid=(2, 2), axis_names=DATA_MODEL, timeout_s=60)
    got = grid.psum([mine], "model")[0]
    exp = SimMesh((2, 2), axis_names=DATA_MODEL, device="cpu").psum(xs, "model")[mesh.rank]
    assert rel(got, exp) <= 1e-6
    row = [g for r, g in enumerate(_gathered(got.numpy())) if r // 2 == mesh.rank // 2]
    assert all(np.array_equal(g, got.numpy()) for g in row)
    ran.append("psum / pmax")


def _placement_cases(mesh, ran, ref_dir):
    """Model(cfg, mesh).init keeps this rank's block of every leaf its
    placement splits, bitwise the one-rank model's slice; the reference's
    weights through params_from_numpy likewise. Qwen's 2 KV heads stay
    whole (4 does not divide them), its 4 heads split one a rank."""
    from repro_torch.core import sharding as S

    cfg = _cfg(QWEN)
    units = head_units(cfg)
    own, specs = Model(cfg, mesh, device="cpu").init(torch.Generator().manual_seed(3))
    whole, _ = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    cut = 0
    for key, (a, b) in _pairs(own, whole):
        where = S.block(mesh, _spec_at(specs, key), b.shape, units)
        cut += where is not None
        for dim, first, count, _ in where or ():
            b = b.narrow(dim, first, count)
        assert torch.equal(a, b), key
    attn = own["layers"]["attn"]
    assert attn["wq"].shape == (2, 64, 16) and attn["wk"].shape == (2, 64, 32) and attn["wo"].shape == (2, 16, 64)
    assert own["embed"]["table"].shape == (64, 64) and own["layers"]["ffn"]["wd"].shape == (2, 40, 64)
    assert cut == 8, cut  # table, unembed, wq, bq, wo, wg, wu, wd: no other leaf
    arrays = np.load(f"{ref_dir}/{QWEN}/weights.npz")
    rspecs = _tuples(json.loads(open(f"{ref_dir}/{QWEN}/specs.json").read()))
    tree = _unflat(arrays)
    got = params_from_numpy(tree, device="cpu", mesh=mesh, specs=rspecs, cfg=cfg)
    for key, (a, b) in _pairs(got, tree):
        exp = b
        for dim, first, count, _ in S.block(mesh, _spec_at(rspecs, key), b.shape, units) or ():
            exp = exp[(slice(None),) * dim + (slice(first, first + count),)]
        assert np.array_equal(a.numpy(), exp), key
    with pytest.raises(ValueError, match="head count"):
        params_from_numpy(tree, device="cpu", mesh=mesh, specs=rspecs)
    _ssm_placement_cases(mesh)
    ran.append("each rank holds its blocks")


def _ssm_placement_cases(mesh):
    """The SSM leaves of a rank at P = 4 (reduced: d_model 64, d_inner
    128): Mamba's ``win`` and the mLSTM's ``wup`` hold each half's 32
    channels, ``[x_c | z_c]``; the sLSTM's ``wx`` a contiguous quarter
    (its columns are per-head (z, i, f, o)); its ``wup`` / ``wdown`` stay
    whole (dff 85); the mLSTM's ``wq`` its heads' columns and ``wif`` its
    heads of ``[i | f]`` (at 4 heads; the reduced 2 stay whole), its cell
    state its heads; the Mamba state the rank's channels. ``init`` and
    ``params_from_numpy`` keep the same."""
    c = mesh.rank
    for arch, kw in (("xlstm-1.3b", {}), ("xlstm-1.3b", XLSTM_4_HEADS), ("hymba-1.5b", {})):
        cfg = _cfg(arch, **kw)
        whole, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(7))
        own, _ = Model(cfg, mesh, device="cpu").init(torch.Generator().manual_seed(7))
        loaded = params_from_numpy(_np(whole), device="cpu", mesh=mesh, specs=specs, cfg=cfg)
        for key, (a, b) in _pairs(own, loaded):
            assert torch.equal(a, b), (arch, key)
        if arch == "hymba-1.5b":
            win, w = own["hymba"]["mamba"]["win"], whole["hymba"]["mamba"]["win"]
            assert win.shape == (3, 64, 64)
            assert torch.equal(win, torch.cat([w[..., 32 * c:32 * c + 32], w[..., 128 + 32 * c:160 + 32 * c]], -1))
            assert torch.equal(own["hymba"]["mamba"]["a_log"], whole["hymba"]["mamba"]["a_log"][:, 32 * c:32 * c + 32])
            assert torch.equal(own["hymba"]["attn"]["wk"], whole["hymba"]["attn"]["wk"])  # 2 KV heads stay whole
            st = Model(cfg, mesh, device="cpu").init_decode_state(2, 16)["hymba"]
            assert st.mamba.h.shape == (3, 2, 32, 8) and st.mamba.conv.shape == (3, 2, 3, 32)
            continue
        m, s_ = own["pairs"]["m"], own["pairs"]["s"]
        wm, ws = whole["pairs"]["m"], whole["pairs"]["s"]
        assert torch.equal(m["wup"], torch.cat([wm["wup"][..., 32 * c:32 * c + 32],
                                                wm["wup"][..., 128 + 32 * c:160 + 32 * c]], -1))
        assert torch.equal(m["conv"], wm["conv"][..., 32 * c:32 * c + 32])
        assert torch.equal(s_["wx"], ws["wx"][..., 64 * c:64 * c + 64])
        assert torch.equal(s_["wup"], ws["wup"]) and torch.equal(s_["wdown"], ws["wdown"])
        st = Model(cfg, mesh, device="cpu").init_decode_state(2, 16)["pairs"]
        assert st.m.conv.shape == (1, 2, 3, 32)
        if kw:  # 4 heads of 32: one a rank
            assert torch.equal(m["wq"], wm["wq"][..., 32 * c:32 * c + 32])
            assert torch.equal(m["wif"], wm["wif"][..., [c, 4 + c]])
            assert st.m.cell.c.shape == (1, 2, 1, 32, 32)
        else:  # 2 heads: whole on every rank
            assert torch.equal(m["wq"], wm["wq"]) and torch.equal(m["wif"], wm["wif"])
            assert st.m.cell.c.shape == (1, 2, 2, 64, 64)


def _model_cases(mesh, ran):
    """Model(cfg, ProcessGroupMesh) against the one-rank model on the
    same weights, heads and context partition: logits (the rings over
    gloo), prefill and two decode steps within 1e-5, every rank's logits
    bitwise equal."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 18)))
    for kw in ({}, {"attn_partition": "context"}):
        cfg = _cfg(QWEN, **kw)
        whole, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
        own = params_from_numpy(_np(whole), device="cpu", mesh=mesh, specs=specs, cfg=cfg)
        got = _run(Model(cfg, mesh, device="cpu"), own, toks)
        exp = _run(Model(cfg, device="cpu"), whole, toks)
        for g, e in zip([got[0]] + got[1], [exp[0]] + exp[1]):
            assert rel(g, e) <= REL_TOL, kw
        assert all(np.array_equal(g, got[1][-1].numpy()) for g in _gathered(got[1][-1].numpy())), kw
        _cut_cache_case(got[2]["layers"], exp[2]["layers"], mesh.rank, kw)
    enc = torch.from_numpy(np.random.default_rng(2).standard_normal((2, S_ENC, 64)).astype(np.float32))
    for arch, kw in MESH_ARCHS:
        cfg = _cfg(arch, **kw)
        e = enc if cfg.is_encdec else None
        whole, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
        own = params_from_numpy(_np(whole), device="cpu", mesh=mesh, specs=specs, cfg=cfg)
        got = _run(Model(cfg, mesh, device="cpu"), own, toks, e)
        exp = _run(Model(cfg, device="cpu"), whole, toks, e)
        for g, x in zip([got[0]] + got[1], [exp[0]] + exp[1]):
            assert rel(g, x) <= REL_TOL, arch
        mine = np.stack([got[0][:, -1].numpy()] + [t.numpy() for t in got[1]])
        assert all(np.array_equal(g, mine) for g in _gathered(mine)), arch
    ran.append("the model over gloo")


def _cut_cache_case(got, exp, c: int, kw) -> None:
    """Reduced Qwen's cache on a rank at P = 4 after a prefill and two
    decode steps: its 2 KV heads do not divide 4, so the rank holds the
    (L, B, S, 2, 16 / 4) slice c of the head dim, as the reference's
    ``decode_state_shardings`` cuts it -- within 1e-5 of the one-rank
    cache's slice, and bitwise in the first layer, whose K / V come from
    the same inputs on every rank (the later layers' inputs differ by the
    psums' order)."""
    for g, e in ((got.k, exp.k), (got.v, exp.v)):
        assert g.shape == e.shape[:4] + (e.shape[4] // P,), (kw, g.shape)
        e = e[..., 4 * c:4 * c + 4]
        assert torch.equal(g[0], e[0]) and rel(g, e) <= REL_TOL, kw
    assert torch.equal(got.length, exp.length)


def _seq_shard_case(ran):
    """Reduced hymba with one KV head (the ``model`` axis of 2 cuts its head
    dim) on a (2, 2) grid at batch 1 with ``seq_shard`` (its 18 + 8 meta
    positions in two blocks over ``data``): each rank holds a quarter of
    the cache, (L, 1, 13, 1, 8), bitwise its block of the one-rank cache
    in the first layer and within 1e-5 in all; the prefill and two decode
    steps (the scores' psum over ``model``, then the combine over
    ``data``) within 1e-5 of the one-rank model's, bitwise equal on every
    rank."""
    from repro_torch.core import ProcessGroupMesh

    grid = ProcessGroupMesh(device="cpu", grid=(2, 2), axis_names=DATA_MODEL, timeout_s=60)
    d, c = grid.axis_index("data"), grid.axis_index("model")
    cfg = _cfg("hymba-1.5b", num_kv_heads=1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 18)))
    whole, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    own = params_from_numpy(_np(whole), device="cpu", mesh=grid, specs=specs, cfg=cfg)
    model = Model(cfg, grid, device="cpu")
    got = _run(model, own, toks, seq_shard=True)
    exp = _run(Model(cfg, device="cpu"), whole, toks)
    assert model.serve_tp.kv_seq.blocks == 2 and model.serve_tp.kv_seq.holds_block
    for g, e in zip([got[0]] + got[1], [exp[0]] + exp[1]):
        assert rel(g, e) <= REL_TOL
    for g, e in ((got[2]["hymba"].kv.k, exp[2]["hymba"].kv.k), (got[2]["hymba"].kv.v, exp[2]["hymba"].kv.v)):
        assert g.numel() * 4 == e.numel() and g.shape == (e.shape[0], 1, 13, 1, 8)
        e = e[:, :, 13 * d:13 * d + 13, :, 8 * c:8 * c + 8]
        assert torch.equal(g[0], e[0]) and rel(g, e) <= REL_TOL
    mine = np.stack([t.numpy() for t in got[1]])
    assert all(np.array_equal(g, mine) for g in _gathered(mine))
    _latent_seq_case(grid, d)
    ran.append("the cut cache over gloo")


def _latent_seq_case(grid, d: int) -> None:
    """Reduced DeepSeek-V3 (capacity E / k: no drop, so the MoE's groups
    do not move the values) on the (2, 2) grid at batch 1 with
    ``seq_shard``: its 18 positions in two blocks of 9 over ``data``, each
    rank holding its (L, 1, 9, r) block of ``ckv`` and ``k_rope`` alone. An
    8-token prompt and two decode steps, at positions 8 (the first block's
    last row) and 9 (the second block's first): within 1e-5 of the
    one-rank model, bitwise equal on every rank; the blocks within 1e-5
    of the one-rank cache's."""
    cfg = _cfg("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=_no_drop(cfg)))
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 10)))
    whole, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    own = params_from_numpy(_np(whole), device="cpu", mesh=grid, specs=specs, cfg=cfg)
    model = Model(cfg, grid, device="cpu")
    got = _run_from(model, own, toks, 8, 18, seq_shard=True)
    exp = _run_from(Model(cfg, device="cpu"), whole, toks, 8, 18)
    assert model.serve_tp.kv_seq.blocks == 2 and model.serve_tp.kv_seq.holds_block
    for g, e in zip(got[0], exp[0]):
        assert rel(g, e) <= REL_TOL
    for group in ("dense_prefix", "moe"):
        for g, e in zip(got[1][group][:2], exp[1][group][:2]):
            assert g.shape == e.shape[:2] + (9,) + e.shape[3:], (group, g.shape)
            assert rel(g, e[:, :, 9 * d:9 * d + 9]) <= REL_TOL, group
    mine = np.stack([t.numpy() for t in got[0]])
    assert all(np.array_equal(g, mine) for g in _gathered(mine))


def _no_drop(cfg) -> float:
    """The capacity factor at which no expert drops a token: E / k."""
    return cfg.moe.num_experts / cfg.moe.top_k


def _run_from(model, params, toks, prompt: int, s_max: int, *, seq_shard=False):
    """A prefill of ``toks[:, :prompt]`` and a decode step for each later
    token (float32 cache of ``s_max`` positions): (their logits, the
    state)."""
    state = model.init_decode_state(toks.shape[0], s_max, cache_dtype=torch.float32, seq_shard=seq_shard)
    state, lg = model.prefill(params, {"tokens": toks[:, :prompt]}, state)
    steps = [lg]
    for t in range(prompt, toks.shape[1]):
        lg, state = model.decode_step(params, toks[:, t:t + 1], state)
        steps.append(lg)
    return steps, state


#: the dense dispatch's case: B rows of S tokens, one row a rank of the (P, 1) grid
DENSE_B, DENSE_S = P, 4


def _dense_inputs():
    """Reduced DeepSeek-V3's MoE with the dense dispatch and no shared
    expert, float32; its weights, input and the output's cotangent from
    one numpy seed."""
    cfg = _cfg("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="dense", num_shared=0))
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    rng = np.random.default_rng(11)
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d), "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wu": rng.standard_normal((e, d, f)) / np.sqrt(d), "wd": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x, g = (rng.standard_normal((DENSE_B, DENSE_S, d)).astype(np.float32) for _ in range(2))
    return cfg, w, x, g


def _dense_dispatch_case(ran, tmp):
    """``apply_moe`` with the dense dispatch where each process holds its
    row of the batch (``TP.batch`` over ``data`` of a (P, 1) grid): its
    output rows, its aux (the same on every rank) and, from its share of
    ``sum(out * g) + aux`` (``Model.loss`` divides the aux by the P
    ranks), its router gradient, saved for the test to hold to the
    reference."""
    from repro_torch.core import ProcessGroupMesh
    from repro_torch.models import common
    from repro_torch.models import moe

    grid = ProcessGroupMesh(device="cpu", grid=(P, 1), axis_names=DATA_MODEL, timeout_s=60)
    r = grid.axis_index("data")
    cfg, w, x, g = _dense_inputs()
    p = {k: torch.from_numpy(v).requires_grad_(k == "router") for k, v in w.items()}
    ring = grid.rings("model")[0][0]
    out, aux = moe.apply_moe(p, torch.from_numpy(x[r:r + 1]), cfg, mesh=ring,
                             tp=common.TP(ring, batch=(grid, ("data",))))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(g[r:r + 1])).sum() + aux / P, [p["router"]])
    np.savez(f"{tmp}/dense{grid.rank}.npz", row=r, out=out.detach().numpy(), aux=aux.detach().numpy(),
             grad=grad.numpy())
    ran.append("dense dispatch over rows")


def _engine_case(mesh, ran, ref_dir):
    """The SPMD ServeEngine on the reference's weights: its greedy tokens
    equal the reference engine's on every rank, for Qwen (heads split)
    and hymba (its Mamba channels split, its state trees each rank's)."""
    from repro_torch.serve import ServeEngine

    for arch in ENGINE_ARCHS:
        cfg = _cfg(arch)
        arrays = np.load(f"{ref_dir}/{arch}/weights.npz")
        specs = _tuples(json.loads(open(f"{ref_dir}/{arch}/specs.json").read()))
        params = params_from_numpy(_unflat(arrays), device="cpu", mesh=mesh, specs=specs, cfg=cfg)
        eng = ServeEngine(Model(cfg, mesh, attn_impl="chunked", device="cpu"), params, ServeConfig(**SCFG))
        got = {str(k): v for k, v in eng.run(_prompts(), max_new=MAX_NEW).items()}
        assert got == json.loads(open(f"{ref_dir}/{arch}/tokens.json").read()), (arch, got)
        assert eng.agreements >= len(_prompts()) + MAX_NEW
        assert all(g == got for g in _gathered(got))
    ran.append("SPMD engine equals the reference")


def _np(tree):
    return {k: (_np(v) if isinstance(v, dict) else v.numpy()) for k, v in tree.items()}


def _tuples(specs):
    """JSON's lists back into spec tuples."""
    if isinstance(specs, dict):
        return {k: _tuples(v) for k, v in specs.items()}
    return tuple(specs)


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
        _collective_cases(mesh, ran)
        _placement_cases(mesh, ran, ref_dir)
        _model_cases(mesh, ran)
        _seq_shard_case(ran)
        _dense_dispatch_case(ran, tmp)
        _engine_case(mesh, ran, ref_dir)
        with open(f"{tmp}/ran{rank}.json", "w") as fh:
            json.dump(ran, fh)
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_over_a_process_group(tmp_path, engine_refs):
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(P, f"file://{tmp_path / 'rendezvous'}", str(tmp_path), engine_refs), nprocs=P, join=True)
    for rank in range(P):
        ran = json.loads((tmp_path / f"ran{rank}.json").read_text())
        assert ran == ["psum / pmax", "each rank holds its blocks", "the model over gloo",
                       "the cut cache over gloo", "dense dispatch over rows", "SPMD engine equals the reference"], \
            (rank, ran)
    _dense_against_the_reference(tmp_path)


def _dense_against_the_reference(tmp):
    """The spawn's dense dispatch over rows against the reference's
    ``_apply_moe_dense`` on the whole batch: each rank's output row, the
    aux on every rank, and the router gradient summed over the ranks, each
    within 1e-5 (float32)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as r_get_config
    from repro.models import moe as RM

    cfg, w, x, g = _dense_inputs()
    rcfg = dataclasses.replace(r_get_config("deepseek-v3-671b", reduced=True), dtype="float32", moe=cfg.moe)

    def loss(router):
        out, aux = RM._apply_moe_dense(dict(w, router=router), jnp.asarray(x.reshape(-1, x.shape[-1])), rcfg)
        return (out * g.reshape(out.shape)).sum() + aux, (out, aux)

    (_, (out, aux)), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w["router"]))
    out = np.asarray(out).reshape(x.shape)
    got = [np.load(tmp / f"dense{rank}.npz") for rank in range(P)]
    assert sorted(int(a["row"]) for a in got) == list(range(P))
    for a in got:
        assert rel(a["out"], out[int(a["row"])][None]) <= REL_TOL
        assert abs(float(a["aux"]) - float(aux)) <= REL_TOL * abs(float(aux))
    assert rel(sum(a["grad"] for a in got), np.asarray(grad)) <= REL_TOL


# ---------------------------------------------------------------------------
# SimMesh against the reference under a jax mesh
# ---------------------------------------------------------------------------


MESH_CASES = [c + (c[0], False) for c in CASES] + [c + (True,) for c in SEQ_CASES]


@pytest.mark.parametrize("name,arch,dims,kw,ref_name,seq_shard", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_model_on_a_mesh_matches_reference(ref, monkeypatch, name, arch, dims, kw, ref_name, seq_shard):
    """logits (S = 16: the sequence-parallel rings, one reduce-scatter per
    sublayer), prefill and two decode steps (the psum form), float32
    caches, against the reference's Model(cfg, mesh). With ``seq_shard``
    (SEQ_CASES) the cache's 18 (+ 8 meta) positions lie in two blocks over
    ``data``, each ``model`` coordinate's heads combining them once a
    step and layer."""
    scatters, combines = [], []
    orig = overlap.ring_reduce_scatter
    monkeypatch.setattr(overlap, "ring_reduce_scatter", lambda *a, **k: scatters.append(1) or orig(*a, **k))
    combine = A.flash_decode_combine
    monkeypatch.setattr(A, "flash_decode_combine", lambda *a: combines.append(1) or combine(*a))
    cfg = _cfg(arch, **kw)
    model = Model(cfg, _mesh(*dims), attn_impl="chunked", device="cpu")
    params = params_from_numpy(_unflat(ref, f"w/{arch}"), device="cpu")
    recurrent = cfg.family in ("ssm", "hybrid")
    assert model.seq_parallel(16) is not recurrent and model.tp.p == dims[1]
    enc = torch.from_numpy(ref["enc"]) if cfg.is_encdec else None
    logits, steps, _ = _run(model, params, torch.from_numpy(ref["toks"]), enc, seq_shard=seq_shard)
    assert rel(logits, ref[f"{ref_name}/logits"]) <= REL_TOL
    for got, exp in zip(steps, ref[f"{ref_name}/steps"]):
        assert rel(got, exp) <= REL_TOL
    assert (model.serve_tp.kv_seq is not None) is seq_shard
    assert len(combines) == (2 * cfg.num_layers * dims[1] if seq_shard else 0)  # a step, layer and coordinate
    moe_layers = 0 if cfg.moe is None else cfg.num_layers - cfg.moe.first_k_dense
    # attention + dense FFN (+ whisper's cross-attention, and its encoder's layers in logits and again in
    # prefill); a MoE FFN gathers the sequence; the SSM and hybrid models keep it whole
    expect = 0 if recurrent else 2 * cfg.num_layers - moe_layers + cfg.is_encdec * (cfg.num_layers
                                                                                     + 4 * cfg.encoder_layers)
    assert len(scatters) == expect


def _ds_no_drop():
    cfg = get_config("deepseek-v3-671b", reduced=True)
    return {"moe": dataclasses.replace(cfg.moe, capacity_factor=_no_drop(cfg))}


@pytest.mark.parametrize("arch,kw", [("hymba-1.5b", {"num_kv_heads": 1}), ("gemma2-9b", {"window_size": 4}),
                                     ("deepseek-v3-671b", _ds_no_drop())],
                         ids=["hymba_1kv", "gemma_window_4", "deepseek_no_drop"])
def test_a_sequence_sharded_cache_on_a_sim_mesh_matches_one_rank(arch, kw):
    """``seq_shard`` on SimMesh((2, 2)) against the one-rank model on the
    same weights, within 1e-5: reduced hymba with one KV head (the
    ``model`` axis cuts its head dim, so the scores' psum over ``model``
    runs before the combine over ``data``), reduced gemma2 with 4-token
    windows, whose windowed layers see no key of the first block when
    they decode positions 16 and 17 (m = -inf, l = 0 there), and reduced
    DeepSeek-V3's latent cache (capacity E / k: the MoE's groups follow
    the mesh, and without drops they do not move the values). A third
    decode step at position 18, past the cache's 18 positions, writes no
    block and attends every cached one, as the one-rank model (and JAX,
    which drops the write) does. The cache stays whole on the one
    process."""
    cfg = _cfg(arch, **kw)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 19)))
    whole, _ = Model(cfg, device="cpu").init(torch.Generator().manual_seed(6))
    model = Model(cfg, _mesh(2, 2), device="cpu")
    got = _run(model, whole, toks, seq_shard=True)
    exp = _run(Model(cfg, device="cpu"), whole, toks)
    assert model.serve_tp.kv_seq.blocks == 2 and not model.serve_tp.kv_seq.holds_block
    past = [m.decode_step(whole, toks[:, 18:19], run[2])[0] for m, run in ((model, got), (Model(cfg, device="cpu"), exp))]
    for g, e in zip([got[0]] + got[1] + past[:1], [exp[0]] + exp[1] + past[1:]):
        assert rel(g, e) <= REL_TOL
    key = {"hybrid": "hymba", "moe": "moe"}.get(cfg.family, "layers")
    cache, ref_cache = ((run[2][key].kv if cfg.family == "hybrid" else run[2][key]) for run in (got, exp))
    assert cache[0].shape == ref_cache[0].shape and rel(cache[0], ref_cache[0]) <= REL_TOL


def test_flash_decode_combine_matches_reference(ref):
    """Each of 4 ranks' partial online softmax over its 16 keys, combined
    by pmax + two psums over a SimMesh axis named "data", against the
    reference's shard_map and the port's one-rank attention."""
    q, k, v = (torch.from_numpy(ref[f"flash/{n}"]) for n in "qkv")
    mesh = SimMesh(P, axis_name="data", device="cpu")
    outs, ms, ls = [], [], []
    for kb, vb in zip(mesh.split(k, (None, "data", None, None)), mesh.split(v, (None, "data", None, None))):
        s = torch.einsum("bqhd,bkhd->bhqk", q / np.sqrt(q.shape[-1]), kb)[:, :, 0]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        outs.append(torch.einsum("bhk,bkhd->bhd", p, vb)[:, None])
        ms.append(m)
        ls.append(p.sum(-1))
    got = A.flash_decode_combine(outs, ms, ls, mesh, "data")
    one = A.attention_naive(q, k, v, A.AttnSpec(causal=False))
    for g in got:
        assert rel(g, ref["flash/out"]) <= REL_TOL and rel(g, one) <= REL_TOL


def test_heads_are_placed_whole():
    """The half-head trap: the reference resolves Qwen's reduced wk (2 KV
    heads of 16, flattened to 32 columns) to a model split at P = 4, half
    a head a rank; the port's placement keeps it whole and splits wq's 4
    heads, and without the head counts it refuses to place a head dim."""
    cfg, mesh = _cfg(QWEN), _mesh(1, P)
    units = head_units(cfg)
    assert sharding.resolve(mesh, "fsdp", "kv_heads", shape=(64, 32)) == ("data", "model")
    assert sharding.placement(mesh, ("fsdp", "kv_heads"), (64, 32), units) == (None, None)
    assert sharding.placement(mesh, ("fsdp", "heads"), (64, 64), units) == (None, "model")
    assert sharding.placement(mesh, ("vocab", "fsdp"), (256, 64)) == ("model", None)
    assert sharding.placement(mesh, ("fsdp", "mlp"), (64, 160)) == (None, "model")
    assert sharding.placement(_mesh(1, 3), ("fsdp", "mlp"), (64, 160)) == (None, None)
    with pytest.raises(ValueError, match="head count"):
        sharding.placement(mesh, ("fsdp", "kv_heads"), (64, 32))

    class OneRankOfFour(SimMesh):  # a rank's view of a 4-rank group, as tests/test_torch_lm_ep.py's
        caller_holds_block = True

        def axis_index(self, axis_name):
            return 2

    whole, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = params_from_numpy(_np(whole), device="cpu", mesh=OneRankOfFour(P, device="cpu"), specs=specs, cfg=cfg)
    attn = got["layers"]["attn"]
    assert torch.equal(attn["wk"], whole["layers"]["attn"]["wk"])
    assert torch.equal(attn["wq"], whole["layers"]["attn"]["wq"][..., 32:48])
    assert torch.equal(attn["bq"], whole["layers"]["attn"]["bq"][..., 32:48])
    assert torch.equal(got["embed"]["unembed"], whole["embed"]["unembed"][:, 128:192])


def test_psum_and_pmax_sum_each_ring_in_rank_order():
    """SimMesh's psum / pmax over one axis of a grid: each ring of the
    axis reduced apart, its ranks' blocks in rank order."""
    mesh = _mesh(2, 2)
    xs = [torch.full((3,), float(v)) for v in (1.0, 2.0, 4.0, 8.0)]  # ranks (0,0) (0,1) (1,0) (1,1)
    assert [float(t[0]) for t in mesh.psum(xs, "model")] == [3.0, 3.0, 12.0, 12.0]
    assert [float(t[0]) for t in mesh.psum(xs, "data")] == [5.0, 10.0, 5.0, 10.0]
    assert [float(t[0]) for t in mesh.pmax(xs, "model")] == [2.0, 2.0, 8.0, 8.0]
    assert [float(t[0]) for t in SimMesh(4, device="cpu").psum(xs)] == [15.0] * 4


@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_the_cache_cut_is_the_references_rule(p):
    """``attention.cache_model_dim`` -- the dim of the KV cache the model
    cuts over ``model``, which the port's ``launch.specs._leaf_spec``
    reads -- is the reference's ``_leaf_spec`` decision for every full
    config with a KV cache at ``p`` ranks: the dim it places ``model``
    on, none where that dim's size does not divide (its ``sanitize_spec``
    drops the axis); and the port's spec of the cache is the reference's,
    with and without ``seq_shard``."""
    from repro.launch.specs import _leaf_spec as ref_leaf_spec
    from repro_torch.configs import _MODULES
    from repro_torch.launch.specs import _leaf_spec

    for arch in _MODULES:
        cfg = get_config(arch)
        if cfg.mla is not None or cfg.family == "ssm":
            continue
        shape = (cfg.num_layers, 8, 64, cfg.num_kv_heads, cfg.head_dim_)
        ref = ref_leaf_spec(".layers.k", 5, ba=None, seq_shard=False, shape=shape, tp=p)
        dim = tuple(ref).index("model")
        assert A.cache_model_dim(shape[3], shape[4], p) == (dim - 1 if shape[dim] % p == 0 else None), arch
        for ba, seq in ((("pod", "data"), False), (None, True)):
            assert _leaf_spec(".layers.v", 5, ba=ba, seq_shard=seq, shape=shape, tp=p) == \
                tuple(ref_leaf_spec(".layers.v", 5, ba=ba, seq_shard=seq, shape=shape, tp=p)), (arch, ba, seq)
