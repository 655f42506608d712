"""The port's dry run (``repro_torch.launch.dryrun``): a walk over the
placement specs on the ``meta`` device, held to the reference's
compiled ``memory_analysis()`` and its analytic FLOPs.

One reference subprocess over 4 host devices (scoped to the module)
lowers and compiles ``repro.launch.dryrun.lower_cell`` of four reduced
cells on (2, 2), (4, 1) and (1, 4) ``("data", "model")`` meshes and
reports, beside ``memory_analysis()``, each argument's and each
output's block on a device and the arguments its jit prunes as unused.
The port's ``arguments`` / ``outputs`` name the same leaves; every
difference is a named departure (``PLACED``, ``SERVING_DTYPE``,
``HOST_POS``) or a leaf the reference does not hold (pruned, re-sharded
by its compiler). The state collectives are held to the gloo counter in
``tests/test_torch_train_fsdp.py``'s spawn.
"""

import json
import os

import pytest
import torch

from conftest import run_subprocess

CELLS = [("qwen2.5-32b", "train_4k"), ("deepseek-v3-671b", "decode_32k"), ("xlstm-1.3b", "long_500k"),
         ("hymba-1.5b", "prefill_32k")]
GRIDS = [(2, 2), (4, 1), (1, 4)]

#: the weights the port places otherwise than the reference's
#: ``tree_shardings`` / ``state_shardings`` (ROADMAP queue C): heads kept
#: whole where the ``model`` axis does not divide the KV heads (reduced
#: qwen's and hymba's 2 on 4), and ``ssm.MESH_LAYOUT``'s mLSTM projections
#: by whole heads (``wq`` / ``wk`` / ``wv`` / ``wif``) and the sLSTM's
#: packed ``wup`` (its 85-wide halves whole on 2)
PLACED = {
    ("qwen2.5-32b", (1, 4)): {"layers/attn/wk", "layers/attn/wv", "layers/attn/bk", "layers/attn/bv"},
    ("hymba-1.5b", (1, 4)): {"hymba/attn/wk", "hymba/attn/wv"},
    ("xlstm-1.3b", (2, 2)): {"pairs/m/wq", "pairs/m/wk", "pairs/m/wv", "pairs/m/wif", "pairs/s/wup"},
    ("xlstm-1.3b", (4, 1)): {"pairs/m/wq", "pairs/m/wk", "pairs/m/wv", "pairs/m/wif"},
    ("xlstm-1.3b", (1, 4)): {"pairs/m/wq", "pairs/m/wk", "pairs/m/wv", "pairs/m/wif"},
}
#: serving holds its weights in the model's dtype (cast once, at load);
#: the reference's abstract weights are ``init``'s float32
SERVING_DTYPE = "params/"
#: the decode position: a host int in the port, an int32 argument in the reference
HOST_POS = "state/pos"
#: the band the walk's shipped total of a cell lies in, as a multiple of
#: the reference's HLO total (test_shipped_collectives_against_the_reference_hlo).
#: The two are different programs: 0.27-0.61 where XLA ships more (it
#: re-shards activations by all-to-all and permutes, and serves from float32
#: weights, SERVING_DTYPE), 14.9-27.1 where the port gathers a batch-1
#: decode's weights over ``data`` (FSDP) and XLA keeps them sharded and
#: all-reduces the one token's activations instead
SHIPPED_BAND = (0.25, 30.0)
#: the kinds the reference's HLO ships on a cell and the port issues as
#: another kind, or not at all (ROADMAP queue C): XLA's all-to-alls
#: re-sharding the activations (the port's sequence-parallel rings hop by
#: collective-permute, its MoE decode gathers), its permutes of the
#: sequence-sharded Mamba / conv state and of the batch-1 decode, and the
#: all-reduces of a (4, 1) decode's activations (the port gathers the
#: weights)
KINDS_OTHERWISE = {
    ("qwen2.5-32b", "train_4k", (2, 2)): {"all-to-all"},
    ("qwen2.5-32b", "train_4k", (4, 1)): {"all-to-all"},
    ("qwen2.5-32b", "train_4k", (1, 4)): {"all-to-all"},
    ("deepseek-v3-671b", "decode_32k", (2, 2)): {"all-to-all", "collective-permute"},
    ("deepseek-v3-671b", "decode_32k", (4, 1)): {"all-to-all"},
    ("xlstm-1.3b", "long_500k", (2, 2)): {"collective-permute"},
    ("xlstm-1.3b", "long_500k", (4, 1)): {"all-reduce"},
    ("xlstm-1.3b", "long_500k", (1, 4)): {"all-to-all", "collective-permute"},
    ("hymba-1.5b", "prefill_32k", (2, 2)): {"collective-permute"},
    ("hymba-1.5b", "prefill_32k", (1, 4)): {"collective-permute"},
}
#: the bytes of a device pointer: ``output_size_in_bytes`` counts one for
#: every output of the compiled tuple beside the buffers
TUPLE_ENTRY = 8

REF_CODE = r"""
import json
import jax
import numpy as np

jax.devices()  # 4 host devices, before repro.launch.dryrun sets its 512-device XLA_FLAGS
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.configs.base import TrainConfig
from repro.core.compat import make_mesh
from repro.core import hlo_analysis
from repro.launch import dryrun
from repro.launch import specs as rspecs
from repro.models.model import Model
from repro.train import step as rstep


def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in path)


def blocks(prefix, tree, shardings=None):
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = [a.sharding for _, a in flat] if shardings is None else jax.tree.leaves(shardings)
    for (path, a), sh in zip(flat, shs):
        n = prefix + "/" + name(path) if path else prefix
        out[n.strip("/")] = int(np.prod(sh.shard_shape(a.shape), dtype=np.int64)) * np.dtype(a.dtype).itemsize
    return out


def arguments(arch, sname, mesh):
    # the arguments lower_cell builds (repro/launch/dryrun.py:81-126), leaf by leaf
    cfg, shape = get_config(arch, reduced=True), SHAPES[sname]
    model = Model(cfg, mesh=mesh, attn_impl="chunked")
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tcfg = TrainConfig(microbatch=4, opt_state_dtype="bfloat16")
        st_abs = jax.eval_shape(lambda k: rstep.init_train_state(model, k, tcfg)[0], jax.random.PRNGKey(0))
        st = rspecs.with_shardings(st_abs, rstep.state_shardings(mesh, dryrun._static_specs(model), st_abs))
        return [blocks("", st), blocks("batch", rspecs.batch_input_specs(cfg, shape, mesh))]
    st_abs = rspecs.abstract_decode_state(model, b, s)
    st = rspecs.with_shardings(st_abs, rspecs.decode_state_shardings(
        st_abs, mesh, replicate_batch=(b == 1), seq_shard=(sname == "long_500k")))
    params = blocks("params", dryrun._abstract_params(model))
    if shape.kind == "prefill":
        return [params, blocks("batch", rspecs.batch_input_specs(cfg, shape, mesh)), blocks("state", st)]
    ba = None if b == 1 else tuple(a for a in ("pod", "data") if a in mesh.shape)
    tok = jax.ShapeDtypeStruct((b, 1), np.int32, sharding=NamedSharding(mesh, P(ba, None)))
    return [params, blocks("batch/tokens", tok), blocks("state", st)]


OUT_NAMES = {"train": ("", "metrics"), "prefill": ("state", "logits"), "decode": ("logits", "state")}
res = {}
for arch, sname in __CELLS__:
    for dims in __GRIDS__:
        mesh = make_mesh(dims, ("data", "model"))  # the reference's own builder (jax.make_mesh raises here)
        lowered = dryrun.lower_cell(arch, sname, mesh, reduced=True)
        compiled = lowered.compile()
        ma = compiled.memory_analysis()
        per_arg = arguments(arch, sname, mesh)
        kept = lowered._lowering.compile_args["kept_var_idx"]
        flat_names = [n for group in per_arg for n in group]  # in the order jit flattens its arguments
        pruned = [n for i, n in enumerate(flat_names) if i not in kept]
        outs = {}
        first, second = OUT_NAMES[SHAPES[sname].kind]
        for i, (tree, shs) in enumerate(zip(lowered.out_info, compiled.output_shardings)):
            outs.update(blocks((first, second)[i], tree, shs))
        cost = hlo_analysis.analyze_compiled(compiled)  # the reference's run_cell collectives, loop-aware
        res[f"{arch}|{sname}|{dims[0]},{dims[1]}"] = {
            "ma": [ma.argument_size_in_bytes, ma.output_size_in_bytes, ma.alias_size_in_bytes],
            "args": {n: v for group in per_arg for n, v in group.items()}, "pruned": pruned, "outs": outs,
            "coll_counts": cost.coll_counts, "coll_bytes": cost.coll_bytes_by_kind}
print("RESULT" + json.dumps(res))
print("PASS")
"""


@pytest.fixture(scope="module")
def reference():
    code = REF_CODE.replace("__CELLS__", repr(CELLS)).replace("__GRIDS__", repr(GRIDS))
    out = run_subprocess(code, devices=4, timeout=600)
    line = next(x for x in out.splitlines() if x.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def _mesh(dims):
    from repro_torch.launch.mesh import MeshShape

    return MeshShape(dims, ("data", "model"))


def _port(arch, sname, dims):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    cfg, shape = get_config(arch, reduced=True), SHAPES[sname]
    return (cfg, shape, dryrun.arguments(cfg, shape, _mesh(dims)),
            dryrun.outputs(cfg, shape, _mesh(dims)),
            dryrun.cell_report(cfg, shape, _mesh(dims)))


def _departures(arch, dims, kind, names):
    """The argument names the port holds otherwise than the reference,
    by the named rules."""
    placed = PLACED.get((arch, dims), set())
    prefixes = ("params/", "opt/mu/", "opt/nu/") if kind == "train" else ("params/",)
    out = {p + leaf for p in prefixes for leaf in placed}
    if kind != "train":
        out.add(HOST_POS)
    assert out <= set(names), out - set(names)
    return out


def _normal(cfg, kind, name, nbytes):
    """A serving weight's bytes in float32, the reference's dtype."""
    if kind != "train" and name.startswith(SERVING_DTYPE):
        return nbytes * 4 // torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return nbytes


def _pruned(cfg, kind, names):
    """The arguments the reference's jit drops as unused (``keep_unused``
    is off): serving never reads the MTP module; prefill never reads the
    caches' lengths or the position it overwrites."""
    out = set()
    if kind != "train" and cfg.mtp_depth:
        out |= {n for n in names if n.startswith("params/mtp/")}
    if kind == "prefill":
        out |= {n for n in names if n.startswith("state/") and n.endswith("/length")} | {HOST_POS}
    return out


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("arch,sname", CELLS)
def test_argument_bytes_are_the_reference_memory_analysis(reference, arch, sname, dims):
    """``argument_bytes`` against ``memory_analysis().argument_size_in_bytes``
    of the reference's compiled step, to the byte: the same argument
    leaves by name, each block the reference's but for the named
    departures (heads whole, ``ssm.MESH_LAYOUT``, the serving weights'
    dtype, the host position) and the leaves the reference's jit prunes;
    the difference is exactly their bytes."""
    ref = reference[f"{arch}|{sname}|{dims[0]},{dims[1]}"]
    cfg, shape, args, _, rep = _port(arch, sname, dims)
    rargs = ref["args"]
    assert sorted(args) == sorted(rargs)
    pruned = set(ref["pruned"])
    assert pruned == _pruned(cfg, shape.kind, args)
    assert ref["ma"][0] == sum(v for n, v in rargs.items() if n not in pruned)
    differ = {n for n in args if _normal(cfg, shape.kind, n, args[n]) != rargs[n]}
    named = _departures(arch, dims, shape.kind, args)
    assert differ == named, (differ - named, named - differ)
    dtype = sum(args[n] - rargs[n] for n in args if n.startswith(SERVING_DTYPE) and n not in named) \
        if shape.kind != "train" else 0
    placed = sum(args[n] - rargs[n] for n in named)
    unused = sum(rargs[n] for n in pruned)
    assert rep["memory"]["argument_bytes"] == sum(args.values())
    assert rep["memory"]["argument_bytes"] - ref["ma"][0] == dtype + placed + unused
    if not named - {HOST_POS} and shape.kind == "train":
        assert rep["memory"]["argument_bytes"] == ref["ma"][0]


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("arch,sname", CELLS)
def test_output_and_alias_bytes_against_the_reference(reference, arch, sname, dims):
    """``output_bytes`` and ``alias_bytes`` against the reference's
    ``output_size_in_bytes`` / ``alias_size_in_bytes``: the same output
    leaves by name; the compiled tuple adds a pointer an output; a block
    differs only for a named departure, for the logits (the port gathers
    the vocabulary whole, the reference's compiled output keeps it over
    ``model``), or where the reference's compiler gave a donated leaf
    another sharding than its input's (a state leaf of every SSM cell).
    The reference aliases its donated state, but for the pruned leaves,
    exactly where its compiler re-sharded none, and less where it did
    (XLA decides which re-sharded buffers it reuses); the port's outputs
    are its state, updated in place, and all of it is aliased."""
    from repro_torch.launch import dryrun

    ref = reference[f"{arch}|{sname}|{dims[0]},{dims[1]}"]
    cfg, shape, args, outs, rep = _port(arch, sname, dims)
    routs, rargs, pruned = ref["outs"], ref["args"], set(ref["pruned"])
    assert sorted(outs) == sorted(routs)
    assert ref["ma"][1] == sum(routs.values()) + TUPLE_ENTRY * len(routs)
    state = {n for n in outs if n in args}
    assert state == {n for n in args if dryrun.donated(shape, n)}
    resharded = {n for n in state if routs[n] != rargs[n]}
    named = _departures(arch, dims, shape.kind, args)
    for n in outs:
        if _normal(cfg, shape.kind, n, outs[n]) != routs[n]:
            assert n in named | resharded | {"logits"}, n
    if "logits" in outs:
        assert outs["logits"] == routs["logits"] * dims[1]  # the vocabulary whole over model
    donated = sum(rargs[n] for n in state - pruned)
    if resharded - pruned:
        assert ref["ma"][2] < donated
    else:
        assert ref["ma"][2] == donated
        assert rep["memory"]["alias_bytes"] - ref["ma"][2] == \
            sum(args[n] - rargs[n] for n in state - pruned) + sum(args[n] for n in state & pruned)
    assert rep["memory"]["output_bytes"] == sum(outs.values())
    assert rep["memory"]["alias_bytes"] == sum(args[n] for n in state)


def _production_cells():
    from repro_torch.launch import dryrun

    return [(a, s, m) for a, s in dryrun.cells() for m in ("single", "multi")]


def test_model_flops_are_the_reference_formula():
    """``params``, ``active_params``, ``tokens_per_step`` and the model
    FLOPs of every cell on both production meshes equal the reference's
    formula (``repro/launch/dryrun.py:175-181``) on the reference's own
    config; the roofline prices the port's H100 bf16 peak."""
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    from repro_torch.core import comm_model
    from repro_torch.launch import dryrun

    cells = _production_cells()
    assert len(cells) == 64
    assert comm_model.PEAK_FLOPS_BF16 == 989e12
    for arch, sname, mk in cells:
        res = dryrun.run_cell(arch, sname, mk)
        rcfg, shape = rget(arch), RSHAPES[sname]
        chips = 512 if mk == "multi" else 256
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        flops = (6.0 if shape.kind == "train" else 2.0) * rcfg.active_param_count() * tokens
        assert (res["params"], res["active_params"], res["tokens_per_step"]) == \
            (rcfg.param_count(), rcfg.active_param_count(), tokens), (arch, sname)
        assert (res["chips"], res["model_flops_global"], res["model_flops_per_chip"]) == (chips, flops, flops / chips)
        r = res["roofline"]
        assert r["t_compute_s"] == r["flops"] / comm_model.PEAK_FLOPS_BF16
        assert r["flops"] >= res["model_flops_per_chip"] and 0 < res["useful_flops_frac"] <= 1


@pytest.mark.parametrize("arch,sname,mesh_kind", [
    ("qwen2.5-32b", "train_4k", "single"), ("qwen2.5-32b", "train_4k", "multi"),
    ("deepseek-v3-671b", "decode_32k", "multi"), ("xlstm-1.3b", "long_500k", "multi")])
def test_reduced_cells(arch, sname, mesh_kind):
    """The reference's ``tests/test_dryrun.py`` cases, reduced, on the
    shape-only production meshes."""
    from repro_torch.launch import dryrun

    res = dryrun.run_cell(arch, sname, mesh_kind, reduced=True)
    assert res["memory"]["peak_device_bytes"] > 0 and res["memory"]["peak_is_floor"]
    assert res["memory"]["temp_bytes"] is None
    r = res["roofline"]
    assert r["flops"] > 0 and r["bottleneck"] in ("compute", "memory", "collective")
    assert res["collectives"]["state"]["scope"] == "state collectives"


def test_main_writes_every_cell_and_touches_nothing(tmp_path):
    """``main(["--all", "--mesh", "both"])`` on the full configs: 64
    ``_torch.json`` files and exit 0, in one process that sets no
    environment variable, initialises no CUDA and joins no process
    group."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    env = dict(os.environ)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    assert done.value.code == 0
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 64 and all(f.endswith("_torch.json") for f in files)
    assert dict(os.environ) == env
    assert not torch.cuda.is_initialized() and not (dist.is_available() and dist.is_initialized())
    res = json.loads((tmp_path / "deepseek-v3-671b_train_4k_single_torch.json").read_text())
    assert res["memory"]["peak_is_floor"] and res["collectives"]["state"]["bytes"]["all-gather"] > 0


def test_a_mesh_is_read_by_its_shape():
    """``cell_report`` on a ``SimMesh`` (and, the same numbers, on a
    ``MeshShape`` of its axes): every rank is taken to hold its blocks."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import SimMesh
    from repro_torch.launch import dryrun

    cfg = get_config("mixtral-8x22b", reduced=True)
    for sname in ("train_4k", "decode_32k"):
        got = dryrun.cell_report(cfg, SHAPES[sname], SimMesh((2, 2), axis_names=("data", "model"), device="cpu"))
        assert got == dryrun.cell_report(cfg, SHAPES[sname], _mesh((2, 2)))


def test_the_walk_reproduces_the_four_card_fsdp_run():
    """Qwen2.5-32B at 8 of 64 layers, float32 state, 4 x 1024 tokens a
    step, as phase 7 of ``chip_smoke.py`` trains it on four H100s: the
    state a rank and FSDP's gathered and reduce-scattered bytes a step
    that run printed (15.25 GiB; 20.274 / 12.473 GB on (4, 1), 10.137 /
    6.236 GB on (2, 2), to the printed digits)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config("qwen2.5-32b"), num_layers=8)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=0, total_steps=3)
    shape = ShapeConfig("fsdp_big", 1024, 4, "train")
    for dims, (gathered, scattered) in {(4, 1): (20.274, 12.473), (2, 2): (10.137, 6.236)}.items():
        args = dryrun.arguments(cfg, shape, _mesh(dims), tcfg)
        assert f"{sum(v for n, v in args.items() if dryrun.donated(shape, n)) / 2**30:.2f}" == "15.25"
        moved = dryrun.cell_report(cfg, shape, _mesh(dims), tcfg=tcfg)["collectives"]["state"]["bytes"]
        assert (f"{moved['all-gather'] / 1e9:.3f}", f"{moved['reduce-scatter'] / 1e9:.3f}") == \
            (f"{gathered:.3f}", f"{scattered:.3f}")


def _loop_pairs(cfg, positions):
    """The per-position count ``chip_smoke.py`` used before the closed
    form (its ``train_model_flops``)."""
    from repro_torch.models.model import build_groups

    def visible(window):
        q = range(positions)
        if window <= 0:
            return sum(i + 1 for i in q)
        return sum(min(i + 1, window) + min(cfg.meta_tokens, max(0, i + 1 - window)) for i in q)

    return sum(visible(0 if (g.static_global if g.flags is None else g.flags[i]) else cfg.window_size)
               for g in build_groups(cfg) for i in range(g.count))


@pytest.mark.parametrize("arch,overrides", [
    ("qwen2.5-32b", {}),  # causal everywhere
    ("gemma2-9b", {"window_size": 7}),  # alternate window / global layers
    ("hymba-1.5b", {}),  # window 32, meta tokens 8, global first / middle / last layers
    ("hymba-1.5b", {"meta_tokens": 40, "window_size": 5, "num_layers": 5}),  # more meta tokens than the window
    ("mixtral-8x22b", {"window_size": 11}),  # a window everywhere
])
def test_attention_pairs_closed_form_is_the_loop(arch, overrides):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config(arch, reduced=True), **overrides)
    for positions in (1, 2, 5, 31, 32, 33, 40, 47, 100):
        assert dryrun.attention_pairs(cfg, positions) == _loop_pairs(cfg, positions), positions
    n = 1000
    assert dryrun.train_model_flops(cfg, 10, 64, n, 2) == 6.0 * 10 * 64 + 3.0 * 2 * dryrun._pair_flops(cfg) * \
        _loop_pairs(cfg, n)


def test_the_isolation_scan_covers_the_dry_run():
    """``tests/test_torch_isolation.py`` imports every port module with jax
    blocked and scans its source: the dry run is among them, and it sets
    no environment variable."""
    from test_torch_isolation import PKG, _modules

    assert "repro_torch.launch.dryrun" in _modules()
    text = (PKG / "launch" / "dryrun.py").read_text()
    assert "os.environ" not in text and "XLA_FLAGS" not in text


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("arch,sname", CELLS)
def test_shipped_collectives_against_the_reference_hlo(reference, arch, sname, dims, capsys):
    """The walk's shipped bytes by kind, printed beside
    ``hlo_analysis.analyze_compiled``'s of the reference's compiled step
    (its ``run_cell``'s ``collectives``): every kind the reference's HLO
    ships, the walk ships too, but for the kinds KINDS_OTHERWISE names;
    the totals lie within SHIPPED_BAND of each other. The band is wide
    because the two are not one program: the port issues each collective
    where its code does (remat's recompute, Megatron's "f" in the
    backward, the rings hop by hop), while XLA merges, re-shards and
    schedules its own. Every one of the 12 cells lies beyond 10 % of the
    reference's total; each is named in ROADMAP queue C."""
    ref = reference[f"{arch}|{sname}|{dims[0]},{dims[1]}"]
    cfg, shape, _, _, rep = _port(arch, sname, dims)
    walk = rep["collectives"]["bytes"]
    hlo = {k: float(ref["coll_bytes"].get(k, 0.0)) for k in walk}
    with capsys.disabled():
        print(f"\n{arch} {sname} {dims}: shipped bytes a rank, port walk {walk} (counts "
              f"{rep['collectives']['counts']}); reference HLO {hlo} (counts {ref['coll_counts']})")
    assert rep["roofline"]["coll_bytes"] == sum(walk.values())
    missing = {kind for kind, b in hlo.items() if b > 0 and not walk[kind] > 0}
    assert missing == KINDS_OTHERWISE.get((arch, sname, dims), set()), (missing, walk, hlo)
    total, ref_total = sum(walk.values()), sum(hlo.values())
    lo, hi = SHIPPED_BAND
    assert lo * ref_total <= total <= hi * ref_total, (total, ref_total)
    assert abs(total / ref_total - 1) > 0.1  # named in ROADMAP queue C


def test_collective_scaled_bytes_is_the_reference():
    """``comm_model.collective_scaled_bytes`` equals the reference's for
    every kind, group size and payload; ``shipped_bytes`` of a
    reduce-scatter's assembled operand is the reference's of its 1/P
    result."""
    from repro.core.comm_model import COLLECTIVE_KINDS as RKINDS
    from repro.core.comm_model import collective_scaled_bytes as rscaled
    from repro_torch.core import comm_model
    from repro_torch.core.mesh import COLLECTIVE_KINDS

    assert comm_model.COLLECTIVE_KINDS == RKINDS == COLLECTIVE_KINDS
    for kind in RKINDS:
        for p in (1, 2, 4, 16):
            for size in (0, 4, 4096, 3 * 2**20, 5 * 10**9):
                assert comm_model.collective_scaled_bytes(kind, size, p) == rscaled(kind, size, p), (kind, p, size)
                assembled = size * p if kind == "reduce-scatter" else size
                assert comm_model.shipped_bytes(kind, assembled, p) == rscaled(kind, size, p), (kind, p, size)


def test_an_all_reduce_cell_ships_two_thirds_over_what_it_assembles():
    """A cell whose only collectives are all-reduces -- reduced Qwen's
    prefill on a (1, 4) mesh (no batch axes: no state collectives), its
    vocabulary made indivisible by 4 (no logits gather): every attention
    and MLP output one psum -- prices ``2 (P - 1) / P`` of the bytes it
    assembles, as the reference's HLO analysis does. The old convention,
    the assembled bytes themselves, priced it at 2 / 3 of that."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config("qwen2.5-32b", reduced=True), vocab_size=251)
    rep = dryrun.cell_report(cfg, ShapeConfig("prefill", 64, 2, "prefill"), _mesh((1, 4)))
    coll = rep["collectives"]
    assembled = coll["activation"]["bytes"]["all-reduce"]
    assert coll["state"]["counts"] == dict.fromkeys(dryrun.KINDS, 0)
    assert {k: v for k, v in coll["activation"]["counts"].items() if v} == \
        {"all-reduce": 2 * cfg.num_layers}
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()  # bfloat16
    assert assembled == 2 * cfg.num_layers * 2 * 64 * cfg.d_model * itemsize
    assert rep["roofline"]["coll_bytes"] == coll["bytes"]["all-reduce"] == 2 * 3 / 4 * assembled
    assert rep["roofline"]["coll_bytes"] / assembled == 1.5  # the parent's coll_bytes was ``assembled``


def _sim_runs(cfg, mesh, tcfg, b: int, s: int):
    """What ``core.mesh.collectives("activation")`` counts in one train
    step, one prefill and one decode step of ``cfg`` (its own init) on
    ``mesh``, ``b`` rows of ``s`` positions (whisper: ``s`` frames)."""
    import numpy as np

    from repro_torch.core.mesh import collectives, reset_collectives
    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state, make_train_step

    rng = np.random.default_rng(0)
    model = Model(cfg, mesh, device="cpu")
    dec = max(s // cfg.decoder_ratio, 1) if cfg.is_encdec else s
    batch = {}
    if cfg.is_encdec or cfg.input_kind == "embeddings":
        batch["enc_embeds" if cfg.is_encdec else "embeds"] = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec or cfg.input_kind != "embeddings":
        batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, dec)))
    out = {}
    state, _ = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    reset_collectives()
    make_train_step(model, tcfg, mesh)(state, dict(batch, labels=torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, dec)))))
    out["train"] = collectives("activation")
    params = state.params
    cache = model.init_decode_state(b, s + 2)
    reset_collectives()
    cache, _ = model.prefill(params, batch, cache)
    out["prefill"] = collectives("activation")
    reset_collectives()
    model.decode_step(params, torch.zeros((b, 1), dtype=torch.int64), cache)
    out["decode"] = collectives("activation")
    return out


#: the archs whose every branch the SimMesh check below walks on 3 ranks:
#: heads, KV heads, d_ff, the SSM channels and the vocabulary divisible by 3
#: or not, sequence parallelism at 12 positions, the context partition
SIM_ARCHS = ["qwen2.5-32b", "mixtral-8x22b", "hymba-1.5b", "deepseek-v3-671b", "gemma2-9b", "whisper-medium",
             "phi-3-vision-4.2b", "xlstm-1.3b", "nemotron-4-15b", "phi3-medium-14b"]


@pytest.mark.parametrize("arch", SIM_ARCHS)
def test_sim_mesh_counts_are_the_walks(arch):
    """Every reduced arch in float32 on ``SimMesh((1, 3))``, 2 rows of 12
    positions: what ``core.mesh.collectives`` counts (one rank's share:
    the psums, gathers, all-to-alls and ring hops, the backward's "f"
    all-reduces and inverse all-to-alls) in one train step (microbatch 2,
    remat's recompute, the checkpointed loss chunks, MTP), one prefill and
    one decode step is ``launch.dryrun``'s ``activation`` entry with
    ``one_process``, bytes and counts of each kind, exactly."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.core import SimMesh
    from repro_torch.launch import dryrun

    from torch_train_common import one_thread

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    tcfg = TrainConfig(microbatch=2, warmup_steps=0, total_steps=10)
    mesh = SimMesh((1, 3), axis_names=("data", "model"), device="cpu")
    b, s = 2, 12
    with one_thread():
        got = _sim_runs(cfg, mesh, tcfg, b, s)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(kind, s, b, kind)
        walk = dryrun.cell_report(cfg, shape, mesh, tcfg=tcfg, one_process=True)["collectives"]["activation"]
        assert (got[kind]["counts"], got[kind]["bytes"]) == (walk["counts"], walk["bytes"]), kind
