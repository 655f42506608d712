"""The port's LM configs, sharding rules and parameter layout against the
reference: every arch's config field for field, ``apply_overrides``,
the pure half of ``core/sharding.py`` on the cases of
``tests/test_sharding.py``, and ``Model.init``'s specs and shapes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RCFG
import repro_torch.configs as CFG
from repro.core import sharding as RSH
from repro.models.model import Model as RModel
from repro.models.model import build_groups as r_build_groups
from repro_torch.core import sharding as SH
from repro_torch.models.model import Model, build_groups
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

ARCHS = sorted(RCFG.ARCHS)
DENSE = ["gemma2-9b", "nemotron-4-15b", "phi-3-vision-4.2b", "phi3-medium-14b", "qwen2.5-32b"]


def _fields(cfg) -> dict:
    return {"class": type(cfg).__name__, **dataclasses.asdict(cfg)}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, reduced):
    ref = RCFG.get_config(arch, reduced=reduced)
    got = CFG.get_config(arch, reduced=reduced)
    assert _fields(got) == _fields(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert (got.head_dim_, got.is_encdec, got.is_attention_free, got.supports_long_context) == (
        ref.head_dim_, ref.is_encdec, ref.is_attention_free, ref.supports_long_context)
    assert [dataclasses.astuple(g) for g in build_groups(got)] == [
        dataclasses.astuple(g) for g in r_build_groups(ref)]


def test_registry_tables_equal_reference():
    assert sorted(CFG.ARCHS) == ARCHS and sorted(CFG.REDUCED) == sorted(RCFG.REDUCED)
    for table in ("SHAPES", "SMOKE_SHAPES"):
        got, ref = getattr(CFG, table), getattr(RCFG, table)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in ref.items()}
    for smoke in (False, True):
        assert dataclasses.asdict(CFG.shape_for("decode_32k", smoke)) == dataclasses.asdict(
            RCFG.shape_for("decode_32k", smoke))
    for cls in ("ServeConfig", "TrainConfig", "MoEConfig", "MLAConfig", "SSMConfig"):
        assert dataclasses.asdict(getattr(CFG, cls)()) == dataclasses.asdict(getattr(RCFG, cls)())
    assert dataclasses.asdict(CFG.fft_bench.PAPER_2D) == dataclasses.asdict(RCFG.fft_bench.PAPER_2D)
    with pytest.raises(KeyError, match="unknown arch"):
        CFG.get_config("gpt-5")


@pytest.mark.parametrize("overrides", [
    {"num_layers": "3", "dtype": "float32"},
    {"qkv_bias": "false", "rope_theta": "500000.0"},
    {"attn_partition": "context", "post_norm": "True"},
])
def test_apply_overrides(overrides):
    got = CFG.apply_overrides(CFG.get_config("qwen2.5-32b"), overrides)
    ref = RCFG.apply_overrides(RCFG.get_config("qwen2.5-32b"), overrides)
    assert _fields(got) == _fields(ref)


def test_apply_overrides_rejects_unknown_field():
    with pytest.raises(KeyError, match="no config field"):
        CFG.apply_overrides(CFG.get_config("qwen2.5-32b"), {"nope": "1"})


class FakeMesh:
    """Shape-only stand-in (rules never touch devices)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


RESOLVE_CASES = [
    ({"data": 16, "model": 16}, ("batch", None), None),
    ({"data": 16, "model": 16}, ("fsdp", "mlp"), None),
    ({"data": 16, "model": 16}, ("experts", "fsdp", "mlp"), None),
    ({"pod": 2, "data": 16, "model": 16}, ("batch", None), None),
    ({}, ("batch", "mlp"), None),
    ({"data": 16, "model": 16}, ("experts", "fsdp", "mlp"), (8, 6144, 16384)),
    ({"data": 16, "model": 16}, ("experts", "fsdp", "mlp"), (256, 7168, 2048)),
    ({"pod": 2, "data": 16, "model": 16}, ("batch",), (2,)),
    ({"pod": 2, "data": 16, "model": 16}, ("batch",), (64,)),
    ({"pod": 2, "data": 16, "model": 16}, ("batch",), (1,)),
    ({"data": 4, "model": 16}, ("fsdp", "heads"), (5120, 5120)),
]


@pytest.mark.parametrize("axes,logical,shape", RESOLVE_CASES)
def test_resolve_matches_reference(axes, logical, shape):
    m = FakeMesh(**axes)
    assert SH.resolve(m, *logical, shape=shape) == tuple(RSH.resolve(m, *logical, shape=shape))


SANITIZE_CASES = [
    ({"data": 16, "model": 16}, ("model", None), (40, 8)),
    ({"data": 16, "model": 16}, ("model", None), (48, 8)),
    ({"data": 16, "model": 16}, (("pod", "data"), None), (32, 4)),
    ({"pod": 2, "data": 16, "model": 16}, (("pod", "data"), None), (2, 4)),
]


@pytest.mark.parametrize("axes,spec,shape", SANITIZE_CASES)
def test_sanitize_spec_matches_reference(axes, spec, shape):
    from jax.sharding import PartitionSpec as P

    m = FakeMesh(**axes)
    assert SH.sanitize_spec(m, spec, shape) == tuple(RSH.sanitize_spec(m, P(*spec), shape))


def test_fft_axis_and_rules():
    assert SH.fft_axis(FakeMesh(data=16, model=16)) == RSH.fft_axis(FakeMesh(data=16, model=16)) == "model"
    assert SH.fft_axis(FakeMesh(rows=4)) == RSH.fft_axis(FakeMesh(rows=4)) == "rows"
    assert SH.DEFAULT_RULES == RSH.DEFAULT_RULES


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", DENSE)
def test_init_specs_and_shapes_equal_reference(arch):
    cfg = CFG.get_config(arch, reduced=True)
    params, specs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rparams, rspecs = RModel(RCFG.get_config(arch, reduced=True)).init(jax.random.PRNGKey(0))
    assert _flat(specs) == _flat(rspecs)
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _flat(params).items()}
    ref = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(rparams).items()}
    assert got == ref
    for name, (shape, _) in got.items():  # every spec names one axis per dim
        assert len(_flat(specs)[name]) == len(shape), name
    # a full-size resolution routes TP to the flattened head dim
    mesh = FakeMesh(data=4, model=16)
    wq = _flat(specs)["/layers/attn/wq"]
    full = CFG.get_config(arch)
    shape = (full.num_layers, full.d_model, full.num_heads * full.head_dim_)
    assert SH.resolve(mesh, *wq, shape=shape) == tuple(RSH.resolve(mesh, *wq, shape=shape))
    assert np.isfinite(np.asarray(params["layers"]["attn"]["wq"])).all()
