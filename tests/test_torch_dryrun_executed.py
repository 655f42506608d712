"""The dry run's executed half (``repro_torch.launch.dryrun.executed``):
one rank's step traced on the ``meta`` device, held exactly against the
whole traced step and against the same step run on CPU tensors.

Each test walks every case in a loop (an assertion names the case): the
traces are long, and two tests a file keep xdist from scheduling this
file before the long reference files (``--dist loadfile`` hands out the
files with the most tests first). The dry run's other tests, against the
reference's compiled program, are in ``tests/test_torch_dryrun.py``.
"""

import dataclasses

from repro_torch.configs import ShapeConfig, TrainConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import build_groups
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

#: the families the extension is held on, each a reduced config made
#: deeper (a pattern the trace extends past its two layers)
FAMILIES = {
    "qwen2.5-32b": dict(num_layers=4),  # dense
    "deepseek-v3-671b": dict(num_layers=5),  # MLA, MTP, two dense then three MoE layers
    "mixtral-8x22b": dict(num_layers=4),  # a window everywhere
    "xlstm-1.3b": dict(num_layers=6),  # three mLSTM + sLSTM pairs
    "hymba-1.5b": dict(num_layers=5),  # meta tokens; global layers 0, 2, 4, local 1, 3
    "whisper-medium": dict(num_layers=4, encoder_layers=3),
}
#: the KV chunk and the SSM chunks the families are traced with, so that 24
#: positions make six trips of every loop (the reduced configs' own chunks
#: are longer than these short sequences)
SHORT_CHUNK = 4
#: three microbatches: the trace runs two and extends the third
TCFG = dataclasses.replace(dryrun.PRODUCTION_TCFG, microbatch=3)


def _family(arch, dtype=None):
    cfg = get_config(arch, reduced=True)
    over = dict(FAMILIES[arch], attn_kv_chunk=SHORT_CHUNK)
    if cfg.ssm is not None:
        over["ssm"] = dataclasses.replace(cfg.ssm, chunk=SHORT_CHUNK)
    if cfg.moe is not None and cfg.moe.first_k_dense:
        over["moe"] = dataclasses.replace(cfg.moe, first_k_dense=2)
    if dtype:
        over["dtype"] = dtype
    return dataclasses.replace(cfg, **over)


def _mesh(dims):
    return MeshShape(dims, ("data", "model"))


def test_the_extrapolation_is_the_whole_trace(monkeypatch):
    """``executed`` of each family on ``MeshShape((1, 1))`` and ``(2, 2)``,
    train (three microbatches), prefill and decode over 24 positions --
    traced at two layers of each pattern and one more, every loop over
    positions at 4 and 5 trips (the KV chunks, Mamba's and the mLSTM's
    chunks, the sLSTM's steps: six each), two microbatches -- equals the
    whole step traced, every layer, trip and microbatch: the FLOPs, the
    moved bytes, the peak (so the temporaries) and the bytes held from
    the start, exactly."""
    monkeypatch.setattr(dryrun, "CAP_FROM", 6)
    keys = ("flops", "hbm_bytes", "peak_bytes", "args_bytes")
    for arch in FAMILIES:
        cfg = _family(arch)
        for dims in ((1, 1), (2, 2)):
            for kind in ("train", "prefill", "decode"):
                shape, mesh = ShapeConfig(kind, 24, 12, kind), _mesh(dims)
                got = dryrun.executed(cfg, shape, mesh, TCFG)
                whole = dryrun.executed(cfg, shape, mesh, TCFG, whole=True)
                case = (arch, dims, kind)
                assert {k: got[k] for k in keys} == {k: whole[k] for k in keys}, case
                assert got["traces"] > 1 and whole["traces"] == 1, case
                assert 0 < whole["args_bytes"] <= whole["peak_bytes"], case


def test_a_meta_trace_is_a_real_cpu_run():
    """Each family's train step in float32 on one rank (the production
    step's four microbatches), traced on the ``meta`` device and run on
    real CPU tensors (weights drawn, inputs zeros) under the same
    ``StepTally``, executes the same FLOPs, moves the same bytes and
    holds the same bytes at every phase's peak, exactly: the meta trace
    is the program, not a model of it."""
    dryrun._warm_up()
    keys = ("flops", "moved", "peaks", "args", "live_end")
    for arch in FAMILIES:
        cfg, shape, mesh = _family(arch, "float32"), ShapeConfig("train", 16, 4, "train"), _mesh((1, 1))
        meta = dryrun._trace(cfg, shape, mesh, dryrun.PRODUCTION_TCFG, build_groups(cfg), whole=True)
        real = dryrun._trace(cfg, shape, mesh, dryrun.PRODUCTION_TCFG, build_groups(cfg), whole=True, device="cpu")
        assert {k: meta[k] for k in keys} == {k: real[k] for k in keys}, arch
        assert meta["flops"] > 0 and len(meta["peaks"]) == 9, arch  # four forwards and backwards, the update
