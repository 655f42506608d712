"""The port's trace recorder (``repro_torch.obs.trace``) against the
reference's (``repro.obs.trace``), and the trace-mode executor
(``run_schedule(..., trace=)``) on the CPU SimMesh: the same exports
from the same recording under an injected clock, and traced runs that
compute what the plain executor computes, one span per segment with
the reference's labels and exchange payloads."""

import json

import numpy as np
import pytest
import torch

import repro.core.schedule as ref_sch
import repro.obs.trace as ref_trace
import repro_torch.core.schedule as sch
import repro_torch.obs.trace as trace
from repro_torch.core import CommParams, SimMesh, plan_fft
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)


def _clock():
    t = [10.0]

    def clock():
        t[0] += 0.25
        return t[0]

    return clock


def _record(mod):
    """One recording: nested spans, an added span, counters, a mark, and
    a second recorder merged and adopted under pid rows."""
    rec = mod.TraceRecorder(clock=_clock(), pid=3)
    with rec.span("LocalFFT(axis=-1)", stage="LocalFFT", index=0):
        with rec.span("inner", cat="stage", tid=2) as sp:
            sp.args["note"] = "annotated"
    m = rec.mark()
    with rec.span("Exchange(slab:model, scatter, p=4, fft, fused)", cat="exchange", backend="scatter", p=4,
                  block_bytes=4096.0, wire_bytes=3072.0):
        rec.counter("in_flight", sends=3, recvs=2)
    rec.add_span("added", rec.now(), 0.5, cat="exchange", args={"backend": "alltoall", "p": 2})
    other = mod.TraceRecorder(clock=_clock())
    with other.span("other"):
        other.counter("queue", depth=1)
    rec.merge(other, name="worker")
    rec.adopt([{"name": "foreign", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 0, "tid": 0}])
    rec.set_process_name(3, "main")
    return rec, m


def test_exports_from_an_injected_clock_equal_the_reference(tmp_path):
    mine, m1 = _record(trace)
    theirs, m2 = _record(ref_trace)
    assert m1 == m2
    assert mine.to_chrome_trace() == theirs.to_chrome_trace()
    assert mine.to_jsonl() == theirs.to_jsonl()
    assert [s.name for s in mine.spans_since(m1)] == [s.name for s in theirs.spans_since(m2)]
    assert [s.name for s in mine.exchange_spans()] == ["Exchange(slab:model, scatter, p=4, fft, fused)", "added"]
    assert mine.total_seconds() == theirs.total_seconds()
    a, b = tmp_path / "mine.json", tmp_path / "theirs.json"
    mine.write_chrome_trace(str(a))
    theirs.write_chrome_trace(str(b))
    assert a.read_text() == b.read_text()
    mine.write_jsonl(str(a))
    back = trace.TraceRecorder.from_jsonl(str(a))
    assert back.to_jsonl() == mine.to_jsonl()
    merged = trace.merge_traces([mine, back], names=["one", "two"])
    ref_merged = ref_trace.merge_traces([theirs, ref_trace.TraceRecorder.from_jsonl(str(a))], names=["one", "two"])
    # each merge_traces recorder stamps its own epoch; the adopted events are what carry the data
    assert merged.to_chrome_trace() == ref_merged.to_chrome_trace()


def _c64(seed, shape):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64))


PLANS = [
    dict(shape=(2, 16, 32), backend="scatter"),
    dict(shape=(2, 16, 32), backend="alltoall", direction="inverse"),
    dict(shape=(8, 8, 8), ndim=3, backend="pairwise_xor", pipeline=8, transpose_back=True),
    dict(shape=(64,), ndim=1, backend="scatter"),
    dict(shape=(64,), ndim=1, backend="bisection"),
    dict(shape=(16, 20), real=True, backend="scatter"),
    dict(shape=(16, 20), real=True, backend="scatter", direction="inverse"),
    dict(shape=(16, 16), backend="xla_auto"),
    dict(shape=(16, 16), decomp="pencil", backend=("scatter", "alltoall")),
    dict(shape=(8, 8, 10), ndim=3, real=True, decomp="pencil", backend="scatter"),
]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_traced_run_computes_the_plain_result_with_one_span_per_segment(kw):
    kw = dict(kw)
    shape = kw.pop("shape")
    pencil = kw.get("decomp") == "pencil"
    mesh = SimMesh((2, 2), axis_names=("rows", "cols"), device="cpu") if pencil else SimMesh(4, device="cpu")
    plan = plan_fft(shape, mesh, local_impl="kernel", **kw)
    spec = plan.input_spec()
    x = _c64(1, spec.shape) if spec.dtype.is_complex else torch.from_numpy(
        np.random.default_rng(2).standard_normal(spec.shape).astype(np.float32))
    built = plan.schedule()
    rec = trace.TraceRecorder()
    y = sch.run_schedule(x, built, mesh, impl="kernel", trace=rec)
    assert torch.equal(y, plan.execute(x))
    names = [s.name for s in rec.spans]
    if built.global_backend is not None:
        assert names == [f"global:{built.kind}"]
        return
    # the reference's labels and exchange payloads, segment by segment
    r_item, c_item = sch._itemsizes(x)
    ref_built = ref_sch.build_schedule(
        **{f: getattr(built, f) for f in ("global_shape", "ndim", "inverse", "real", "decomp", "transpose_back")},
        **_builder_args(plan))
    assert ref_built.canonical() == built.canonical()
    expect = (["Conj(in)"] if built.conj else []) + [ref_sch._stage_label(seg[-1]) for _, seg in
                                                     ref_sch._segments(ref_built)]
    expect += (["Epilogue(conj/scale)"] if built.conj or built.scale is not None else []) + ["Gather(out)"]
    assert names == expect
    ex_spans = rec.exchange_spans()
    assert [s.args for s in ex_spans] == [
        {**ref_sch.exchange_span_args(seg[-1], r_item, c_item), **({"twiddle": True} if len(seg) > 1 else {}),
         "index": i + len(seg) - 1}
        for i, seg in ref_sch._segments(ref_built) if isinstance(seg[-1], ref_sch.Exchange)]
    assert all(s.pid == 0 and s.dur >= 0 for s in rec.spans)


def _builder_args(plan):
    """build_schedule's placement arguments of a plan's forward schedule."""
    if plan.decomp == "pencil":
        g = plan.grid
        return dict(row_axis=g.row_axis, col_axis=g.col_axis, p_rows=g.p_rows, p_cols=g.p_cols,
                    backend_row=plan.backend_row, backend_col=plan.backend_col, fused=plan.fused,
                    n_chunks=plan.n_chunks, pad=plan.pad)
    return dict(axis_name=plan.axis_name, p=plan.shards, backend=plan.backend, fused=plan.fused,
                n_chunks=plan.n_chunks, pad=plan.pad)


def test_refine_online_fits_the_spans_of_traced_runs():
    """The executor's exchange spans carry what the online fit reads:
    runs at several sizes give a finite pooled fit."""
    mesh = SimMesh(4, device="cpu")
    rec = trace.TraceRecorder()
    for n in (16, 64, 128):
        plan = plan_fft((n, n), mesh, backend="scatter", pipeline=False)
        for _ in range(2):
            sch.run_schedule(_c64(n, (n, n)), plan.schedule(), mesh, trace=rec)
    assert len(rec.exchange_spans()) == 6
    fits = CommParams().refine_online(rec)
    assert ("*", "*") in fits and all(f.alpha_s > 0 and f.beta_bytes_s > 0 for f in fits.values())
    spans = [json.loads(line) for line in rec.to_jsonl().splitlines()]
    again = CommParams().refine_online(spans)
    assert {k: (v.alpha_s, v.beta_bytes_s) for k, v in again.items()} == {
        k: (v.alpha_s, v.beta_bytes_s) for k, v in fits.items()}
