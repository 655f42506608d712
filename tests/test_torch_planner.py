"""The port's measured planner, calibration and plan provenance against
the reference (``repro.core.planner`` / ``comm_model`` / ``plan``).

Pure functions (wisdom keys and merges, variant ids, candidate fields,
the alpha/beta fits) are called in both packages on the same inputs.
The measured race runs one scenario text in both: here on the port's
``SimMesh(4, device="cpu")`` and 2x2 grid, and in one reference
subprocess on four host devices, with the same deterministic injected
timer. The fabric's own timings never enter: timers are injected and
trace clocks faked."""

import json
import math
import warnings

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from test_torch_schedule import CASES
import repro.core.comm_model as ref_cm
import repro.core.planner as ref_planner
import repro.core.schedule as ref_sch
import repro_torch.core.comm_model as cm
import repro_torch.core.schedule as sch
from repro_torch.core import FFTConfig, FFTPlan, SimMesh, make_plan, plan_fft, planner
from repro_torch.obs import TraceRecorder

REL = 1e-12  # the same numpy fit on the same numbers


@pytest.fixture(autouse=True)
def _fresh_stores():
    planner.forget_wisdom()
    planner.forget_calibration()
    yield
    planner.forget_wisdom()
    planner.forget_calibration()


def _cpu_mesh(p=4):
    return SimMesh(p, device="cpu")


def _cpu_grid():
    return SimMesh((2, 2), axis_names=("rows", "cols"), device="cpu")


# ---------------------------------------------------------------------------
# Pure functions, held to the reference's outputs
# ---------------------------------------------------------------------------


def test_wisdom_keys_and_their_parse_match_reference():
    cases = [
        ((16, 16), 2, "complex64", 4, ("scatter", "alltoall"), "cpu", ""),
        ((2, 8, 8, 10), 3, "float32", 8, ("scatter@u", "scatter", "bisection"), "NVIDIA H100 80GB HBM3",
         "mesh=model8,decomp=slab,ax=model,dir=forward,impl=kernel,fuse=0,tb=0,real=1,pad=1"),
        ((16, 32), 2, "complex64", 4, ("scatter+alltoall", "alltoall+alltoall"), "cpu (SimMesh)",
         "mesh=rows2xcols2,decomp=pencil,grid=2x2,axes=rows+cols,dir=inverse,impl=matmul,fuse=0,tb=0,pipe=4"),
    ]
    for args in cases:
        key = planner.wisdom_key(*args)
        assert key == ref_planner.wisdom_key(*args)
        assert planner.parse_wisdom_key(key) == ref_planner.parse_wisdom_key(key)
    for bad in ("v0|shape=1", "v1|shape=x|ndim=2", "v1|shape=4|ndim=2|dtype=c|P=1|dev=cpu|decomp=pencil"):
        assert planner.parse_wisdom_key(bad) == ref_planner.parse_wisdom_key(bad)


def test_variant_ids_round_trip_like_reference():
    for cand in ("scatter", "scatter@u", "scatter@f8", "scatter+alltoall@u", "a+b@f16", "x@f0"):
        assert planner.parse_variant(cand) == ref_planner.parse_variant(cand)
        base, pipe = planner.parse_variant(cand)
        assert planner.variant_id(base, pipe) == ref_planner.variant_id(base, pipe)
    for pipe in (None, False, 0, 3, 12):
        assert planner.variant_id("pairwise_xor", pipe) == ref_planner.variant_id("pairwise_xor", pipe)
    for bad in ("scatter@x", "scatter@f", "scatter@fu"):
        with pytest.raises(ValueError, match="unknown measured-candidate variant"):
            planner.parse_variant(bad)
        with pytest.raises(ValueError, match="unknown measured-candidate variant"):
            ref_planner.parse_variant(bad)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_candidate_fields_match_reference(p):
    assert planner.candidate_backends(p) == ref_planner.candidate_backends(p)
    names = planner.candidate_backends(p)
    assert planner.candidate_variants(names, decomp="slab", p=p) == ref_planner.candidate_variants(
        names, decomp="slab", p=p)
    for pr, pc in ((1, p), (p, 1), (2, p)):
        pairs = planner.candidate_pairs(pr, pc)
        assert pairs == ref_planner.candidate_pairs(pr, pc)
        kw = dict(decomp="pencil", p=pr * pc, p_rows=pr, p_cols=pc)
        assert planner.candidate_variants(pairs, **kw) == ref_planner.candidate_variants(pairs, **kw)


def _entries():
    return [
        {"backend": "a", "timings": {"a": 1.0, "b": 2.0}},
        {"backend": "b", "timings": {"b": 0.5, "c": 3.0}, "observed": {"a": {"n": 2, "s": 0.25}}},
        {"backend": "c", "timings": {"a": 4.0, "c": 1.5}, "observed": {"a": {"n": 1, "s": 0.1}, "c": {"n": 3, "s": 2}}},
        {"backend": "a", "timings": {}},
        {"backend": "a", "timings": {"a": "fast"}, "observed": {"a": {"n": 0, "s": 1.0}, "b": {"n": 1, "s": -1}}},
        "not a dict",
        {"backend": "a"},
    ]


def _outcome(fn, *args):
    try:
        return "returned", fn(*args)
    except Exception as e:  # noqa: BLE001 -- the reference's raise is part of its behaviour
        return "raised", type(e).__name__


def test_wisdom_merge_and_effective_timings_match_reference():
    entries = _entries()
    for e in entries:
        assert planner.effective_timings(e) == ref_planner.effective_timings(e)
    for old in entries:
        for new in entries:
            assert _outcome(planner.merge_wisdom_entry, old, new) == _outcome(
                ref_planner.merge_wisdom_entry, old, new)


def test_exchange_fit_terms_and_payload_classes_match_reference():
    for backend in ("scatter", "pairwise_xor", "bisection", "alltoall", "xla_auto", "unknown"):
        for p in (1, 2, 3, 4, 8):
            for n_chunks in (None, 2, 8, 13):
                for block in (1024.0, 3.0e6, 2.0**31):
                    got = cm.exchange_fit_terms(backend, p, block, n_chunks)
                    assert got == ref_cm.exchange_fit_terms(backend, p, block, n_chunks)
    for wire in (0, 100, 64 * 1024 - 1, 64 * 1024, 5e6, 8 * 1024 * 1024, 1e12):
        assert cm.payload_class(wire) == ref_cm.payload_class(wire)
    assert cm.PAYLOAD_CLASS_EDGES == ref_cm.PAYLOAD_CLASS_EDGES
    assert cm.CALIBRATE_SIZES == ref_cm.CALIBRATE_SIZES and cm._BETA_FIT_MAX == ref_cm._BETA_FIT_MAX


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def test_calibrate_fits_the_reference_sweep():
    rng = np.random.default_rng(3)
    noise = {m: float(x) for m, x in zip(cm.CALIBRATE_SIZES, rng.uniform(-2e-7, 2e-7, len(cm.CALIBRATE_SIZES)))}

    def timer(m):
        return 2 * 7.5e-6 + 2 * m / 1.4e11 + noise[m]

    mine, theirs = cm.CommParams.calibrate(timer=timer), ref_cm.CommParams.calibrate(timer=timer)
    assert _close(mine.alpha_s, theirs.alpha_s) and _close(mine.beta_bytes_s, theirs.beta_bytes_s)
    assert mine.alpha_s == pytest.approx(7.5e-6, rel=0.05) and mine.beta_bytes_s == pytest.approx(1.4e11, rel=0.01)
    sizes = (1 << 20, 16 << 20, 64 << 20)
    mine = cm.CommParams.calibrate(timer=lambda m: 1e-5 + m / 9e10, sizes=sizes)
    theirs = ref_cm.CommParams.calibrate(timer=lambda m: 1e-5 + m / 9e10, sizes=sizes)
    assert _close(mine.alpha_s, theirs.alpha_s) and _close(mine.beta_bytes_s, theirs.beta_bytes_s)
    with pytest.raises(ValueError, match=">= 2 message sizes"):
        cm.CommParams.calibrate(timer=timer, sizes=(4096,))
    with pytest.raises(ValueError, match="needs a mesh"):
        cm.CommParams.calibrate()


def test_calibrate_warns_and_keeps_the_default_beta_when_the_slope_is_flat():
    for mod in (cm, ref_cm):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            prm = mod.CommParams.calibrate(timer=lambda m: 3e-5 - m * 1e-15)
        assert any("bandwidth not identifiable" in str(w.message) for w in rec)
        assert prm.alpha_s == pytest.approx(1.5e-5, rel=1e-6)
    assert prm.beta_bytes_s == ref_cm.ICI_BW_PER_LINK * ref_cm.ICI_LINKS
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert cm.CommParams.calibrate(timer=lambda m: 3e-5).beta_bytes_s == cm.NVLINK_BW


def _spans():
    """JSONL-form exchange spans of a synthetic fabric (alpha 4 us, beta
    100 GB/s) with a little noise, plus spans the fit must skip."""
    rng = np.random.default_rng(5)
    out = []
    for backend in ("scatter", "alltoall", "bisection", "pairwise_xor"):
        for p in (2, 4, 8):
            for block in (2.0**12, 2.0**18, 2.0**24, 2.0**27):
                for n_chunks in (None, 4 * p):
                    msgs, fit = ref_cm.exchange_fit_terms(backend, p, block, n_chunks)
                    dur = 4e-6 * msgs + fit / 1e11 + float(rng.uniform(0, 1e-7))
                    out.append({"kind": "span", "cat": "exchange", "name": "x", "dur": dur,
                                "args": {"backend": backend, "p": p, "block_bytes": block, "n_chunks": n_chunks,
                                         "wire_bytes": block * (1 - 1 / p)}})
    out.append({"cat": "exchange", "dur": 0.0, "args": {"backend": "scatter", "p": 4, "block_bytes": 1.0}})
    out.append({"cat": "stage", "dur": 1.0, "args": {"backend": "scatter", "p": 4, "block_bytes": 1.0}})
    out.append({"cat": "exchange", "dur": 1.0, "args": {"backend": 3, "p": 4, "block_bytes": 1.0}})
    # one lonely point: its group keeps the instance's constants
    out.append({"cat": "exchange", "dur": 2e-3, "args": {"backend": "ring16", "p": 16, "block_bytes": 2.0**20}})
    return out


def test_refine_online_matches_reference_fits():
    spans = _spans()
    base_mine = cm.CommParams(alpha_s=2e-6, beta_bytes_s=3e11)
    base_ref = ref_cm.CommParams(alpha_s=2e-6, beta_bytes_s=3e11)
    mine, theirs = base_mine.refine_online(spans), base_ref.refine_online(spans)
    assert set(mine) == set(theirs) and ("*", "*") in mine
    for key in mine:
        assert _close(mine[key].alpha_s, theirs[key].alpha_s), key
        assert _close(mine[key].beta_bytes_s, theirs[key].beta_bytes_s), key
    assert mine[("alltoall", "large")].beta_bytes_s == pytest.approx(1e11, rel=1e-2)
    assert mine[("ring16", "medium")] is base_mine  # one point: kept
    # a recorder's exchange spans feed it the same way as their dicts
    rec = TraceRecorder()
    for s in spans:
        rec.add_span(s.get("name", "x"), 0.0, s["dur"], cat=s["cat"], args=s["args"])
    again = base_mine.refine_online(rec)
    assert {k: (v.alpha_s, v.beta_bytes_s) for k, v in again.items()} == {
        k: (v.alpha_s, v.beta_bytes_s) for k, v in mine.items()}


# ---------------------------------------------------------------------------
# Schedule rewrites and span payloads on the reference's golden schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(CASES))
def test_apply_variant_and_span_args_match_reference(key):
    mine, theirs = sch.build_schedule(**CASES[key]), ref_sch.build_schedule(**CASES[key])
    if mine.decomp == "pencil":
        cands = ("scatter+alltoall", "bisection+scatter@u", "alltoall+pairwise_xor@f8")
    else:
        cands = ("scatter", "scatter@u", "pairwise_xor@f8", "alltoall")
    for cand in cands:
        for pipeline in ("auto", False, 6):
            if "@" in cand and pipeline != "auto":
                continue
            a = sch.apply_variant(mine, cand, pipeline=pipeline)
            b = ref_sch.apply_variant(theirs, cand, pipeline=pipeline)
            assert a.canonical() == b.canonical(), (cand, pipeline)
    assert [len(s) for _, s in sch._segments(mine)] == [len(s) for _, s in ref_sch._segments(theirs)]
    for items in ((4, 8), (8, 16)):
        for st_m, st_r in zip(mine.exchanges(), theirs.exchanges()):
            assert sch.exchange_span_args(st_m, *items) == ref_sch.exchange_span_args(st_r, *items)


# ---------------------------------------------------------------------------
# The measured race: one scenario, both packages
# ---------------------------------------------------------------------------

SCENARIO = r"""
FAILING = {"bisection", "bisection+scatter"}


def timer(plan):
    if plan.backend in FAILING:
        raise RuntimeError(f"injected failure of {plan.backend}")
    return 1.0 + (sum(map(ord, plan.backend)) % 89) / 100.0


def summary(plan):
    return dict(backend=plan.backend, measured=plan.measured, failures=plan.race_failures, hit=plan.wisdom_hit,
                key=plan.wisdom_key, channel=plan.selection_channel, why=plan.why(), fused=plan.fused,
                n_chunks=plan.n_chunks, decomp=plan.decomp, schedule=plan.schedule().canonical())


RESULT = {}
planner.forget_wisdom()
for label, mesh, shape, kw in (
    ("slab", SLAB_MESH, (2, 16, 32), {}),
    ("pencil", GRID_MESH, (16, 16), dict(decomp="pencil")),
    ("real", SLAB_MESH, (16, 20), dict(real=True)),
    ("pinned", SLAB_MESH, (16, 16), dict(backend="scatter")),
    ("pinned variant", SLAB_MESH, (16, 16), dict(backend="pairwise_xor@u")),
    ("inverse", GRID_MESH, (8, 8, 8), dict(ndim=3, decomp="auto", direction="inverse")),
):
    first = plan_fft(shape, mesh, planner="measure", timer=timer, local_impl="matmul", **kw)
    second = plan_fft(shape, mesh, planner="measure", timer=timer, local_impl="matmul", **kw)
    runs = [summary(first), summary(second)]
    finite = sorted((v, k) for k, v in first.measured.items() if v != float("inf"))
    if len(finite) > 1:
        planner.record_observed(second, finite[0][0] / 2, backend=finite[1][1])
        runs.append(summary(plan_fft(shape, mesh, planner="measure", timer=timer, local_impl="matmul", **kw)))
    RESULT[label] = runs
planner.export_wisdom(WISDOM_PATH)
planner.forget_wisdom()
RESULT["imported"] = planner.import_wisdom(WISDOM_PATH)
RESULT["after import"] = summary(plan_fft((2, 16, 32), SLAB_MESH, planner="measure", timer=timer,
                                          local_impl="matmul"))
RESULT["report"] = planner.wisdom_report()
RESULT["parsed"] = sorted((k, planner.parse_wisdom_key(k)) for k, _ in planner.wisdom_items())
"""

REF_CODE = r"""
import json, os, tempfile
from repro.core import plan_fft, planner
from repro.core.compat import make_mesh, make_mesh_1d

SLAB_MESH = make_mesh_1d(4)
GRID_MESH = make_mesh((2, 2), ("rows", "cols"))
WISDOM_PATH = os.path.join(tempfile.mkdtemp(), "wisdom.json")
exec(__SCENARIO__)
print("RESULT " + json.dumps(RESULT))
"""


def _normalized(result):
    """The port's result in the reference's words: the device kind of a
    CPU SimMesh is 'cpu (SimMesh)' where the reference's is 'cpu', and
    the calibration constants in force are each package's defaults."""
    text = json.dumps(result).replace("cpu (SimMesh)", "cpu")
    out = json.loads(text)

    def strip(node):
        if isinstance(node, dict):
            node.pop("calibration", None)
            for v in node.values():
                strip(v)
        elif isinstance(node, list):
            for v in node:
                strip(v)

    strip(out)
    return out


@pytest.fixture(scope="module")
def reference_race():
    out = run_subprocess(REF_CODE.replace("__SCENARIO__", repr(SCENARIO)), devices=4)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _port_race(tmp_path):
    ns = dict(plan_fft=plan_fft, planner=planner, SLAB_MESH=_cpu_mesh(), GRID_MESH=_cpu_grid(),
              WISDOM_PATH=str(tmp_path / "wisdom.json"))
    exec(SCENARIO, ns)
    return ns["RESULT"]


def test_measured_race_equals_reference(reference_race, tmp_path):
    mine = _port_race(tmp_path)
    assert _normalized(json.loads(json.dumps(mine))) == _normalized(reference_race)


def test_measured_race_behaviour(tmp_path):
    """What the scenario shows, stated: the failing candidate is out of
    the argmin and reported, the second call hits wisdom, an observed
    overlay flips the winner, and wisdom survives a file round trip."""
    res = _port_race(tmp_path)
    first, second, third = res["slab"]
    assert first["channel"] == "measured-race" and not first["hit"]
    assert math.isinf(first["measured"]["bisection"]) and "injected failure" in first["failures"]["bisection"]
    assert "bisection" not in first["why"]["timings"] and first["why"]["failed"] == first["failures"]
    finite = {k: v for k, v in first["measured"].items() if math.isfinite(v)}
    assert first["backend"] == min(sorted(finite), key=finite.__getitem__) == first["why"]["argmin"]
    assert second["channel"] == "wisdom-hit" and second["backend"] == first["backend"]
    assert third["channel"] == "observed-overlay" and third["backend"] != first["backend"]
    assert "|dev=cpu (SimMesh)|" in first["key"]
    assert first["why"]["calibration"] == {"device_kind": "cpu (SimMesh)", "alpha_s": cm.ALPHA_S,
                                           "beta_bytes_s": cm.NVLINK_BW, "source": "default", "calibrated": False}
    assert res["imported"] == 6 and res["after import"]["channel"] == "observed-overlay"
    assert res["pinned"][0]["measured"].keys() == {"scatter", "scatter@u", "scatter@f8"}
    assert list(res["pinned variant"][0]["measured"]) == ["pairwise_xor@u"]
    assert res["pinned variant"][0]["fused"] is False
    assert res["pencil"][0]["decomp"] == "pencil" and len(res["pencil"][0]["measured"]) == 16 + 12


def test_measured_winner_executes_and_round_trips():
    mesh = _cpu_mesh()
    x = torch.from_numpy((np.random.default_rng(1).standard_normal((16, 32)) * (1 + 1j)).astype(np.complex64))
    plan = plan_fft((16, 32), mesh, planner="measure", local_impl="kernel",
                    timer=lambda p: 0.5 if p.backend == "scatter@f8" else 1.0)
    assert plan.backend == "scatter@f8" and plan.fused and plan.n_chunks == 8
    np.testing.assert_allclose(plan.execute(x).numpy(), np.fft.fft2(x.numpy()).T, rtol=1e-4, atol=1e-3)
    again = plan_fft((16, 32), mesh, backend=plan.backend, local_impl="kernel")  # the id round-trips
    assert again.schedule_hash() == plan.schedule_hash()
    assert planner.predict_candidate(plan, "scatter@f8") == plan.predict(n_chunks=8)["scatter"]


def test_plan_fft_argument_guards():
    mesh = _cpu_mesh()
    with pytest.raises(ValueError, match="require planner='measure'"):
        plan_fft((16, 16), mesh, timer=lambda p: 1.0)
    with pytest.raises(ValueError, match="require planner='measure'"):
        plan_fft((16, 16), mesh, use_wisdom=False)
    with pytest.raises(ValueError, match="both specify the pipeline"):
        plan_fft((16, 16), mesh, backend="scatter@u", pipeline=4)
    with pytest.raises(RuntimeError, match="every candidate failed"):
        plan_fft((16, 16), mesh, planner="measure", timer=lambda p: 1 / 0)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        plan_fft((16, 16), mesh, planner="measure", faults=object(), timer=lambda p: 1.0)


def test_calibration_store_prices_default_plans_under_its_device_kind():
    mesh = _cpu_mesh()
    fitted = planner.ensure_calibrated(mesh, timer=lambda m: 2e-5 + 2 * m / 2e11)
    assert planner.calibration_for("cpu (SimMesh)") == fitted
    assert planner.calibration_for("cpu") is None  # never a fabric fit
    assert planner.ensure_calibrated(mesh, timer=lambda m: 1 / 0) == fitted  # known: not re-measured
    plan = plan_fft((16, 16), mesh, backend="auto")
    assert plan.params == fitted and plan.selection_channel == "model-argmin"
    assert plan.why()["calibration"]["calibrated"] and plan.why()["calibration"]["source"] == "calibrate"
    text = planner.export_wisdom()
    planner.forget_calibration()
    assert planner.import_wisdom(text) == 0 and planner.calibration_for("cpu (SimMesh)") == fitted


def test_auto_calibrate_runs_the_real_pingpong_once(monkeypatch):
    mesh = _cpu_mesh(2)
    monkeypatch.setattr(planner, "_AUTO_CALIBRATE", True)
    seen = []
    real = cm._pingpong_timer

    def spy(*args, **kwargs):
        timer = real(*args, **kwargs)

        def wrapped(m):
            seen.append(m)
            return timer(m)
        return wrapped

    monkeypatch.setattr(cm, "_pingpong_timer", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a CPU sweep may not pin beta
        planner.plan_measured((8, 8), mesh, backend="alltoall", warmup=0, iters=1)
        planner.plan_measured((8, 16), mesh, backend="alltoall", warmup=0, iters=1)
    assert seen == list(cm.CALIBRATE_SIZES)
    assert planner.calibration_cell("cpu (SimMesh)")["source"] == "calibrate"


# ---------------------------------------------------------------------------
# Profile, predict_stages, lower and roofline
# ---------------------------------------------------------------------------


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


@pytest.mark.parametrize("kw", [
    dict(shape=(2, 16, 32), backend="scatter"),
    dict(shape=(8, 8, 8), ndim=3, backend="pairwise_xor", pipeline=8),
    dict(shape=(16, 16), decomp="pencil", backend=("scatter", "alltoall")),
    dict(shape=(16, 20), real=True, backend="scatter"),
])
def test_profile_rows_follow_the_schedule(kw):
    kw = dict(kw)
    shape = kw.pop("shape")
    mesh = _cpu_grid() if kw.get("decomp") == "pencil" else _cpu_mesh()
    plan = plan_fft(shape, mesh, local_impl="kernel", **kw)
    res = plan.profile(trace=TraceRecorder(clock=_fake_clock()), reps=3, warmup=0)
    segs = sch._segments(plan.schedule())
    # one row per segment, then assembling the global output (SimMesh)
    assert [r.index for r in res.rows[:-1]] == [s + len(seg) - 1 for s, seg in segs]
    assert res.rows[-1].stage == "Gather(out)" and len(res.rows) == len(segs) + 1
    assert all(r.observed_s == 1.0 for r in res.rows) and res.reps == 3
    preds = plan.predict_stages()
    assert [r.predicted_s for r in res.exchange_rows()] == [s for _, s, _ in preds]
    assert [r.wire_bytes for r in res.exchange_rows()] == [b for _, _, b in preds]
    assert sum(s for _, s, _ in preds) == pytest.approx(plan.predict()[plan.backend], rel=1e-12)
    assert sum(b for _, _, b in preds) == pytest.approx(plan.comm_bytes(), rel=1e-12)
    assert "total observed" in res.table() and len(res.trace.spans) == 3 * len(res.rows)


def test_profile_of_a_measured_plan_feeds_the_observed_channel():
    mesh = _cpu_mesh()
    plan = plan_fft((8, 16), mesh, planner="measure", timer=lambda p: 1.0 if p.backend == "alltoall" else 2.0)
    res = plan.profile(trace=TraceRecorder(clock=_fake_clock()), warmup=0, reps=1)
    entry = dict(planner.wisdom_items())[plan.wisdom_key]
    assert entry["observed"] == {"alltoall": {"n": 1, "s": res.observed_s}}
    assert entry["backend"] == "bisection"  # observed 3 s > every race time of 2 s
    assert plan_fft((8, 16), mesh, planner="measure", timer=None).selection_channel == "observed-overlay"


@pytest.mark.parametrize("kw", [
    dict(shape=(2, 16, 32)), dict(shape=(8, 8, 8), ndim=3), dict(shape=(64,), ndim=1, backend="scatter"),
    dict(shape=(16, 20), real=True), dict(shape=(8, 8, 10), ndim=3, real=True, direction="inverse"),
    dict(shape=(16, 16), decomp="pencil"), dict(shape=(8, 8, 10), ndim=3, real=True, decomp="pencil"),
    dict(shape=(16, 20), real=True, decomp="pencil", direction="inverse"),
    dict(shape=(8, 8, 8), ndim=3, decomp="pencil", transpose_back=True, direction="inverse"),
])
def test_roofline_walks_the_executed_blocks(kw):
    kw = dict(kw)
    shape = kw.pop("shape")
    mesh = _cpu_grid() if kw.get("decomp") == "pencil" else _cpu_mesh()
    plan = plan_fft(shape, mesh, local_impl="kernel", **kw)
    spec = plan.input_spec()
    built = plan.lower()
    assert built is plan.schedule()
    blocks = sch.stage_blocks(built, spec.shape)
    x = torch.zeros(spec.shape, dtype=spec.dtype)
    y = plan.execute(x)
    assert tuple(mesh.split(y, built.out_tail)[0].shape) == blocks[-1][2]
    roof = plan.roofline()
    assert roof.coll_bytes == plan.comm_bytes() and roof.chips == 4
    assert roof.flops > 0 and roof.hbm_bytes > 0 and roof.bottleneck in ("compute", "memory", "collective")
    assert set(roof.as_dict()) == {"flops", "hbm_bytes", "coll_bytes", "chips", "t_compute_s", "t_memory_s",
                                   "t_collective_s", "bottleneck"}


def test_roofline_counts_the_main_paths_operations():
    """16384^2 slab c2c over 4 ranks, kernel impl: two length-16384
    passes split (512, 32), three TF32 products per fp32 product, and
    the fused exchange's packs at the fp32 rate."""
    n, p = 16384, 4
    plan = plan_fft((n, n), _cpu_mesh(p), backend="scatter", local_impl="kernel")
    roof = plan.roofline()
    rows = n * n / p / n
    first = 3 * (8.0 * n * (512 + 32) + 6.0 * n) * rows  # LocalFFT
    after = 3 * (8.0 * (n // p) * (512 + 8) + 6.0 * (n // p)) * (n * n / p / (n // p))  # length-4096 pass
    pack = (6.0 + 8.0 * (p - 1)) * n * n / p
    assert roof.flops == pytest.approx(first + after + pack, rel=1e-12)
    assert roof.t_compute == pytest.approx((first + after) / cm.PEAK_FLOPS_TF32 + pack / cm.PEAK_FLOPS_FP32)
    assert roof.hbm_bytes == 4 * 8.0 * n * n / p  # two stages, one read and one write each
    assert plan_fft((n, n), _cpu_mesh(p), local_impl="torch").roofline().peak_flops == cm.PEAK_FLOPS_FP32


# ---------------------------------------------------------------------------
# The deprecated shims (tests/test_plan_shims.py's cases)
# ---------------------------------------------------------------------------


def test_make_plan_emits_exactly_one_deprecation_warning_at_caller():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shim = make_plan((8, 8), _cpu_mesh(1), strategy="alltoall")
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "plan_fft" in str(dep[0].message)
    assert dep[0].filename == __file__
    assert isinstance(shim, FFTPlan)


def test_make_plan_delegates_execution_and_layout():
    mesh = _cpu_mesh(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        shim = make_plan((8, 8), mesh, strategy="alltoall", ndim_transform=2, transpose_back=True)
    ref = plan_fft((8, 8), mesh, backend="alltoall", transpose_back=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))).astype(np.complex64))
    np.testing.assert_allclose(shim.execute(x).numpy(), ref.execute(x).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(shim.inverse(shim.execute(x)).numpy(), x.numpy(), rtol=1e-4, atol=1e-4)
    assert shim.comm_bytes() == ref.comm_bytes()
    assert shim.comm_bytes(torch.complex128) == ref.comm_bytes(torch.complex128)
    assert shim.input_spec() == ref.input_spec()
    assert shim.lower().canonical() == ref.lower().canonical()  # the dry-run path stays wired


def test_fftconfig_carrier_fields_flow_through():
    shim = FFTPlan(global_shape=(4, 8), mesh=_cpu_mesh(1), axis_name="model",
                   cfg=FFTConfig(strategy="bisection", transpose_back=False))
    assert shim._plan.backend == "bisection" and shim._plan.transpose_back is False and shim._plan.ndim == 2
    shim3 = FFTPlan(global_shape=(4, 4, 4), mesh=_cpu_mesh(1), axis_name="model",
                    cfg=FFTConfig(strategy="scatter"), ndim_transform=3)
    assert shim3._plan.ndim == 3 and shim3._plan.backend == "scatter"


def test_make_plan_warns_every_call_not_once():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        make_plan((8, 8), _cpu_mesh(1))
        make_plan((8, 8), _cpu_mesh(1))
    assert len([w for w in rec if issubclass(w.category, DeprecationWarning)]) == 2
