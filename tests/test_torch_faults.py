"""The port's fault layer against the reference (``repro.runtime``):
fault-plan firing sequences, the circuit breaker, the monitor's
statistics, and ``plan_fft(faults=)`` -- the chaos executor on
``SimMesh(1)`` (beside the reference's plan on one host device, event
for event), ``SimMesh(4)`` and a 2x2 grid (against numpy): error, stall
and device loss, match selectivity, the ``global:`` label, recorder
spans, no half-open span in traced mode, and a measured plan whose race
is not poisoned. Clocks and sleeps are injected; nothing sleeps."""

import time

import numpy as np
import pytest
import torch

import repro.core.compat as ref_compat
import repro.core.plan as ref_plan
import repro.obs.trace as ref_trace
import repro.runtime.faults as ref_faults
import repro.runtime.monitor as ref_monitor
import repro_torch.core.schedule as sch
import repro_torch.runtime.faults as faults
import repro_torch.runtime.monitor as monitor
from repro_torch.core import SimMesh, plan_fft, planner
from repro_torch.obs import TraceRecorder
from repro_torch.runtime import DeviceLossFault, FaultPlan, InjectedFault
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-5, 1e-6


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _fresh_wisdom():
    planner.forget_wisdom()
    yield
    planner.forget_wisdom()


def _x(n=16, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _want(x):
    """Slab fft2 output layout (no transpose_back): transposed spectrum."""
    return np.swapaxes(np.fft.fft2(x), -1, -2)


# ---------------------------------------------------------------- FaultPlan
LABELS = (
    "Exchange(slab:model, scatter, p=4, fft, fused)",
    "global:fft2",
    "Exchange(row:rows, alltoall, p=2, fft)",
    "LocalFFT(axis=-1)",
    "Exchange(col:cols, bisection, p=2, fft)",
)

#: (specs as FaultSpec kwargs, FaultPlan kwargs)
PLAN_CASES = {
    "error once": ([dict(mode="error")], {}),
    "times caps": ([dict(mode="error", match="Exchange", times=2)], {}),
    "at every times": ([dict(mode="error", match="", at=1, every=2, times=2)], {}),
    "every match from at": ([dict(mode="error", match="Exchange", at=2, times=None)], {}),
    "every unlimited": ([dict(mode="stall", match="rows", every=3, times=None, stall_s=0.25)], {}),
    "rate": ([dict(mode="error", match="Exchange", rate=0.5, times=None)], {"seed": 7}),
    "rate 5%": ([dict(mode="error", match="", rate=0.05, times=None)], {"seed": 7}),
    "rate stall": ([dict(mode="stall", match="", rate=0.3, times=None, stall_s=0.1)], {"seed": 3}),
    "device loss": ([dict(mode="device_loss", match="global:", alive=4)], {}),
    "device loss unknown": ([dict(mode="device_loss", match="cols", times=3)], {}),
    "two specs": ([dict(mode="stall", match="scatter", times=None, stall_s=0.5),
                   dict(mode="error", match="Exchange", at=3, every=4, times=None)], {}),
}


def _fire(fp, n=40):
    """Feed ``n`` stage labels through the fault plan ``fp``: per call
    (index, exception type or None, message, survivors)."""
    seq = []
    for k in range(n):
        try:
            fp.on_stage(LABELS[k % len(LABELS)], index=k)
            seq.append((k, None, None, None))
        except RuntimeError as e:  # InjectedFault of either package
            seq.append((k, type(e).__name__, str(e), getattr(e, "alive", None)))
    return seq


def _drive(mod, specs, plan_kw):
    """A fault plan of ``mod`` from ``specs``, its firing sequence, events
    and counters."""
    slept = []
    fp = mod.FaultPlan(tuple(mod.FaultSpec(**s) for s in specs), sleep=slept.append, **plan_kw)
    seq = _fire(fp)
    return fp, dict(seq=seq, events=list(fp.events), injected=fp.injected, stalled=fp.stalled_s,
                    slept=slept, active=fp.active())


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_fault_plan_fires_on_the_reference_matches(case):
    specs, plan_kw = PLAN_CASES[case]
    fp, got = _drive(faults, specs, plan_kw)
    _, exp = _drive(ref_faults, specs, plan_kw)
    assert got == exp
    assert got["injected"] > 0, "the case never fires: it checks nothing"
    fp.reset()  # a reset plan replays the identical sequence
    assert _fire(fp) == exp["seq"]


@pytest.mark.parametrize("name", ["error", "stall", "device_loss", "rate"])
def test_fault_plan_constructors_match_reference(name):
    kw = {"error": dict(match="rows", times=2), "stall": dict(stall_s=0.5, match="Exchange", every=2),
          "device_loss": dict(alive=2, match="Exchange", at=1), "rate": dict(rate=0.4, seed=11)}[name]
    runs = []
    for mod in (faults, ref_faults):
        slept = []
        fp = getattr(mod.FaultPlan, name)(sleep=slept.append, **kw)
        runs.append((_fire(fp, 30), fp.events, slept, fp.injected, fp.seed))
    assert runs[0] == runs[1]


def test_bad_specs_rejected_like_reference():
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match="mode"):
            mod.FaultSpec("explode")
        with pytest.raises(ValueError, match="rate"):
            mod.FaultSpec("error", rate=1.5)
    assert issubclass(DeviceLossFault, InjectedFault) and issubclass(InjectedFault, RuntimeError)
    assert faults.RetryPolicy() == faults.RetryPolicy(max_retries=1, deadline_s=float("inf"))


# ------------------------------------------------------------ CircuitBreaker
BREAKER_OPS = (
    ("fail", "k"), ("fail", "k"), ("allow", "k"), ("ok", "k"), ("fail", "k"), ("fail", "k"), ("fail", "k"),
    ("allow", "k"), ("allow", "b"), ("tick", 4.9), ("allow", "k"), ("tick", 0.2), ("allow", "k"),
    ("allow", "k"), ("fail", "k"), ("allow", "k"), ("tick", 5.0), ("allow", "k"), ("ok", "k"), ("allow", "k"),
    ("fail", "b"), ("fail", "b"), ("fail", "b"), ("reset", None), ("allow", "b"),
)


@pytest.mark.parametrize("threshold", [1, 3])
def test_circuit_breaker_transitions_match_reference(threshold):
    trails = []
    for mod in (faults, ref_faults):
        clk = FakeClock()
        br = mod.CircuitBreaker(failure_threshold=threshold, reset_after_s=5.0, clock=clk)
        trail = []
        for op, arg in BREAKER_OPS:
            if op == "tick":
                clk.advance(arg)
            elif op == "reset":
                br.reset()
            elif op == "allow":
                trail.append(br.allow(arg))
            else:
                (br.record_failure if op == "fail" else br.record_success)(arg)
            trail.append((br.states(), br.stats()))
        trails.append(trail)
    assert trails[0] == trails[1]
    with pytest.raises(ValueError, match="failure_threshold"):
        faults.CircuitBreaker(failure_threshold=0)


# ------------------------------------------------------------------ monitor
SAMPLES = {
    "1..100": (list(range(1, 101)), (50, 90, 99)),
    "n=4": ([10.0, 20.0, 30.0, 40.0], (50, 99)),
    "single": ([7.0], (0, 50, 100)),
    "unsorted": ([3.0, 1.0, 2.0, 9.5, -1.0], (0, 25, 100)),
    "empty": ([], (50, 99)),
    "fractional": (list(range(1, 1001)), (99.9, 0.1, 50.5)),
    "same twice": ([1.0, 2.0], (50, 50.0)),
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_percentiles_match_reference(case):
    data, qs = SAMPLES[case]
    assert monitor.percentiles(data, qs) == ref_monitor.percentiles(data, qs)


@pytest.mark.parametrize("qs", [(101,), (-1,), (99.9, 99.9000001)])
def test_percentile_errors_match_reference(qs):
    msgs = []
    for mod in (monitor, ref_monitor):
        with pytest.raises(ValueError) as ei:
            mod.percentiles([1.0, 2.0], qs)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("maxlen", [4, 2048])
def test_latency_window_matches_reference(maxlen):
    summaries = []
    for mod in (monitor, ref_monitor):
        w = mod.LatencyWindow(maxlen=maxlen)
        out = [w.summary()]
        for v in [100.0, 100.0, 1.0, 2.0, 3.0, 4.0, 0.5]:
            w.record(v)
            out.append((len(w), w.summary(), w.percentiles((0, 50, 100))))
        summaries.append(out)
    assert summaries[0] == summaries[1]


STEP_CASES = {
    "warmup hides a spike": (dict(warmup=3, straggler_factor=2.0), [1.0, 50.0, 1.0], None),
    "flag keeps baseline": (dict(ema_alpha=0.5, warmup=3), [1.0, 1.0, 1.0, 10.0, 1.0], None),
    "warmup boundary": (dict(ema_alpha=0.0, warmup=2), [1.0, 10.0, 10.0], None),
    "culprits": (dict(ema_alpha=0.0, warmup=1), [1.0, 1.0, 9.0, 9.0, 1.0],
                 [[("input", 1.0)], [("input", 1.0)], [("input", 0.5), ("step_fn", 8.5)],
                  [{"name": "input", "dur": 8.0}, {"name": "step_fn", "dur": 1.0}], [{"dur": 1.0}, ("x",)]]),
    "bounded history": (dict(warmup=10**9, history_limit=4), [float(i + 1) for i in range(10)], None),
}


def _feed(mod, kw, seconds, spans, monkeypatch):
    """One StepMonitor of ``mod`` driven by an injected perf_counter."""
    t = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: t[0])
    mon = mod.StepMonitor(**kw)
    stats = []
    for i, dt in enumerate(seconds):
        mon.start()
        t[0] += dt
        sp = spans[i] if spans else None
        stats.append(mon.stop(tokens=10 * i, spans=sp))
    out = dict(
        stats=[(s.step, s.seconds, s.tokens, s.flagged, s.culprit) for s in stats],
        ema=mon.ema, report=mon.straggler_report(), p=mon.percentiles((0, 50, 100)),
        p_window=mon.percentiles((50,), window=2), tps=mon.tokens_per_sec, history=len(mon.history),
    )
    mon.reset()
    out["after_reset"] = (mon.straggler_report(), mon.ema, len(mon.history))
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_monitor_matches_reference(case, monkeypatch):
    kw, seconds, spans = STEP_CASES[case]
    got = _feed(monitor, kw, seconds, spans, monkeypatch)
    exp = _feed(ref_monitor, kw, seconds, spans, monkeypatch)
    assert got == exp


def test_step_monitor_reads_the_ports_trace_spans(monkeypatch):
    rec = TraceRecorder(clock=FakeClock())
    rec.add_span("Exchange(slab:model, scatter, p=4, fft, fused)", 0.0, 2.0, cat="exchange")
    rec.add_span("LocalFFT(axis=-1)", 2.0, 0.5)
    t = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: t[0])
    mon = monitor.StepMonitor(warmup=0)
    mon.start()
    t[0] = 3.0
    assert mon.stop(spans=rec.spans).culprit == "Exchange(slab:model, scatter, p=4, fft, fused)"


# ------------------------------------------------- plan_fft(faults=) at P = 1
def _ref_mesh1():
    return ref_compat.make_mesh((1,), ("model",))


def _both_p1(make_faults, backend="scatter", x=None):
    """Run the same fault plan through the reference's P = 1 plan and the
    port's SimMesh(1) plan, twice each (the second run after the plan may
    have exhausted); returns per package the outcomes and the events."""
    import jax.numpy as jnp

    x = _x() if x is None else x
    out = {}
    for name, mod, mk in (("ref", ref_faults, lambda fp: ref_plan.plan_fft((16, 16), _ref_mesh1(),
                                                                            backend=backend, faults=fp)),
                          ("port", faults, lambda fp: plan_fft((16, 16), SimMesh(1, device="cpu"),
                                                               backend=backend, faults=fp))):
        slept = []
        fp = make_faults(mod, slept)
        plan = mk(fp)
        runs = []
        for _ in range(2):
            try:
                y = plan.execute(jnp.asarray(x) if name == "ref" else torch.from_numpy(x))
                runs.append(("ok", np.asarray(y)))
            except mod.InjectedFault as e:
                runs.append((type(e).__name__, getattr(e, "alive", None), str(e)))
        out[name] = dict(runs=runs, events=fp.events, slept=slept, active=fp.active(), injected=fp.injected)
    return out


P1_CASES = {
    "error": lambda mod, slept: mod.FaultPlan.error(match="Exchange"),
    "stall": lambda mod, slept: mod.FaultPlan.stall(0.25, match="Exchange", sleep=slept.append),
    "device loss": lambda mod, slept: mod.FaultPlan.device_loss(4),
    "no match": lambda mod, slept: mod.FaultPlan.error(match="no-such-stage"),
    "twice": lambda mod, slept: mod.FaultPlan.error(match="scatter", times=2),
}


@pytest.mark.parametrize("case", sorted(P1_CASES))
def test_plan_faults_match_reference_at_p1(case):
    res = _both_p1(P1_CASES[case])
    ref, port = res["ref"], res["port"]
    for key in ("events", "slept", "active", "injected"):
        assert port[key] == ref[key], key
    for got, exp in zip(port["runs"], ref["runs"]):
        assert got[0] == exp[0]
        if got[0] == "ok":
            np.testing.assert_allclose(got[1], exp[1], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got[1], _want(_x()), rtol=RTOL, atol=ATOL)
        else:
            assert got[1:] == exp[1:]


def test_global_label_matches_reference_at_p1():
    res = _both_p1(lambda mod, slept: mod.FaultPlan.error(match="global:"), backend="xla_auto")
    assert res["port"]["events"] == res["ref"]["events"]
    assert [r[0] for r in res["port"]["runs"]] == [r[0] for r in res["ref"]["runs"]] == ["InjectedFault", "ok"]
    assert "global:fft2" in res["port"]["runs"][0][2]


# ------------------------------------------ plan_fft(faults=) on P > 1 meshes
def _mesh(kind):
    if kind == "grid":
        return SimMesh((2, 2), axis_names=("rows", "cols"), device="cpu")
    return SimMesh(int(kind), device="cpu")


def _kw(kind):
    return dict(decomp="pencil", backend=("scatter", "alltoall")) if kind == "grid" else dict(backend="scatter")


def _oracle(kind, x):
    return np.fft.fft2(x) if kind == "grid" else _want(x)  # pencil fft2: the natural layout


MESHES = ["1", "4", "grid"]


@pytest.mark.parametrize("kind", MESHES)
def test_error_fires_then_exhausts_and_computes(kind):
    x = _x(seed=3)
    fp = FaultPlan.error(match="Exchange")
    plan = plan_fft((16, 16), _mesh(kind), faults=fp, **_kw(kind))
    with pytest.raises(InjectedFault, match="Exchange"):
        plan.execute(torch.from_numpy(x))
    [ev] = fp.events
    assert ev["mode"] == "error" and "Exchange" in ev["stage"] and not fp.active()
    y = plan.execute(torch.from_numpy(x))  # exhausted: the plain executor
    np.testing.assert_allclose(y.numpy(), _oracle(kind, x), rtol=RTOL, atol=ATOL * 16)
    np.testing.assert_allclose(plan.inverse(y).numpy(), x, rtol=RTOL, atol=ATOL * 16)


@pytest.mark.parametrize("kind", MESHES)
def test_stall_sleeps_through_the_injected_sleep_and_computes(kind):
    slept = []
    fp = FaultPlan.stall(0.25, match="Exchange", times=None, sleep=slept.append)
    plan = plan_fft((16, 16), _mesh(kind), faults=fp, **_kw(kind))
    x = _x(seed=4)
    y = plan.execute(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), _oracle(kind, x), rtol=RTOL, atol=ATOL * 16)
    z = plan.inverse(y)  # the inverse consults the same plan
    np.testing.assert_allclose(z.numpy(), x, rtol=RTOL, atol=ATOL * 16)
    exchanges = {"1": 1, "4": 1, "grid": 4}[kind]  # the pencil fft2: an exchange and its transpose-back per axis
    assert slept == [0.25] * 2 * exchanges and fp.stalled_s == 0.5 * exchanges
    assert [e["index"] for e in fp.events[:exchanges]] == [
        i for i, st in enumerate(plan.schedule().stages) if isinstance(st, sch.Exchange)]


@pytest.mark.parametrize("kind", MESHES)
def test_device_loss_carries_the_survivor_count(kind):
    plan = plan_fft((16, 16), _mesh(kind), faults=FaultPlan.device_loss(2), **_kw(kind))
    with pytest.raises(DeviceLossFault) as ei:
        plan.execute(torch.from_numpy(_x()))
    assert ei.value.alive == 2 and isinstance(ei.value, InjectedFault)


def test_match_selects_one_exchange_of_a_pencil_plan():
    grid = _mesh("grid")
    fp = FaultPlan.error(match="col:cols", at=1)
    plan = plan_fft((16, 16), grid, faults=fp, **_kw("grid"))
    x = torch.from_numpy(_x(seed=5))
    with pytest.raises(InjectedFault, match=r"col:cols, alltoall"):
        plan.execute(x)
    [ev] = fp.events
    assert ev["match_count"] == 1  # the second cols exchange (the transpose back) fired
    quiet = FaultPlan.error(match="no-such-stage")
    plan.faults = quiet
    np.testing.assert_allclose(plan.execute(x).numpy(), np.fft.fft2(x.numpy()), rtol=RTOL, atol=ATOL * 16)
    assert quiet.events == [] and quiet.active()  # armed, never matched


@pytest.mark.parametrize("kind", ["2", "4"])
def test_global_backend_label(kind):
    fp = FaultPlan.error(match="global:")
    plan = plan_fft((16, 16), _mesh(kind), faults=fp, backend="xla_auto")
    with pytest.raises(InjectedFault, match="global:fft2"):
        plan.execute(torch.from_numpy(_x()))
    x = _x(seed=6)
    np.testing.assert_allclose(plan.execute(torch.from_numpy(x)).numpy(), _oracle(kind, x),
                               rtol=RTOL, atol=ATOL * 16)


def test_real_plans_consult_the_fault_plan():
    slept = []
    fp = FaultPlan.stall(0.5, match="Exchange", times=None, sleep=slept.append)
    plan = plan_fft((16, 16), _mesh("4"), real=True, backend="scatter", faults=fp)
    f = np.random.default_rng(8).standard_normal((16, 16)).astype(np.float32)
    y = plan.execute(torch.from_numpy(f))
    np.testing.assert_allclose(y.numpy()[: plan.hermitian_len], np.fft.rfft2(f).T, rtol=RTOL, atol=ATOL * 16)
    np.testing.assert_allclose(plan.inverse(y).numpy(), f, rtol=RTOL, atol=ATOL * 16)
    assert slept == [0.5, 0.5]
    assert [e["stage"] for e in fp.events] == ["Exchange(slab:model, scatter, p=4, fft, fused)",
                                               "Exchange(slab:model, scatter, p=4)"]


@pytest.mark.parametrize("kind", ["4", "grid"])
def test_recorder_stamps_fault_spans(kind):
    for mod, rec_mod in ((faults, None), (ref_faults, ref_trace)):
        rec = (rec_mod.TraceRecorder if rec_mod else TraceRecorder)()
        fp = mod.FaultPlan.error(match="Exchange", recorder=rec)
        with pytest.raises(mod.InjectedFault):
            fp.on_stage("Exchange(x)")
        [sp] = [s for s in rec.spans if s.cat == "fault"]
        assert sp.name == "fault:error" and sp.args["stage"] == "Exchange(x)"
    rec = TraceRecorder()
    plan = plan_fft((16, 16), _mesh(kind), faults=FaultPlan.error(match="Exchange", recorder=rec), **_kw(kind))
    with pytest.raises(InjectedFault):
        plan.execute(torch.from_numpy(_x()))
    assert [s.name for s in rec.spans] == ["fault:error"]


@pytest.mark.parametrize("kind", ["4", "grid"])
def test_traced_injection_leaves_no_half_open_span(kind):
    mesh = _mesh(kind)
    plan = plan_fft((16, 16), mesh, **_kw(kind))
    rec = TraceRecorder()
    with pytest.raises(InjectedFault):
        sch.run_schedule(torch.from_numpy(_x()), plan.schedule(), mesh, trace=rec,
                         faults=FaultPlan.error(match="Exchange"))
    # the raise happened outside any span: everything recorded is
    # complete, and the exchange that fired has no span
    assert rec.spans and all(s.dur >= 0.0 for s in rec.spans)
    assert not any(s.cat == "exchange" for s in rec.spans)
    # armed but never firing: the traced run computes and spans every segment
    rec = TraceRecorder()
    x = _x(seed=9)
    y = sch.run_schedule(torch.from_numpy(x), plan.schedule(), mesh, trace=rec,
                         faults=FaultPlan.error(match="no-such-stage"))
    np.testing.assert_allclose(y.numpy(), _oracle(kind, x), rtol=RTOL, atol=ATOL * 16)
    assert sum(s.cat == "exchange" for s in rec.spans) == sum(
        isinstance(st, sch.Exchange) for st in plan.schedule().stages)


@pytest.mark.parametrize("kind", ["4", "grid"])
def test_measured_plan_attaches_faults_after_its_race(kind):
    """The race runs every candidate unpoisoned; the winner then carries
    the fault plan."""
    x = torch.from_numpy(_x(seed=10))
    fp = FaultPlan.error(match="Exchange")
    kw = dict(decomp="pencil") if kind == "grid" else {}

    def timer(plan):
        plan.execute(x)  # would raise were the plan attached before the race
        return 1.0 + len(plan.backend) * 1e-3

    plan = plan_fft((16, 16), _mesh(kind), planner="measure", timer=timer, faults=fp, **kw)
    assert plan.race_failures == {} and fp.injected == 0 and plan.faults is fp
    with pytest.raises(InjectedFault):
        plan.execute(x)
    hit = plan_fft((16, 16), _mesh(kind), planner="measure", timer=timer, faults=FaultPlan.error(), **kw)
    assert hit.wisdom_hit and hit.faults is not None and hit.faults is not fp


def test_absent_or_exhausted_plan_runs_the_plain_executor(monkeypatch):
    calls = []
    monkeypatch.setattr(sch, "_consult_faults", lambda *a: calls.append(a))
    plan = plan_fft((16, 16), _mesh("4"), backend="scatter")
    x = _x(seed=11)
    for fp in (None, FaultPlan(), FaultPlan.error(times=0)):
        plan.faults = fp
        np.testing.assert_allclose(plan.execute(torch.from_numpy(x)).numpy(), _want(x), rtol=RTOL, atol=ATOL * 16)
    assert calls == []
    plan.faults = FaultPlan.error(match="no-such-stage")  # armed: the chaos executor consults it
    plan.execute(torch.from_numpy(x))
    assert [c[1] for c in calls] == ["Exchange(slab:model, scatter, p=4, fft, fused)"]
