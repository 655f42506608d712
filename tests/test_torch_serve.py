"""The port's spectral serving engine (``repro_torch.serve``) against the
reference's (``repro.serve``) and numpy.

- The queues and ``plan_key`` give the reference's answers and text.
- One request stream and fault plan through the reference's engine on
  one host device and the port's on ``SimMesh(1, device="cpu")`` give
  the same outputs and the same fault counters: batch poisoning, retry,
  the retry deadline, the breaker's degradation to ``xla_auto`` and its
  re-probe, and a seeded chaos rate.
- At P = 4 (and on a 2x2 grid) the port is held against numpy: the
  reference's batched ``xla_auto`` fails to compile there (ROADMAP §C).

Clocks are injected (``FakeClock``, ``AutoClock``); nothing sleeps."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.runtime.faults as ref_faults
import repro.serve.queue as ref_queue
import repro.serve.spectral as ref_spectral
from repro.core.compat import make_mesh
from repro.core import planner as ref_planner
import repro_torch.runtime.faults as faults
import repro_torch.serve.queue as queue
import repro_torch.serve.spectral as spectral
from repro_torch.core import SimMesh, plan_fft, planner
from repro_torch.runtime import CircuitBreaker, FaultPlan, InjectedFault, RetryPolicy, elastic_mesh
from repro_torch.serve import Admission, PlanPool, SpectralEngine, plan_key
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

RTOL, ATOL = 1e-5, 1e-6


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class AutoClock:
    """Advances on every read: wall-clock budgets elapse without sleeping."""

    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(autouse=True)
def _fresh_wisdom():
    planner.forget_wisdom()
    ref_planner.forget_wisdom()
    yield
    planner.forget_wisdom()
    ref_planner.forget_wisdom()


def _c64(seed, shape=(16, 16)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _f32(seed, shape=(16, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _want(x):
    return np.swapaxes(np.fft.fft2(x), -1, -2)


def _cpu(p=1):
    return SimMesh(p, device="cpu")


# ---------------------------------------------------------------- queues
QUEUE_SCRIPTS = {
    "full batch": (dict(max_batch=2, max_wait_s=10.0), True,
                   [("push", "k", "a"), ("ready",), ("push", "k", "b"), ("ready",), ("depth",)]),
    "max wait": (dict(max_batch=4, max_wait_s=1.0), True,
                 [("push", "k", "a"), ("tick", 0.5), ("ready",), ("deadline",), ("tick", 0.5), ("ready",)]),
    "keys apart": (dict(max_batch=2, max_wait_s=0.0), True,
                   [("push", "k1", "a"), ("push", "k2", "b"), ("ready",)]),
    "coalesce off": (dict(max_batch=8, max_wait_s=10.0), False,
                     [("push", "k", "a"), ("push", "k", "b"), ("push", "k", "c"), ("ready",)]),
    "flush": (dict(max_batch=2, max_wait_s=10.0), True,
              [("push", "k", v) for v in "abcde"] + [("push", "j", "z"), ("depth",), ("flush",), ("depth",)]),
}


def _run_queue(mod, adm_kw, coalesce, script):
    clk = FakeClock()
    q = mod.CoalescingQueue(mod.Admission(**adm_kw), coalesce=coalesce, clock=clk)
    out = []
    for op, *args in script:
        if op == "push":
            q.push(*args)
        elif op == "tick":
            clk.advance(args[0])
        elif op == "ready":
            out.append(q.ready())
        elif op == "flush":
            out.append(q.flush())
        elif op == "deadline":
            out.append(q.next_deadline())
        else:
            out.append((q.depth(), len(q), q.pushed))
    return out


@pytest.mark.parametrize("case", sorted(QUEUE_SCRIPTS))
def test_coalescing_queue_matches_reference(case):
    adm_kw, coalesce, script = QUEUE_SCRIPTS[case]
    assert _run_queue(queue, adm_kw, coalesce, script) == _run_queue(ref_queue, adm_kw, coalesce, script)


def test_pending_queue_and_admission_match_reference():
    for mod in (queue, ref_queue):
        q = mod.PendingQueue([1, 2])
        q.push(3)
        q.extend([4])
        assert len(q) == 4 and q.peek() == 1 and [q.pop() for _ in range(4)] == [1, 2, 3, 4] and not q
        with pytest.raises(IndexError):
            q.pop()
        for bad in (dict(max_batch=0), dict(max_wait_s=-1.0)):
            with pytest.raises(ValueError):
                mod.Admission(**bad)
    assert queue.Admission() == Admission(max_batch=8, max_wait_s=0.002)


@pytest.mark.parametrize("shape,ndim,dtype,p,decomp,real", [
    ((1, 16, 16), 2, "complex64", 1, "slab", False),
    ((8, 4096, 4096), 2, "complex64", 4, "slab", False),
    ((4, 4096, 4096), 2, "float32", 4, "slab", True),
    ((2, 8, 16, 8), 3, "complex128", 4, "pencil", False),
    ((16, 16), 2, "float64", 2, "pencil", True),
])
def test_plan_key_text_equals_the_references(shape, ndim, dtype, p, decomp, real):
    exp = ref_spectral.plan_key(shape, ndim, jnp.dtype(dtype), p, decomp, real)
    for d in (getattr(torch, dtype), np.dtype(dtype), dtype):
        assert plan_key(shape, ndim, d, p, decomp, real) == exp


# ------------------------------------------------------------- plan pool
def test_pool_lru_hits_misses_and_keys():
    pool = PlanPool(_cpu(), capacity=2)
    k16 = pool.key((1, 16, 16), 2, torch.complex64, False)
    pool.get((1, 16, 16), 2, torch.complex64, False)
    pool.get((1, 8, 8), 2, torch.complex64, False)
    _, hit = pool.get((1, 16, 16), 2, torch.complex64, False)  # refresh 16 -> MRU
    assert hit and pool.hits == 1
    pool.get((1, 4, 4), 2, torch.complex64, False)  # evicts the 8x8 plan
    assert pool.evictions == 1 and len(pool) == 2 and k16 in pool
    assert pool.key((1, 8, 8), 2, torch.complex64, False) not in pool
    misses = pool.misses
    pool.get((1, 8, 8), 2, torch.complex64, False)
    assert pool.misses == misses + 1 and pool.plan_seconds > 0
    assert pool.stats()["plans"] == 2 and pool.stats()["distinct_schedules"] == len(set(pool.schedule_hashes().values()))
    with pytest.raises(ValueError):
        PlanPool(_cpu(), capacity=0)
    grid = SimMesh((2, 2), axis_names=("rows", "cols"), device="cpu")
    assert PlanPool(grid, plan_kwargs={"decomp": "pencil"}).shards() == 4
    assert PlanPool(grid).shards() == 2  # slab over the last axis


# ---------------------------------------------------- engine: admission
def test_full_batch_dispatches_inline_and_max_wait_flushes_via_poll():
    eng = SpectralEngine(_cpu(), max_batch=2, max_wait_s=100.0, clock=FakeClock())
    x = np.ones((8, 8), np.complex64)
    f1 = eng.submit("fft", x)
    assert not f1.done()
    f2 = eng.submit("fft", x)
    assert f1.done() and f2.done() and f1.batch_size == 2 and eng.batches == 1
    clk = FakeClock()
    eng = SpectralEngine(_cpu(), max_batch=8, max_wait_s=1.0, clock=clk)
    fut = eng.submit("fft", x)
    assert eng.poll() == 0
    clk.advance(1.5)
    assert eng.poll() == 1 and fut.done() and fut.batch_size == 1


def test_result_forces_dispatch_without_sleeping_and_buckets_pad():
    clk = FakeClock()
    eng = SpectralEngine(_cpu(), max_batch=8, max_wait_s=50.0, clock=clk)
    fut = eng.submit("fft", np.ones((8, 8), np.complex64))
    assert fut.result().shape == (8, 8) and clk.t < 100.0
    x = _c64(0, (8, 8))
    futs = [eng.submit("fft", x) for _ in range(3)]
    eng.flush()
    assert all(f.batch_size == 3 for f in futs) and eng.padded == 1  # 3 -> bucket 4
    assert eng.pool.key((4, 8, 8), 2, torch.complex64, False) in eng.pool
    np.testing.assert_allclose(futs[2].block().numpy(), _want(x), rtol=RTOL, atol=ATOL * 8)


def test_coalesce_off_distinct_shapes_and_drain():
    eng = SpectralEngine(_cpu(), max_batch=8, max_wait_s=0.0, coalesce=False, clock=FakeClock())
    for _ in range(4):
        eng.submit("fft", np.ones((8, 8), np.complex64))
    eng.flush()
    s = eng.stats()
    assert s["batches"] == 4 and s["mean_batch"] == 1.0 and s["padded"] == 0
    eng = SpectralEngine(_cpu(), max_batch=8, max_wait_s=100.0, clock=FakeClock())
    eng.submit("fft", np.ones((8, 8), np.complex64))
    eng.submit("fft", np.ones((16, 16), np.complex64))
    futs = [eng.submit("fft", np.ones((8, 8), np.complex64)) for _ in range(2)]
    eng.drain()
    assert eng.batches == 2 and all(f.done() for f in futs)
    assert eng.stats()["completed"] == 4 and not eng._outstanding
    eng.reset_stats()
    assert eng.stats()["requests"] == 0 and eng.stats()["pool"]["plans"] == 2  # the pool survives


def test_submit_validation_matches_reference():
    eng = SpectralEngine(_cpu(), clock=FakeClock())
    ref = ref_spectral.SpectralEngine(make_mesh((1,), ("model",)), clock=FakeClock())
    cases = [
        (("dct", np.ones((8, 8), np.complex64)), {}),
        (("rfft", np.ones((8, 8), np.complex64)), {}),
        (("ifft", np.ones((8, 8), np.float32)), {}),
        (("convolve", np.ones((8, 8), np.float32)), {}),
        (("convolve", np.ones((8, 8), np.float32), np.ones((4, 4), np.float32)), {}),
        (("fft", np.ones((8, 8), np.complex64), np.ones((8, 8), np.complex64)), {}),
        (("fft", np.ones((8,), np.complex64)), {"ndim": 1}),
        (("fft", np.ones((8,), np.complex64)), {"ndim": 2}),
    ]
    for args, kw in cases:
        msgs = []
        for e in (eng, ref):
            with pytest.raises(ValueError) as ei:
                e.submit(*args, **kw)
            msgs.append(str(ei.value).replace("(8, 8)", "").replace("(4, 4)", ""))
        assert msgs[0] == msgs[1], args


# ------------------------------------- engine against the reference, P = 1
def _scenario(name, pkg):
    """One request stream and fault plan through ``pkg``'s engine on one
    rank; returns each future's outcome and the fault counters."""
    if pkg == "ref":
        Engine, fmod, mesh = ref_spectral.SpectralEngine, ref_faults, make_mesh((1,), ("model",))
        to_np = np.asarray
    else:
        Engine, fmod, mesh, to_np = SpectralEngine, faults, _cpu(), lambda t: t.numpy()
    kw = dict(plan_kwargs=dict(backend="scatter"))
    xs = [_c64(i) for i in range(4)]
    futs = []
    if name == "poison":
        eng = Engine(mesh, max_batch=4, max_wait_s=100.0, retry=fmod.RetryPolicy(max_retries=0), **kw)
        eng.set_faults(fmod.FaultPlan.error(match="Exchange", times=2))
        futs = [eng.submit("fft", x) for x in xs]
        eng.drain()
    elif name == "retry heals":
        eng = Engine(mesh, max_batch=1, retry=fmod.RetryPolicy(max_retries=1), **kw)
        futs.append(eng.submit("fft", xs[0]))
        futs[-1].block()
        eng.set_faults(fmod.FaultPlan.error(match="Exchange", times=1))
        futs.append(eng.submit("fft", xs[1]))
        eng.drain()
    elif name == "deadline":
        eng = Engine(mesh, max_batch=1, clock=AutoClock(1.0),
                     retry=fmod.RetryPolicy(max_retries=10, deadline_s=0.5), **kw)
        futs.append(eng.submit("fft", xs[0]))
        futs[-1].block()
        eng.set_faults(fmod.FaultPlan.error(match="Exchange", times=5))
        futs.append(eng.submit("fft", xs[1]))
        eng.drain()
    elif name == "breaker":
        clk = FakeClock()
        eng = Engine(mesh, max_batch=1, clock=clk, retry=fmod.RetryPolicy(max_retries=0),
                     breaker=fmod.CircuitBreaker(failure_threshold=2, reset_after_s=5.0, clock=clk), **kw)
        futs.append(eng.submit("fft", xs[0]))
        futs[-1].block()
        eng.set_faults(fmod.FaultPlan.error(match="Exchange", times=2))
        for x in xs[1:]:  # two failures open the key, the third is degraded
            futs.append(eng.submit("fft", x))
            eng.drain()
        clk.advance(6.0)  # cool-down over, faults exhausted: the probe re-closes
        futs.append(eng.submit("fft", xs[0]))
        eng.drain()
    else:  # "chaos rate": mixed ops and shapes under a seeded 30 % rate
        eng = Engine(mesh, max_batch=4, max_wait_s=100.0, retry=fmod.RetryPolicy(max_retries=1), **kw)
        eng.set_faults(fmod.FaultPlan.rate(0.3, seed=7))
        for i in range(10):
            if i % 3 == 2:
                futs.append(eng.submit("poisson", _f32(i), lengths=(1.0, 2.0)))
            else:
                futs.append(eng.submit("fft", _c64(i, (16, 16) if i % 2 else (8, 8))))
        eng.drain()
    outcomes = []
    for f in futs:
        if f.failed():
            outcomes.append(("failed", type(f.error).__name__, str(f.error)))
        else:
            outcomes.append(("ok", to_np(f.result()), f.batch_size, f.degraded, f.backend))
    m = eng.metrics()
    counters = {k: m[k] for k in ("requests", "completed", "batches", "padded", "errors", "retries", "batch_splits",
                                  "quarantined", "failed_requests", "degraded_dispatches", "pool_hits", "pool_misses")}
    counters.update({k: v for k, v in m.items() if k.startswith("breaker_")})
    return outcomes, counters


@pytest.mark.parametrize("name", ["poison", "retry heals", "deadline", "breaker", "chaos rate"])
def test_engine_matches_the_reference_engine_on_one_rank(name):
    got, got_counters = _scenario(name, "port")
    exp, exp_counters = _scenario(name, "ref")
    assert got_counters == exp_counters
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g[0] == e[0]
        if g[0] == "failed":
            assert g[1:] == e[1:]
        else:
            np.testing.assert_allclose(g[1], e[1], rtol=RTOL, atol=ATOL * 16)
            assert g[2:] == e[2:]
    assert got_counters["errors"] > 0 or name == "retry heals" and got_counters["retries"] == 1


# ------------------------------------------------------ engine at P = 4
def test_coalesced_requests_at_p4_match_numpy():
    mesh = _cpu(4)
    eng = SpectralEngine(mesh, max_batch=8, max_wait_s=100.0, clock=FakeClock(),
                         plan_kwargs=dict(backend="scatter", local_impl="kernel"))
    xs = [_c64(i) for i in range(5)]
    futs = [eng.submit("fft", x) for x in xs]
    eng.flush()
    assert all(f.batch_size == 5 for f in futs) and eng.padded == 3
    for f, x in zip(futs, xs):
        np.testing.assert_allclose(f.block().numpy(), _want(x), rtol=RTOL, atol=ATOL * 16)
    inv = [eng.submit("ifft", f.result()) for f in futs]
    eng.flush()
    for f, x in zip(inv, xs):
        np.testing.assert_allclose(f.block().numpy(), x, rtol=RTOL, atol=ATOL * 16)
    rs = [_f32(10 + i) for i in range(3)]
    rf = [eng.submit("rfft", r) for r in rs]
    eng.flush()
    for f, r in zip(rf, rs):
        y = f.block().numpy()
        np.testing.assert_allclose(y[:9], np.fft.rfft2(r).T, rtol=RTOL, atol=ATOL * 16)
        assert not y[9:].any()  # the Hermitian axis padded to a multiple of P
    n = 16
    g = np.arange(n) * 2 * np.pi / n
    u = (np.sin(g)[:, None] * np.cos(2 * g)[None, :]).astype(np.float32)
    pf = [eng.submit("poisson", (-5.0 * u).astype(np.float32)) for _ in range(2)]
    lf = eng.submit("laplacian", u)
    gf = eng.submit("gradient", u)
    a, b = _f32(20), _f32(21)
    cf = eng.submit("convolve", a, b)
    eng.drain()
    assert pf[0].batch_size == 2 and lf.batch_size == 1
    np.testing.assert_allclose(pf[1].block().numpy(), u, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lf.block().numpy(), -5.0 * u, rtol=1e-4, atol=1e-4)
    du = gf.block()
    np.testing.assert_allclose(du[0].numpy(), (np.cos(g)[:, None] * np.cos(2 * g)[None, :]), atol=1e-5)
    conv = np.real(np.fft.ifft2(np.fft.fft2(a) * np.fft.fft2(b)))
    np.testing.assert_allclose(cf.block().numpy(), conv, rtol=1e-4, atol=1e-4)


def test_pencil_grid_requests_match_numpy():
    grid = SimMesh((2, 2), axis_names=("rows", "cols"), device="cpu")
    eng = SpectralEngine(grid, max_batch=4, max_wait_s=100.0, clock=FakeClock(),
                         plan_kwargs=dict(decomp="pencil", local_impl="kernel"))
    ys = [_c64(30 + i, (4, 8, 8)) for i in range(3)]
    futs = [eng.submit("fft", y, ndim=3) for y in ys]
    eng.flush()
    for f, y in zip(futs, ys):  # pencil fft3 without transpose_back: axes reversed
        np.testing.assert_allclose(f.block().numpy(), np.fft.fftn(y).transpose(2, 1, 0), rtol=RTOL, atol=ATOL * 64)


def test_poison_and_breaker_at_p4_against_numpy():
    mesh = _cpu(4)
    kw = dict(plan_kwargs=dict(backend="scatter", local_impl="kernel"))
    xs = [_c64(40 + i) for i in range(4)]
    eng = SpectralEngine(mesh, max_batch=4, max_wait_s=100.0, retry=RetryPolicy(max_retries=0), **kw)
    eng.set_faults(FaultPlan.error(match="Exchange", times=2))
    futs = [eng.submit("fft", x) for x in xs]
    eng.drain()
    assert [f.failed() for f in futs] == [True, False, False, False]
    for f, x in zip(futs[1:], xs[1:]):
        np.testing.assert_allclose(f.result().numpy(), _want(x), rtol=RTOL, atol=ATOL * 16)
    with pytest.raises(InjectedFault, match="p=4"):
        futs[0].block()
    m = eng.metrics()
    assert (m["errors"], m["batch_splits"], m["quarantined"], m["failed_requests"]) == (2, 1, 1, 1)

    clk = FakeClock()
    eng = SpectralEngine(mesh, max_batch=2, max_wait_s=100.0, clock=clk, retry=RetryPolicy(max_retries=0),
                         breaker=CircuitBreaker(failure_threshold=1, reset_after_s=5.0, clock=clk), **kw)
    eng.set_faults(FaultPlan.error(match="Exchange", times=1))
    first = [eng.submit("fft", x) for x in xs[:2]]  # the batch fails and opens its key; the solos resolve
    eng.drain()
    assert not any(f.failed() for f in first) and eng.breaker.stats()["opened"] == 1 and eng.batch_splits == 1
    deg = [eng.submit("fft", x) for x in xs[2:]]
    eng.drain()
    for f, x in zip(deg, xs[2:]):  # the batched xla_auto plan, held against numpy
        assert f.degraded and f.backend == "xla_auto" and f.batch_size == 2
        np.testing.assert_allclose(f.result().numpy(), _want(x), rtol=RTOL, atol=ATOL * 16)
    clk.advance(6.0)
    probe = [eng.submit("fft", x) for x in xs[:2]]
    eng.drain()
    assert probe[0].degraded is False and eng.breaker.stats()["reclosed"] == 1
    assert eng.stats()["faults"]["degraded_dispatches"] == 1


def test_a_non_injected_failure_propagates_and_is_never_served_degraded(monkeypatch):
    eng = SpectralEngine(_cpu(4), max_batch=1, clock=FakeClock(), plan_kwargs=dict(backend="scatter"),
                         breaker=CircuitBreaker(failure_threshold=1, clock=FakeClock()))
    boom = RuntimeError("kernel launch failed")

    def fail(plan, ops, lengths):
        raise boom

    monkeypatch.setitem(spectral._OPS, "fft", (fail, 1))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.submit("fft", _c64(0))
    assert eng.errors == 0 and eng.breaker.stats()["opened"] == 0 and eng.degraded_dispatches == 0


# --------------------------------------------------- warm start, remesh
def test_warm_start_from_wisdom_and_remesh(tmp_path):
    mesh = _cpu(2)
    plan_fft((2, 16, 16), mesh, planner="measure", timer=lambda p: 1.0 + len(p.backend) * 1e-3)
    path = str(tmp_path / "wisdom.json")
    planner.export_wisdom(path)
    planner.forget_wisdom()
    eng = SpectralEngine(mesh, max_batch=4, max_wait_s=0.0, wisdom=path, clock=FakeClock())
    assert len(eng.pool) == 3  # the (2, n, n) entry warmed the bucket ladder 1|2|4
    for b in (1, 2, 4):
        assert eng.pool.key((b, 16, 16), 2, torch.complex64, False) in eng.pool
    fut = eng.submit("fft", _c64(1))
    eng.flush()
    assert fut.pool_hit and eng.pool.misses == 0

    small = elastic_mesh(("model",), max_devices=1, device="cpu")
    assert isinstance(small, SimMesh) and small.p == 1
    plan_fft((1, 16, 16), small, planner="measure", timer=lambda p: 1.0 + len(p.backend) * 1e-3)
    assert eng.remesh(small) >= 1 and eng.pool.mesh is small and eng.breaker.stats()["open"] == 0
    misses = eng.pool.misses
    rf = eng.submit("fft", _c64(2))
    eng.drain()
    assert rf.pool_hit and eng.pool.misses == misses
    np.testing.assert_allclose(rf.result().numpy(), _want(_c64(2)), rtol=RTOL, atol=ATOL * 16)


def test_foreign_wisdom_skipped(tmp_path):
    path = tmp_path / "wisdom.json"
    path.write_text(json.dumps({"wisdom": {"v1|garbage": {"backend": "x"}}}))
    eng = SpectralEngine(_cpu(), wisdom=str(path), clock=FakeClock())
    assert len(eng.pool) == 0
