"""SPMD serving over a process group: ``SpectralEngine`` on a gloo
``ProcessGroupMesh`` at P = 4, every rank submitting its own block of
each request, held against the same stream through
``SpectralEngine(SimMesh(4))`` -- itself held against the reference's
engine by ``tests/test_torch_serve.py`` -- and numpy. One spawn runs
every case, each rank checking its own results and raising on a
mismatch, which fails the spawn:

- a mixed stream (fft, poisson, ifft of served spectra, polls between
  submissions) with **skewed clocks** (each rank's clock has its own
  offset and rate and advances on every read): every rank makes the same
  batches and returns its block of the SimMesh result (1e-6);
- a submission whose key differs on one rank makes every rank raise the
  same :class:`StreamMismatch` at the next agreement, before anything
  dispatches (no collective is entered);
- poison armed on rank 0 only: every rank reports the same errors,
  splits and quarantines; a retry budget's deadline read from clocks of
  different rates ends every rank's retries together;
- the breaker opens on every rank, degrades to ``xla_auto`` together,
  and re-probes when the largest clock says so, though the other ranks'
  own clocks say otherwise;
- ``remesh`` onto ``elastic_mesh``'s 2-rank survivor group re-warms the
  pool from wisdom and serves like ``SimMesh(2)``;
- the overlap rings (``repro_torch.core.overlap``) over the group against
  dense answers, and the ring gradient (``2x``) through a collective
  backward.

Clocks are injected; nothing sleeps."""

import json
import time

import numpy as np
import torch

from repro_torch.core import SimMesh

P = 4
N = 64
TAIL = ("model", None)
KW = dict(backend="scatter", local_impl="kernel")
REL_TOL = 1e-6  # a block against SimMesh's on the same stream: the same arithmetic
RTOL, ATOL = 1e-5, 1e-6 * 64  # against numpy, as tests/test_torch_serve.py at this size
LENGTHS = (1.0, 2.0)


class SkewClock:
    """A rank's own clock: ``offset`` plus ``rate`` x ``dt`` per read."""

    def __init__(self, offset, rate, dt=0.25):
        self.t, self.step = offset, rate * dt

    def __call__(self):
        self.t += self.step
        return self.t


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _c64(seed, shape=(N, N)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64))


def _f32(seed, shape=(N, N)):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rel(got, exp):
    return ((got - exp).abs().max() / exp.abs().max()).item()


def _gathered(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _same_on_every_rank(obj, what):
    objs = _gathered(obj)
    assert all(o == objs[0] for o in objs), (what, objs)


def _stream(eng, own):
    """A mixed stream with a poll after each submission, then a drain;
    returns (op, input, future) in submission order."""
    futs = []
    for i in range(9):
        x = _c64(i)
        futs.append(("fft", x, eng.submit("fft", own(x))))
        if i % 3 == 2:
            f = _f32(100 + i)
            futs.append(("poisson", f, eng.submit("poisson", own(f), lengths=LENGTHS)))
        eng.poll()
    for op, x, f in list(futs[:3]):  # the served spectra back through ifft
        futs.append(("ifft", x, eng.submit("ifft", f.result())))
    eng.drain()
    return futs


def _numpy(op, x):
    if op == "fft":
        return torch.from_numpy(np.fft.fft2(x.numpy()).T)
    if op == "ifft":
        return x
    k0 = 2 * np.pi * np.fft.fftfreq(N, d=LENGTHS[0] / N)
    k1 = 2 * np.pi * np.fft.fftfreq(N, d=LENGTHS[1] / N)
    k2 = k0[:, None] ** 2 + k1[None, :] ** 2
    k2[0, 0] = 1.0
    fh = np.fft.fft2(x.numpy().astype(np.float64)) / -k2
    fh[0, 0] = 0.0
    return torch.from_numpy(np.real(np.fft.ifft2(fh)))


def _clean_case(mesh, ran):
    from repro_torch.serve import SpectralEngine

    rank = mesh.rank
    eng = SpectralEngine(mesh, max_batch=4, max_wait_s=1.0, clock=SkewClock(1000.0 * rank, 1.0 + 0.5 * rank),
                         plan_kwargs=KW)
    futs = _stream(eng, lambda a: mesh.split(a, TAIL)[0])
    sim = SpectralEngine(SimMesh(P, device="cpu"), max_batch=4, max_wait_s=1.0, clock=SkewClock(0.0, 1.0),
                         plan_kwargs=KW)
    sim_futs = _stream(sim, lambda a: a)
    for (op, x, f), (_, _, s) in zip(futs, sim_futs):
        got = mesh.gather([f.block()], TAIL)
        err = _rel(got, s.block())
        assert err <= REL_TOL, (rank, op, err)
        torch.testing.assert_close(got.to(torch.complex128 if got.is_complex() else torch.float64),
                                   _numpy(op, x).to(torch.complex128 if got.is_complex() else torch.float64),
                                   rtol=RTOL, atol=ATOL * 16)
    m = eng.metrics()
    counters = {k: m[k] for k in ("requests", "completed", "batches", "padded", "agreements", "pool_hits",
                                  "pool_misses")}
    _same_on_every_rank(([f.batch_size for _, _, f in futs], counters), "batches")
    s = eng.stats()["agreements"]
    assert counters["agreements"] == s["count"] > 0 and s["host_s"] > 0
    assert sim.metrics()["agreements"] == 0  # a SimMesh agrees with nobody
    ran.append("skewed clocks agree")


def _mismatch_case(mesh, ran):
    from repro_torch.serve import SpectralEngine, StreamMismatch

    rank = mesh.rank
    eng = SpectralEngine(mesh, max_batch=4, max_wait_s=100.0, clock=FakeClock(), plan_kwargs=KW)
    block = mesh.split(_c64(0), TAIL)[0]
    eng.submit("fft", block)
    eng.submit("fft", block[:, : N // 2] if rank == 2 else block)  # rank 2's request has another global shape
    t0 = time.perf_counter()
    try:  # the next agreement checks the submissions before anything dispatches
        eng.flush()
        raise AssertionError(f"rank {rank}: no raise")
    except StreamMismatch as e:
        message = str(e)
    assert time.perf_counter() - t0 < 10.0
    _same_on_every_rank(message, "mismatch message")
    assert "request counts 2..2" in message and eng.queue.depth() == 0 and eng.batches == 0, message
    # a rank that polls while the others flush: the decision points differ
    try:
        eng.poll() if rank == 1 else eng.flush()
        raise AssertionError(f"rank {rank}: no raise")
    except StreamMismatch as e:
        assert "['flush', 'poll']" in str(e), str(e)
    # a full batch on every rank dispatches after one agreement
    futs = [eng.submit("fft", block) for _ in range(4)]
    assert all(f.done() for f in futs) and eng.batches == 1
    ran.append("mismatch raises on every rank")


def _fault_cases(mesh, ran):
    from repro_torch.runtime import CircuitBreaker, FaultPlan, RetryPolicy
    from repro_torch.serve import SpectralEngine

    rank = mesh.rank
    own = lambda a: mesh.split(a, TAIL)[0]  # noqa: E731
    xs = [_c64(40 + i) for i in range(4)]

    # poison armed on rank 0 only, every rank with a plan (an empty one elsewhere)
    eng = SpectralEngine(mesh, max_batch=4, max_wait_s=100.0, retry=RetryPolicy(max_retries=0),
                         clock=SkewClock(rank, 2.0 - 0.3 * rank), plan_kwargs=KW)
    eng.set_faults(FaultPlan.error(match="Exchange", times=2) if rank == 0 else FaultPlan())
    futs = [eng.submit("fft", own(x)) for x in xs]
    eng.drain()
    assert [f.failed() for f in futs] == [True, False, False, False], rank
    for f, x in zip(futs[1:], xs[1:]):
        torch.testing.assert_close(mesh.gather([f.result()], TAIL), _numpy("fft", x).to(torch.complex64),
                                   rtol=RTOL, atol=ATOL * 16)
    m = eng.metrics()
    counters = {k: m[k] for k in ("errors", "batch_splits", "quarantined", "failed_requests", "retries")}
    assert (counters["errors"], counters["batch_splits"], counters["quarantined"]) == (2, 1, 1)
    _same_on_every_rank(counters, "poison counters")
    ran.append("poison on one rank")

    # the retry budget's deadline, read from clocks of different rates
    eng = SpectralEngine(mesh, max_batch=1, retry=RetryPolicy(max_retries=10, deadline_s=2.0),
                         clock=SkewClock(0.0, 1.0 + rank), plan_kwargs=KW)
    eng.set_faults(FaultPlan.error(match="Exchange", times=20) if rank == 3 else FaultPlan())
    fut = eng.submit("fft", own(xs[0]))
    eng.drain()
    assert fut.failed()
    m = eng.metrics()
    _same_on_every_rank((m["retries"], m["errors"], m["quarantined"]), "retry deadline")
    assert 0 < m["retries"] < 10
    ran.append("retry deadline agreed")

    # the breaker: each rank's clock has its own offset; only the largest
    # crosses the cool-down, and every rank probes with it
    clk = FakeClock(10.0 * rank)
    eng = SpectralEngine(mesh, max_batch=1, clock=clk, retry=RetryPolicy(max_retries=0),
                         breaker=CircuitBreaker(failure_threshold=2, reset_after_s=5.0, clock=clk), plan_kwargs=KW)
    eng.set_faults(FaultPlan.error(match="Exchange", times=2) if rank == 1 else FaultPlan())

    def one(x):
        f = eng.submit("fft", own(x))
        eng.drain()
        return f

    assert all(one(x).failed() for x in xs[:2]) and eng.breaker.stats()["opened"] == 1
    deg = one(xs[2])
    assert deg.degraded and deg.backend == "xla_auto"
    torch.testing.assert_close(mesh.gather([deg.result()], TAIL), _numpy("fft", xs[2]).to(torch.complex64),
                               rtol=RTOL, atol=ATOL * 16)
    clk.advance(6.0 if rank == P - 1 else 1.0)  # rank 3's clock alone passes opened_at + 5
    probe = one(xs[3])
    assert probe.degraded is False
    b = eng.breaker.stats()
    assert (b["opened"], b["reclosed"], b["probes"], b["open"]) == (1, 1, 1, 0), (rank, b)
    _same_on_every_rank((b, eng.metrics()["degraded_dispatches"]), "breaker")
    ran.append("breaker agreed")


def _remesh_case(mesh, ran):
    import torch.distributed as dist

    from repro_torch.core import plan_fft, planner
    from repro_torch.runtime import elastic_mesh
    from repro_torch.serve import SpectralEngine

    planner.forget_wisdom()
    eng = SpectralEngine(mesh, max_batch=2, max_wait_s=100.0, clock=FakeClock(), plan_kwargs=KW)
    eng.pool.warm((1, N, N), 2, torch.complex64, False)
    small = elastic_mesh(("model",), max_devices=2, device="cpu", timeout_s=60)  # every rank calls it
    if small is None:
        assert mesh.rank >= 2
    else:
        plan_fft((2, N, N), small, planner="measure", timer=lambda p: 1.0 + len(p.backend) * 1e-3, **KW)
        assert eng.remesh(small) == 2 and len(eng.pool) == 2  # buckets 2 (the entry) and 1
        futs = [(x, eng.submit("fft", small.split(x, TAIL)[0])) for x in (_c64(60), _c64(61), _c64(62))]
        eng.drain()
        assert all(f.pool_hit for _, f in futs) and eng.pool.misses == 0
        sim = SpectralEngine(SimMesh(2, device="cpu"), max_batch=2, max_wait_s=100.0, clock=FakeClock(),
                             plan_kwargs=KW)
        sims = [sim.submit("fft", x) for x, _ in futs]
        sim.drain()
        for (x, f), s in zip(futs, sims):
            assert _rel(small.gather([f.result()], TAIL), s.result()) <= REL_TOL
        ran.append("remesh to the survivors")
    planner.forget_wisdom()
    dist.barrier()


def _ring_cases(mesh, ran):
    from repro_torch.core import collective_matmul_ag, ring_all_gather, ring_reduce_scatter, ring_scatter_reduce

    rank, ax = mesh.rank, "model"
    rng = np.random.default_rng(0)  # tests/test_overlap.py's inputs
    v = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    xm = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    vb, xmb, xb = mesh.split(v, TAIL)[0], mesh.split(xm, (None, ax))[0], mesh.split(x, TAIL)[0]
    torch.testing.assert_close(ring_all_gather([vb], mesh, ax, axis=0)[0], v)
    torch.testing.assert_close(ring_reduce_scatter([vb], mesh, ax, axis=-1)[0],
                               torch.stack(v.chunk(P)).sum(0).chunk(P, dim=-1)[rank])
    torch.testing.assert_close(collective_matmul_ag([xmb], w, mesh, ax)[0], xm @ w, rtol=1e-5, atol=1e-4)
    weighted = ring_scatter_reduce([xb], mesh, ax, lambda c, src: c * (src + 1.0))[0]
    exp = sum((s + 1.0) * blk for s, blk in enumerate(x.chunk(P))).chunk(P, dim=-1)[rank]
    torch.testing.assert_close(weighted, exp)
    g = vb.clone().requires_grad_(True)
    ((ring_all_gather([g], mesh, ax, axis=0)[0] ** 2).sum() / P).backward()  # collective backward
    torch.testing.assert_close(g.grad, 2 * vb)
    ran.append("rings over gloo")


def _worker(rank, world, init_method, tmp):
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, device="cpu", timeout_s=60)
    try:
        ran = []
        _clean_case(mesh, ran)
        _mismatch_case(mesh, ran)
        _fault_cases(mesh, ran)
        _ring_cases(mesh, ran)
        _remesh_case(mesh, ran)
        with open(f"{tmp}/ran{rank}.json", "w") as fh:
            json.dump(ran, fh)
    finally:
        dist.destroy_process_group()


def test_spmd_serving_agrees_across_a_process_group(tmp_path):
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(P, f"file://{tmp_path / 'rendezvous'}", str(tmp_path)), nprocs=P, join=True)
    common = ["skewed clocks agree", "mismatch raises on every rank", "poison on one rank", "retry deadline agreed",
              "breaker agreed", "rings over gloo"]
    for rank in range(P):
        ran = json.loads((tmp_path / f"ran{rank}.json").read_text())
        assert ran == common + (["remesh to the survivors"] if rank < 2 else []), (rank, ran)
