"""ProcessGroupMesh over gloo: the port's transforms with one rank per
process, each rank holding its own block, against SimMesh(P) on the
same seeded input.

One ``torch.multiprocessing.spawn`` per P runs every case inside it
(process start-up dominates, so the cases share it). Each rank checks
its own results and raises on a mismatch, which fails the spawn; rank 0
lists the cases that ran. The cases: every backend, fused and unfused
(and sub-chunked), for c2c fft2 and real rfft2 round trips through
``plan_fft``; fft3 / rfft3 and the functional rfft2 / irfft2; the
Poisson solve; that the streaming exchanges post every message before
the first chunk callback; at P = 2 the measured planner, calibration
and the traced executor (``_planner_cases``); and, last, that a peer
which never posts its receive fails within the group's timeout instead
of hanging.

One more spawn at P = 4 builds the 2-D grids (2,2), (1,4) and (4,1)
from per-axis subgroups and runs the pencil plans on each, against
SimMesh on the same grid, ending with an unreceived send on a sub-axis
ring that fails within that subgroup's timeout."""

import json
import time

import numpy as np
import pytest
import torch

REL_TOL = 1e-6  # the same arithmetic on the same blocks; only the transport differs
TIMEOUT_S = 2.0  # the short-timeout group of the hang case


def _rel(got: torch.Tensor, exp: torch.Tensor) -> float:
    return ((got - exp).abs().max() / exp.abs().max()).item()


def _c64(seed, shape):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64))


def _f32(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _cases(mesh, sim, ran):
    """Every case of one P; ``mesh`` is this rank's ProcessGroupMesh,
    ``sim`` the SimMesh(P) oracle on the CPU."""
    from repro_torch.apps import solve_poisson
    from repro_torch.core import FFTConfig, backends, irfft2, plan_fft, rfft2
    from repro_torch.core import transpose as tr

    p, rank = mesh.p, mesh.rank

    def check(name, got_block, exp_global, tail):
        got = mesh.gather([got_block], tail)
        err = _rel(got, exp_global)
        if not err <= REL_TOL:
            raise AssertionError(f"P={p} rank {rank} {name}: rel err {err:.3e} > {REL_TOL}")
        ran.append(name)

    x = _c64(p, (2, 8 * p, 4 * p))  # (batch, R, C)
    xr = _f32(p + 1, (3, 8 * p, 10))  # odd batch, Hermitian axis 6 (padded to a multiple of P)
    for name in backends.supporting(p):
        for pipeline in ("auto", False, 3 * p):
            tag = f"{name}/{pipeline}"
            kw = dict(backend=name, pipeline=pipeline, local_impl="kernel")
            plan, ref = plan_fft(x.shape, mesh, **kw), plan_fft(x.shape, sim, **kw)
            assert plan.fused == ref.fused and plan.schedule_hash() == ref.schedule_hash()
            y = plan.execute(mesh.split(x, (plan.axis_name, None))[0])
            exp = ref.execute(x)
            check(f"c2c {tag}", y, exp, ("model", None))
            check(f"c2c inverse {tag}", plan.inverse(y), ref.inverse(exp), ("model", None))
            rplan, rref = plan_fft(xr.shape, mesh, real=True, **kw), plan_fft(xr.shape, sim, real=True, **kw)
            ry = rplan.execute(mesh.split(xr, ("model", None))[0])
            rexp = rref.execute(xr)
            assert tuple(mesh.gather([ry], ("model", None)).shape) == rref.spectrum_shape()
            check(f"r2c {tag}", ry, rexp, ("model", None))
            check(f"c2r {tag}", rplan.inverse(ry), rref.inverse(rexp), ("model", None))

    x3, xr3 = _c64(7, (4 * p, 4, 2 * p)), _f32(8, (4 * p, 3, 10))
    for real, arr in ((False, x3), (True, xr3)):
        kw = dict(ndim=3, backend="scatter", real=real, local_impl="kernel")
        plan, ref = plan_fft(arr.shape, mesh, **kw), plan_fft(arr.shape, sim, **kw)
        y = plan.execute(mesh.split(arr, ("model", None, None))[0])
        exp = ref.execute(arr)
        check(f"fft3 real={real}", y, exp, ("model", None, None))
        check(f"ifft3 real={real}", plan.inverse(y), ref.inverse(exp), ("model", None, None))

    cfg = FFTConfig(strategy="pairwise_xor", fused=True, transpose_back=True)
    y = rfft2(mesh.split(xr, ("model", None))[0], mesh, "model", cfg)
    exp = rfft2(xr, sim, "model", cfg)
    check("functional rfft2 transpose_back", y, exp, ("model", None))
    check("functional irfft2", irfft2(y, mesh, "model", cfg, n_last=10), irfft2(exp, sim, "model", cfg, n_last=10),
          ("model", None))

    n = 8 * p
    grid = np.arange(n) * 2 * np.pi / n
    gx, gy = np.meshgrid(grid, grid, indexing="ij")
    f = torch.from_numpy((-5.0 * np.sin(gx) * np.cos(2 * gy)).astype(np.float32))
    kw = dict(real=True, backend="scatter", local_impl="kernel")
    plan, ref = plan_fft((n, n), mesh, **kw), plan_fft((n, n), sim, **kw)
    check("solve_poisson", solve_poisson(mesh.split(f, ("model", None))[0], plan),
          solve_poisson(f, ref), ("model", None))

    with pytest.raises(ValueError, match="sends or receives twice"):
        mesh.ppermute_start([x], [(rank, (rank + 1) % p), (rank, rank)])
    with pytest.raises(ValueError, match="cannot run rank"):
        with mesh.running((rank + 1) % p):
            pass
    assert mesh.local_ranks() == [rank] and mesh.axis_index("model") == rank
    ran.append("argument checks")

    # every message is posted before the first chunk callback runs
    q = 2
    blocks = mesh.split(_c64(9, (4 * p, 4 * p)), ("model", None))
    for name in ("scatter", "pairwise_xor"):
        for run in (
            lambda fn: tr.distributed_transpose(blocks, mesh, "model", strategy=name, chunk_fn=fn, n_chunks=q * p),
            lambda fn: backends.get(name).stream_reduce(blocks, mesh, "model", fn, n_chunks=q * p),
        ):
            seen = []

            def fn(chunk, src, offset):
                seen.append(mesh.in_flight)
                return chunk

            run(fn)
            assert seen[0] == (p - 1) * q and len(seen) == p * q and mesh.in_flight == 0, (name, seen)
        ran.append(f"posted up front {name}")


#: What _planner_cases adds to ``ran`` (the P = 2 spawn only).
PLANNER_CASES = ["measured race agreed", "wisdom hit agreed", "ping-pong bytes", "calibration agreed",
                 "traced spans per rank"]


def _planner_cases(mesh, sim, ran):
    """The measured planner over gloo: every decision that leads into
    collectives is agreed, so the ranks race, hit and pin together even
    where each rank's own clock disagrees; the ping-pong behind
    calibrate moves the bytes it claims; traced spans carry the rank."""
    import torch.distributed as dist

    import repro_torch.core.comm_model as cm
    from repro_torch.core import plan_fft, planner
    from repro_torch.obs import TraceRecorder

    rank = mesh.rank

    def gathered(obj):
        out = [None] * mesh.p
        dist.all_gather_object(out, obj)
        return out

    planner.forget_wisdom()
    calls = []

    def timer(plan):  # rank 0 finds scatter fastest, rank 1 slowest; bisection fails on rank 1 only
        calls.append(plan.backend)
        if rank == 1 and plan.backend == "bisection":
            raise RuntimeError("rank 1 only")
        return {"scatter": (1.0, 5.0), "alltoall": (3.0, 2.0)}.get(plan.backend, (4.0, 4.0))[rank]

    x = _c64(21, (16, 16))
    plan = plan_fft((16, 16), mesh, planner="measure", timer=timer, local_impl="kernel")
    tables = gathered((plan.backend, plan.measured))
    assert tables[0] == tables[1] and plan.backend == "alltoall", tables
    assert plan.measured["scatter"] == 5.0 and plan.measured["bisection"] == float("inf")
    assert plan.race_failures["bisection"] == ("failed on another rank" if rank == 0 else "RuntimeError: rank 1 only")
    got = mesh.gather([plan.execute(mesh.split(x, ("model", None))[0])], ("model", None))
    if not _rel(got, plan_fft((16, 16), sim, backend="alltoall", local_impl="kernel").execute(x)) <= REL_TOL:
        raise AssertionError(f"rank {rank}: the measured winner disagrees with SimMesh")
    ran.append("measured race agreed")

    n_calls = len(calls)
    again = plan_fft((16, 16), mesh, planner="measure", timer=timer, local_impl="kernel")
    assert again.selection_channel == "wisdom-hit" and len(calls) == n_calls
    if rank == 1:
        planner.forget_wisdom()  # rank 0 still holds its entry, but must not take the hit alone
    third = plan_fft((16, 16), mesh, planner="measure", timer=timer, local_impl="kernel")
    assert third.selection_channel == "measured-race" and len(calls) == 2 * n_calls
    assert gathered(third.backend) == ["alltoall", "alltoall"]
    ran.append("wisdom hit agreed")

    sent = []
    post = mesh.ppermute_start

    def spy(pieces, perm):
        sent.append(pieces[0].numel() * pieces[0].element_size())
        return post(pieces, perm)

    mesh.ppermute_start = spy  # the ping-pong runs over the mesh's own ppermute
    try:
        t = cm._pingpong_timer(mesh, None, warmup=1, iters=2, rounds=3)(4096)
    finally:
        del mesh.ppermute_start
    assert sent == [4096] * (2 * 3 * (1 + 2)) and t > 0 and gathered(t) == [t, t]
    fwd = mesh.ppermute_start([torch.full((1024,), float(rank + 1))], [(0, 1), (1, 0)]).wait()[0]
    back = mesh.ppermute_start([fwd], [(0, 1), (1, 0)]).wait()[0]
    assert torch.equal(fwd, torch.full((1024,), float(2 - rank))) and torch.equal(back, torch.full((1024,), rank + 1.0))
    ran.append("ping-pong bytes")

    planner.forget_calibration()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a short gloo sweep may not pin beta
        fit = planner.ensure_calibrated(mesh, sizes=(4096, 1 << 16, 1 << 20))
    assert gathered((fit.alpha_s, fit.beta_bytes_s)) == [(fit.alpha_s, fit.beta_bytes_s)] * 2
    assert planner.calibration_for("cpu") == fit and planner.calibration_for("cpu (SimMesh)") is None
    assert plan_fft((16, 16), mesh).params == fit
    planner.forget_calibration()
    ran.append("calibration agreed")

    rec = TraceRecorder()
    res = plan_fft((16, 16), mesh, backend="scatter", local_impl="kernel").profile(trace=rec, reps=2, warmup=0)
    assert [r.stage for r in res.rows] == ["LocalFFT(axis=-1)", "Exchange(slab:model, scatter, p=2, fft, fused)"]
    assert {s.pid for s in rec.spans} == {rank}
    ran.append("traced spans per rank")
    planner.forget_wisdom()


def _hang_case(ran):
    """Rank 0 sends to rank 1, which never posts its receive: the send
    fails within the group's timeout."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import ProcessGroupMesh

    group = dist.new_group(timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mesh = ProcessGroupMesh(device="cpu", group=group)
    if mesh.rank == 0:
        t0 = time.perf_counter()
        pending = mesh.ppermute_start([torch.ones(4, dtype=torch.complex64)], [(0, 1)])
        with pytest.raises(RuntimeError, match="[Tt]imed out|timeout"):
            pending.wait()
        waited = time.perf_counter() - t0
        assert waited < 4 * TIMEOUT_S, waited
        ran.append(f"unreceived send fails after {waited:.1f} s")
    dist.barrier()  # the default group: rank 1 leaves only after rank 0 has timed out


def _worker(rank, world, init_method, out_path):
    import torch.distributed as dist

    from repro_torch.core import SimMesh, init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, device="cpu", timeout_s=60)
    try:
        ran = []
        _cases(mesh, SimMesh(world, device="cpu"), ran)
        if world == 2:
            _planner_cases(mesh, SimMesh(world, device="cpu"), ran)
        _hang_case(ran)
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(ran, fh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("p", [2, 4])
def test_process_group_mesh_matches_sim_mesh(p, tmp_path):
    import torch.multiprocessing as mp

    out = tmp_path / "ran.json"
    mp.spawn(_worker, args=(p, f"file://{tmp_path / 'rendezvous'}", str(out)), nprocs=p, join=True)
    ran = json.loads(out.read_text())
    from repro_torch.core import backends

    names = backends.supporting(p)
    assert len(names) == 5  # alltoall, bisection, pairwise_xor, scatter, xla_auto
    for kind in ("c2c", "c2c inverse", "r2c", "c2r"):
        assert [c for c in ran if c.startswith(kind + " ") and c.count(" ") == kind.count(" ") + 1] == [
            f"{kind} {n}/{pipe}" for n in names for pipe in ("auto", False, 3 * p)
        ]
    for case in ("fft3 real=True", "ifft3 real=False", "functional irfft2", "solve_poisson",
                 "posted up front scatter", "posted up front pairwise_xor"):
        assert case in ran
    planner_cases = PLANNER_CASES if p == 2 else []
    assert ran[-1 - len(planner_cases):-1] == planner_cases, ran
    assert len(ran) == 4 * 15 + 4 + 2 + 1 + 1 + 2 + len(planner_cases) + 1, ran
    assert ran[-1].startswith("unreceived send fails"), ran


GRIDS = ((2, 2), (1, 4), (4, 1))


def _grid_cases(mesh, ran):
    """Pencil plans on one ProcessGroupMesh grid (one subgroup per ring
    of each axis), each held against the same plan on a SimMesh of the
    same grid: c2c fft2 / fft3 fused and unfused and one mixed pair,
    fft3 transposed back, rfft3 and a real Poisson solve, each rank on
    its own block."""
    from repro_torch.apps import solve_poisson
    from repro_torch.core import SimMesh, plan_fft

    grid = mesh.dims
    sim = SimMesh(grid, axis_names=mesh.axis_names, device="cpu")
    rank = mesh.rank

    def run(name, shape, data, **kw):
        plan, ref = plan_fft(shape, mesh, decomp="pencil", **kw), plan_fft(shape, sim, decomp="pencil", **kw)
        assert plan.schedule_hash() == ref.schedule_hash() and plan.fused == ref.fused
        block = mesh.split(data, plan.input_spec().tail)[0]
        y, exp = plan.execute(block), ref.execute(data)
        out_tail = plan.schedule().out_tail
        for label, got, want, tail in ((name, y, exp, out_tail),
                                       (f"{name} inverse", plan.inverse(y), ref.inverse(exp), plan.input_spec().tail)):
            err = _rel(mesh.gather([got], tail), want)
            if not err <= REL_TOL:
                raise AssertionError(f"grid {grid} rank {rank} {label}: rel err {err:.3e} > {REL_TOL}")
        ran.append(f"{grid} {name}")

    x2, x3 = _c64(11, (2, 8, 16)), _c64(12, (8, 8, 8))
    for pair, pipeline in ((("scatter", "scatter"), "auto"), (("scatter", "scatter"), False),
                           (("scatter", "bisection"), "auto")):
        kw = dict(backend=pair, pipeline=pipeline, local_impl="kernel")
        run(f"fft2 {'+'.join(pair)}/{pipeline}", x2.shape, x2, **kw)
        run(f"fft3 {'+'.join(pair)}/{pipeline}", x3.shape, x3, ndim=3, **kw)
    run("fft3 transpose_back", x3.shape, x3, ndim=3, transpose_back=True, backend=("pairwise_xor", "alltoall"))
    xr3 = _f32(13, (8, 8, 10))
    run("rfft3", xr3.shape, xr3, ndim=3, real=True, backend="scatter", local_impl="kernel")

    n = 16
    g = np.arange(n) * 2 * np.pi / n
    gx, gy = np.meshgrid(g, g, indexing="ij")
    f = torch.from_numpy((-5.0 * np.sin(gx) * np.cos(2 * gy)).astype(np.float32))
    kw = dict(real=True, decomp="pencil", backend="scatter", local_impl="kernel")
    plan, ref = plan_fft((n, n), mesh, **kw), plan_fft((n, n), sim, **kw)
    tail = plan.input_spec().tail
    got = mesh.gather([solve_poisson(mesh.split(f, tail)[0], plan)], tail)
    err = _rel(got, solve_poisson(f, ref))
    if not err <= REL_TOL:
        raise AssertionError(f"grid {grid} rank {rank} solve_poisson: rel err {err:.3e} > {REL_TOL}")
    ran.append(f"{grid} solve_poisson")


def _sub_axis_hang_case(ran):
    """On a 2x2 grid with a short timeout, rank 0 sends to its cols-ring
    peer (rank 1), which never posts its receive: the send fails within
    the subgroup's timeout."""
    import torch.distributed as dist

    from repro_torch.core import ProcessGroupMesh

    mesh = ProcessGroupMesh(device="cpu", grid=(2, 2), timeout_s=TIMEOUT_S)
    ((ring, _),) = mesh.rings("cols")
    if mesh.rank == 0:
        assert ring.p == 2 and ring.rank == 0 and ring._global == [0, 1]
        t0 = time.perf_counter()
        pending = ring.ppermute_start([torch.ones(4, dtype=torch.complex64)], [(0, 1)])
        with pytest.raises(RuntimeError, match="[Tt]imed out|timeout"):
            pending.wait()
        waited = time.perf_counter() - t0
        assert waited < 4 * TIMEOUT_S, waited
        ran.append(f"unreceived sub-axis send fails after {waited:.1f} s")
    dist.barrier()  # the default group: the others leave only after rank 0 has timed out


def _grid_worker(rank, world, init_method, out_path):
    import torch.distributed as dist

    from repro_torch.core import ProcessGroupMesh, init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, device="cpu", timeout_s=60, grid=GRIDS[0])
    try:
        ran = []
        for grid in GRIDS:
            gm = mesh if grid == GRIDS[0] else ProcessGroupMesh(device="cpu", grid=grid, timeout_s=60)
            assert gm.shape == {"rows": grid[0], "cols": grid[1]} and gm.coords(rank) == dict(
                zip(("rows", "cols"), divmod(rank, grid[1])))
            _grid_cases(gm, ran)
        _sub_axis_hang_case(ran)
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(ran, fh)
    finally:
        dist.destroy_process_group()


def test_process_group_grid_matches_sim_mesh(tmp_path):
    """P = 4 processes over gloo as a (2,2), (1,4) and (4,1) grid, each
    axis's exchanges over its own ring subgroup."""
    import torch.multiprocessing as mp

    out = tmp_path / "ran.json"
    mp.spawn(_grid_worker, args=(4, f"file://{tmp_path / 'rendezvous'}", str(out)), nprocs=4, join=True)
    ran = json.loads(out.read_text())
    per_grid = ["fft2 scatter+scatter/auto", "fft3 scatter+scatter/auto", "fft2 scatter+scatter/False",
                "fft3 scatter+scatter/False", "fft2 scatter+bisection/auto", "fft3 scatter+bisection/auto",
                "fft3 transpose_back", "rfft3", "solve_poisson"]
    assert ran[:-1] == [f"{grid} {name}" for grid in GRIDS for name in per_grid], ran
    assert ran[-1].startswith("unreceived sub-axis send fails"), ran


def test_process_group_mesh_needs_a_group():
    from repro_torch.core import ProcessGroupMesh

    with pytest.raises(RuntimeError, match="init_process_mesh"):
        ProcessGroupMesh(device="cpu")
