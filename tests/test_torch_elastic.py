"""Recovery and elastic re-scale in the port (``repro_torch.runtime``):
backoff, restart and injector schedules equal to the reference's,
``elastic_mesh`` on one process, the reference's elastic scenario
(a run that loses half its ranks at step 3 resumes from its checkpoint
on the survivors, bitwise equal to an uninterrupted run) on ``SimMesh``,
and one gloo spawn at P = 4 for everything that needs ranks in separate
processes:

- fault plans that differ per rank make every rank raise together (the
  agreement of ``schedule._consult_faults``), well inside the group's
  timeout, and an armed plan on one rank computes correctly;
- ``PlanPool`` serves on a ``ProcessGroupMesh`` (the engine's SPMD
  serving is held by ``tests/test_torch_serve_spmd.py``);
- elastic 4 -> 2 over ``dist.new_group`` (called on all four ranks),
  rank 0 checkpointing the gathered state, is bitwise equal to an
  uninterrupted P = 2 ``ProcessGroupMesh`` run and to ``SimMesh(2)``.

Sleeps are injected; nothing sleeps."""

import json
import random
import time

import numpy as np
import pytest
import torch

import jax
import repro.runtime.elastic as ref_elastic
import repro_torch.runtime.elastic as elastic
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import SimMesh
from repro_torch.runtime import FailureInjector, SimulatedFailure, elastic_mesh, run_with_recovery
from repro_torch.serve import PlanPool
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

N = 32
STEPS = 6
FAIL_AT = 3
#: unfused alltoall: local FFTs and pure data movement, so results are
#: bitwise identical at any P (the reference's ELASTIC_CODE setting)
PLAN_KW = dict(decomp="slab", backend="alltoall", pipeline=False, local_impl="kernel")
REL_TOL = 1e-6  # a ProcessGroupMesh result against SimMesh's: the same arithmetic


def _c64(seed, shape=(N, N)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64))


def _problem():
    rng = np.random.default_rng(42)
    draw = lambda: torch.from_numpy(  # noqa: E731
        (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))).astype(np.complex64))
    x0 = draw()
    return x0, [draw() for _ in range(STEPS)]


def _rel(got, exp):
    return ((got - exp).abs().max() / exp.abs().max()).item()


# ---------------------------------------------------- recovery primitives
@pytest.mark.parametrize("base,cap,jitter,seed", [(1.0, 5.0, 0.25, 3), (0.5, 30.0, 0.0, 0), (2.0, 3.0, 0.5, 9),
                                                  (0.0, 5.0, 0.25, 1)])
def test_backoff_delays_equal_the_references(base, cap, jitter, seed):
    seqs = []
    for mod in (elastic, ref_elastic):
        rng = random.Random(seed)
        seqs.append([mod.backoff_delay(r, base, cap_s=cap, jitter=jitter, rng=rng) for r in range(1, 8)])
        seqs[-1].append(mod.backoff_delay(10, base, cap_s=cap))  # no rng: jitterless
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("fails,max_restarts,backoff", [(2, 3, 1.0), (0, 1, 1.0), (3, 3, 0.5), (4, 3, 0.5)])
def test_run_with_recovery_matches_the_reference(fails, max_restarts, backoff):
    runs = []
    for mod in (elastic, ref_elastic):
        slept, resumes, hooks = [], [], []

        def loop(resume):
            resumes.append(None if resume is None else (resume.restarts, resume.cause, resume.step))
            if len(resumes) <= fails:
                raise mod.SimulatedFailure(f"crash {len(resumes)}")

        try:
            out = mod.run_with_recovery(loop, max_restarts=max_restarts, backoff_s=backoff, seed=5,
                                        sleep=slept.append, on_restart=lambda r, e: hooks.append((r, str(e))))
        except mod.SimulatedFailure as e:
            out = f"raised {e}"
        runs.append((out, slept, resumes, hooks))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("at,every,times", [(3, 2, 2), (2, None, 1), (0, 3, None), (None, None, 1), (4, 1, 3)])
def test_failure_injector_schedules_equal_the_references(at, every, times):
    fired = []
    for mod in (elastic, ref_elastic):
        inj = mod.FailureInjector(at, every=every, times=times)
        seq = []
        for s in range(12):
            try:
                inj.maybe_fail(s)
            except mod.SimulatedFailure as e:
                seq.append((s, str(e)))
        fired.append((seq, inj.fired_steps, inj.fired, inj.scheduled(at or 0)))
    assert fired[0] == fired[1]


def test_elastic_mesh_on_one_process():
    m = elastic_mesh(("model",), device="cpu")
    assert isinstance(m, SimMesh) and m.p == elastic.SIM_DEVICES and m.axis_name == "model"
    assert elastic_mesh(("model",), max_devices=2, device="cpu").p == 2
    g = elastic_mesh(("data", "model"), model_parallel=2, devices=range(7), device="cpu")
    assert g.dims == (3, 2) and g.axis_names == ("data", "model")
    cases = ((("data", "model"), dict(model_parallel=2), 1), (("model",), dict(model_parallel=2), 4))
    for names, kw, n in cases:
        msgs = []
        for fn, devs in ((elastic_mesh, list(range(n))), (ref_elastic.elastic_mesh, jax.devices()[:1] * n)):
            with pytest.raises(ValueError) as ei:
                fn(names, devices=devs, **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------- the elastic scenario, SimMesh
def _run_sim(ckdir, alive, injector=None, make_mesh=None):
    """The reference's ELASTIC_CODE on SimMesh: STEPS forced steps of
    ``state = ifft2(fft2(state + forcing)) / 2``, a checkpoint after each;
    ``injector`` fails a step, and the crash takes half the ranks.
    ``make_mesh(n)`` defaults to ``elastic_mesh`` of n ranks."""
    make_mesh = make_mesh or (lambda n: elastic_mesh(("model",), max_devices=n, device="cpu"))
    x0, forcing = _problem()
    ckpt = CheckpointManager(ckdir, keep=5)
    out = {}

    def loop(resume):
        mesh = make_mesh(alive["n"])
        plan, _ = PlanPool(mesh, plan_kwargs=PLAN_KW).get((N, N), 2, torch.complex64, False)
        state, start = x0, 0
        latest, restored = ckpt.restore_latest({"x": x0})
        if latest is not None:
            state, start = restored["x"], latest
            out.setdefault("resumed_at", (start, mesh.p))
        for step in range(start, STEPS):
            if injector is not None:
                try:
                    injector.maybe_fail(step)
                except SimulatedFailure:
                    alive["n"] = alive["n"] // 2
                    raise
            state = plan.inverse(plan.execute(state + forcing[step])) * 0.5
            ckpt.save(step + 1, {"x": state}, blocking=True)
        out["x"] = state

    out["restarts"] = run_with_recovery(loop, max_restarts=2, sleep=lambda s: None)
    return out


def test_elastic_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    inj = FailureInjector(FAIL_AT)
    got = _run_sim(str(tmp_path / "a"), {"n": 4}, inj)
    assert inj.fired_steps == [FAIL_AT] and got["restarts"] == 1
    assert got["resumed_at"] == (FAIL_AT, 2)  # resumed mid-run on 2 ranks
    ref2 = _run_sim(str(tmp_path / "b"), {"n": 2})
    assert ref2["restarts"] == 0 and "resumed_at" not in ref2
    assert torch.equal(got["x"], ref2["x"])
    assert torch.equal(got["x"], _run_sim(str(tmp_path / "c"), {"n": 4})["x"])  # pure movement: P-free
    x0, forcing = _problem()
    state = x0.numpy().astype(np.complex128)
    for f in forcing:
        state = np.fft.ifft2(np.fft.fft2(state + f.numpy())) * 0.5
    np.testing.assert_allclose(got["x"].numpy(), state, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ gloo, P = 4
def _raises_together(mesh, plan, block, ran, tag, exp_type, exp_rank, alive=None):
    """Run ``plan`` on the rank's block: every rank must raise
    ``exp_type`` naming ``exp_rank``, long before the group's timeout."""
    from repro_torch.runtime import DeviceLossFault, InjectedFault

    t0 = time.perf_counter()
    try:
        plan.execute(block)
    except InjectedFault as e:
        assert type(e) is exp_type, (mesh.rank, tag, type(e))
        assert f"on rank {exp_rank}" in str(e), (mesh.rank, str(e))
        if exp_type is DeviceLossFault:
            assert e.alive == alive, (mesh.rank, e.alive)
    else:
        raise AssertionError(f"rank {mesh.rank} {tag}: no raise")
    waited = time.perf_counter() - t0
    assert waited < 10.0, (tag, waited)
    ran.append(tag)


def _agreement_cases(mesh, ran):
    from repro_torch.core import ProcessGroupMesh, plan_fft
    from repro_torch.core import schedule as sch
    from repro_torch.obs import TraceRecorder
    from repro_torch.runtime import DeviceLossFault, FaultPlan, InjectedFault

    rank, p = mesh.rank, mesh.p
    sim = SimMesh(p, device="cpu")
    x = _c64(1)
    kw = dict(backend="scatter", local_impl="kernel")
    exp = plan_fft((N, N), sim, **kw).execute(x)
    block = mesh.split(x, ("model", None))[0]

    def check(plan, tag):
        got = mesh.gather([plan.execute(block)], ("model", None))
        err = _rel(got, exp)
        assert err <= REL_TOL, (rank, tag, err)
        ran.append(tag)

    # only rank 0's plan fires: every rank raises at the same exchange
    fp = FaultPlan.error(match="Exchange") if rank == 0 else FaultPlan()
    plan = plan_fft((N, N), mesh, faults=fp, **kw)
    _raises_together(mesh, plan, block, ran, "one rank fires", InjectedFault, 0)
    assert [e["stage"] for e in fp.events] == (["Exchange(slab:model, scatter, p=4, fft, fused)"] if rank == 0 else [])
    check(plan, "clean after the fault")  # rank 0's plan is exhausted: plain path on every rank

    # an error on rank 0 and a device loss on rank 3: all raise the device loss
    fp = {0: FaultPlan.error(), 3: FaultPlan.device_loss(2)}.get(rank, FaultPlan())
    plan.faults = fp
    _raises_together(mesh, plan, block, ran, "device loss wins", DeviceLossFault, 3, alive=2)

    # armed on one rank only, never raising: the chaos path computes correctly
    slept = []
    plan.faults = FaultPlan.stall(0.5, times=None, sleep=slept.append) if rank == 1 else FaultPlan()
    check(plan, "stall on one rank")
    assert slept == ([0.5] if rank == 1 else []), (rank, slept)
    plan.faults = FaultPlan.error(match="no-such-stage") if rank == 2 else FaultPlan()
    check(plan, "armed, never matching, on one rank")

    # traced: the consult is outside the span on every rank
    rec = TraceRecorder()
    fp = FaultPlan.error(match="Exchange") if rank == 2 else FaultPlan()
    try:
        sch.run_schedule(block, plan.schedule(), mesh, trace=rec, faults=fp)
        raise AssertionError("traced: no raise")
    except InjectedFault as e:
        assert "on rank 2" in str(e)
    assert not any(s.cat == "exchange" for s in rec.spans) and all(s.dur >= 0 for s in rec.spans)
    ran.append("traced")

    # the global: label of the library backend
    gplan = plan_fft((N, N), mesh, backend="xla_auto", faults=FaultPlan.error(match="global:") if rank == 3
                     else FaultPlan())
    _raises_together(mesh, gplan, block, ran, "global label", InjectedFault, 3)

    # a 2x2 grid: a device loss on one rank's cols exchange
    grid = ProcessGroupMesh(device="cpu", grid=(2, 2), axis_names=("rows", "cols"), timeout_s=60)
    pplan = plan_fft((N, N), grid, decomp="pencil", backend=("scatter", "alltoall"), local_impl="kernel",
                     faults=FaultPlan.device_loss(3, match="cols") if rank == 1 else FaultPlan())
    pblock = grid.split(x, pplan.input_spec().tail)[0]
    _raises_together(grid, pplan, pblock, ran, "grid device loss", DeviceLossFault, 1, alive=3)
    got = grid.gather([pplan.execute(pblock)], pplan.schedule().out_tail)
    assert _rel(got, torch.fft.fft2(x)) < 1e-5
    ran.append("grid clean")

    # the plan pool on a process group (tests/test_torch_serve_spmd.py serves on one)
    pool = PlanPool(mesh, plan_kwargs=kw)
    pool.warm((N, N), 2, torch.complex64, False)
    pooled, hit = pool.get((N, N), 2, torch.complex64, False)
    assert hit and pool.key((N, N), 2, torch.complex64, False).endswith("|P=4|decomp=slab|real=0")
    check(pooled, "plan pool")


def _run_pg(mesh0, ckdir, alive, injector=None):
    """The elastic scenario with one rank per process: the ranks' blocks
    step; rank 0 checkpoints the gathered state, then a ``mesh.all_max``
    barrier; after a crash, ``elastic_mesh`` (called on every rank) keeps
    the survivors, which restore the global state and cut their blocks."""
    x0, forcing = _problem()
    ckpt = CheckpointManager(ckdir, keep=5)
    out = {}

    def loop(resume):
        mesh = elastic_mesh(("model",), max_devices=alive["n"], device="cpu", timeout_s=60)
        if mesh is None:
            out["left"] = True  # not a survivor: wait at the final barrier
            return
        plan, _ = PlanPool(mesh, plan_kwargs=PLAN_KW).get((N, N), 2, torch.complex64, False)
        tail = plan.input_spec().tail
        state, start = x0, 0
        latest, restored = ckpt.restore_latest({"x": x0})
        if latest is not None:
            state, start = restored["x"], latest
            out.setdefault("resumed_at", (start, mesh.p))
        block = mesh.split(state, tail)[0]
        for step in range(start, STEPS):
            if injector is not None:
                try:
                    injector.maybe_fail(step)
                except SimulatedFailure:
                    alive["n"] = alive["n"] // 2
                    raise
            block = plan.inverse(plan.execute(block + mesh.split(forcing[step], tail)[0])) * 0.5
            full = mesh.gather([block], tail)
            if mesh.rank == 0:
                ckpt.save(step + 1, {"x": full}, blocking=True)
            mesh.all_max([0.0])  # on disk before any rank reads it
        out["x"] = mesh.gather([block], tail)

    out["restarts"] = run_with_recovery(loop, max_restarts=2, sleep=lambda s: None)
    return out


def _elastic_cases(mesh, tmp, ran):
    import torch.distributed as dist

    # two axes: the survivors' grid makes a subgroup per ring, and the
    # others must join each creation (dist.new_group is collective)
    grid = elastic_mesh(("data", "model"), model_parallel=2, max_devices=2, device="cpu", timeout_s=60)
    if mesh.rank < 2:
        assert grid.dims == (1, 2) and grid.axis_names == ("data", "model")
        assert grid.rings("model")[0][0].all_max([grid.rank])[0] == 1.0
        ran.append("elastic grid")
    else:
        assert grid is None

    inj = FailureInjector(FAIL_AT)
    got = _run_pg(mesh, f"{tmp}/resume", {"n": 4}, inj)
    ref2 = _run_pg(mesh, f"{tmp}/p2", {"n": 2})
    assert inj.fired_steps == [FAIL_AT] and got["restarts"] == 1
    if mesh.rank < 2:
        assert got["resumed_at"] == (FAIL_AT, 2) and ref2["restarts"] == 0
        assert torch.equal(got["x"], ref2["x"])
        sim2 = _run_sim(f"{tmp}/sim2-{mesh.rank}", {"n": 2}, make_mesh=lambda n: SimMesh(n, device="cpu"))
        assert torch.equal(got["x"], sim2["x"])
        ran.append("elastic 4 -> 2 bitwise")
    else:
        assert got.get("left") and ref2.get("left") and "x" not in got
    dist.barrier()


def _worker(rank, world, init_method, tmp):
    import torch.distributed as dist

    from repro_torch.core import init_process_mesh

    torch.set_num_threads(1)
    mesh = init_process_mesh(rank, world, init_method, device="cpu", timeout_s=60)
    try:
        ran = []
        _agreement_cases(mesh, ran)
        _elastic_cases(mesh, tmp, ran)
        if rank == 0:
            with open(f"{tmp}/ran.json", "w") as fh:
                json.dump(ran, fh)
    finally:
        dist.destroy_process_group()


def test_process_group_faults_agree_and_elastic_shrinks(tmp_path):
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(4, f"file://{tmp_path / 'rendezvous'}", str(tmp_path)), nprocs=4, join=True)
    ran = json.loads((tmp_path / "ran.json").read_text())
    assert ran == [
        "one rank fires", "clean after the fault", "device loss wins", "stall on one rank",
        "armed, never matching, on one rank", "traced", "global label", "grid device loss", "grid clean",
        "plan pool", "elastic grid", "elastic 4 -> 2 bitwise",
    ]
