"""The port's plan_fft end to end on the simulated mesh: fft2 / fft3 /
fft1d against numpy.fft for the streaming and monolithic backends, fused
and unfused, with the library and the kernel local impls (the kernels'
plain paths on the CPU); schedule hashes and comm bytes equal to the
reference's plans; and one multi-device subprocess of reference plans
at P = 4 (local_impl="matmul": the reference's Pallas impl fails inside
shard_map on jax 0.9.0, ROADMAP §C) that the port must match."""

import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import CommParams, SimMesh, plan_fft
from repro_torch.core import schedule as sch
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

PS = (1, 2, 4, 8)
BACKENDS = ("alltoall", "scatter", "pairwise_xor")
SHAPES = {1: (1024,), 2: (2, 16, 32), 3: (2, 8, 16, 8)}


def _c64(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


def _oracle(x, ndim, inverse=False):
    if ndim == 1:
        return np.fft.fft(x)
    if ndim == 2:
        y = np.fft.ifft2(x) if inverse else np.fft.fft2(x)
        return np.swapaxes(y, -1, -2)  # the slab layout: F^T, C sharded
    return np.fft.ifftn(x, axes=(-3, -2, -1)) if inverse else np.fft.fftn(x, axes=(-3, -2, -1))


def _rel(got, exp):
    return np.abs(got - exp).max() / np.abs(exp).max()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("p", PS)
def test_plan_matches_numpy(p, ndim, backend):
    mesh = SimMesh(p, device="cpu")
    shape = SHAPES[ndim]
    x = _c64(100 * p + ndim, shape)
    for impl in ("torch", "kernel"):
        for pipeline in ("auto", False):
            plan = plan_fft(shape, mesh, ndim=ndim, backend=backend, local_impl=impl, pipeline=pipeline)
            assert plan.fused == (pipeline == "auto" and backend != "alltoall" and p > 1)
            y = plan.execute(torch.from_numpy(x)).numpy()
            assert y.dtype == np.complex64
            assert _rel(y, _oracle(x, ndim)) < 5e-5, (impl, pipeline)
            if ndim > 1:
                z = plan.inverse(torch.from_numpy(y)).numpy()
                assert np.abs(z - x).max() / np.abs(x).max() < 5e-5, (impl, pipeline)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("p", [2, 4])
def test_plan_c128_against_numpy(p, ndim):
    """c128 stays double precision on the torch impl (the reference runs
    with x64 disabled, so numpy is the only oracle here)."""
    mesh = SimMesh(p, device="cpu")
    shape = SHAPES[ndim]
    x = _c64(7, shape).astype(np.complex128)
    for backend in BACKENDS:
        plan = plan_fft(shape, mesh, ndim=ndim, backend=backend, dtype=torch.complex128)
        y = plan.execute(torch.from_numpy(x)).numpy()
        assert y.dtype == np.complex128
        assert _rel(y, _oracle(x, ndim)) < 1e-12
        z = plan.inverse(torch.from_numpy(y)).numpy()
        assert np.abs(z - x).max() < 1e-12


@pytest.mark.parametrize("p", [2, 4])
def test_plan_options(p):
    mesh = SimMesh(p, device="cpu")
    x = _c64(3, (2, 16, 32))
    sub = plan_fft(x.shape, mesh, backend="scatter", pipeline=4 * p, local_impl="kernel")
    assert sub.fused and sub.n_chunks == 4 * p
    assert _rel(sub.execute(torch.from_numpy(x)).numpy(), _oracle(x, 2)) < 5e-5
    tb = plan_fft(x.shape, mesh, backend="pairwise_xor", transpose_back=True)
    assert _rel(tb.execute(torch.from_numpy(x)).numpy(), np.fft.fft2(x)) < 5e-5
    inv = plan_fft(x.shape, mesh, backend="scatter", direction="inverse")
    y = inv.execute(torch.from_numpy(x)).numpy()
    assert _rel(y, _oracle(x, 2, inverse=True)) < 5e-5
    ref = plan_fft(x.shape, mesh, backend="xla_auto")
    assert _rel(ref.execute(torch.from_numpy(x)).numpy(), _oracle(x, 2)) < 5e-5
    auto = plan_fft(x.shape, mesh)
    assert auto.predict()[auto.backend] == min(auto.predict().values())
    assert auto.schedule_hash() in auto.describe()
    assert auto.comm_bytes() == pytest.approx(x.size / p * 8 * (1 - 1 / p))  # one exchange


@pytest.mark.parametrize("p", [1, 4])
def test_functional_entry_points(p):
    from repro_torch.core import FFTConfig, fft1d_large, fft2, fft3, ifft2, reference_fft2

    mesh = SimMesh(p, device="cpu")
    fused = FFTConfig(strategy="scatter", local_impl="kernel", fused=True, n_chunks=2 * p)
    x = torch.from_numpy(_c64(11, (2, 16, 32)))
    assert _rel(fft2(x, mesh, "model", fused).numpy(), _oracle(x.numpy(), 2)) < 5e-5
    y = fft2(x, mesh, "model", FFTConfig(transpose_back=True))
    assert _rel(y.numpy(), reference_fft2(x).numpy()) < 5e-5
    assert _rel(ifft2(y, mesh, "model", FFTConfig(transpose_back=True)).numpy(), x.numpy()) < 5e-5
    x3 = torch.from_numpy(_c64(12, (8, 4, 8)))
    assert _rel(fft3(x3, mesh, "model", fused).numpy(), _oracle(x3.numpy(), 3)) < 5e-5
    x1 = torch.from_numpy(_c64(13, (512,)))
    assert _rel(fft1d_large(x1, mesh, "model", fused, rows=4 * p).numpy(), np.fft.fft(x1.numpy())) < 5e-5
    with pytest.raises(ValueError, match="fused requires a chunk-streaming backend"):
        fft2(x, mesh, "model", FFTConfig(strategy="alltoall", fused=True))


def test_plan_errors_name_the_axis_and_the_roadmap_item():
    mesh = SimMesh(4, device="cpu")
    with pytest.raises(ValueError, match=r"slab fft2: data axis -2 \(global size 10\)"):
        plan_fft((10, 16), mesh)
    with pytest.raises(ValueError, match="does not support P=3"):
        plan_fft((12, 12), SimMesh(3, device="cpu"), backend="pairwise_xor")
    with pytest.raises(ValueError, match="pipeline must be"):
        plan_fft((16, 16), mesh, pipeline="fast")
    with pytest.raises(NotImplementedError, match="1-D large inverse"):
        plan_fft((64,), mesh, ndim=1, direction="inverse")
    with pytest.raises(NotImplementedError, match="1-D real transform"):
        plan_fft((64,), mesh, ndim=1, real=True)
    grid = SimMesh((2, 2), axis_names=("rows", "cols"), device="cpu")
    # faults= (ROADMAP A12, ported): the chaos hook fires at the Exchange it names
    from repro_torch.runtime import FaultPlan, InjectedFault

    fp = FaultPlan.error(match="Exchange")
    chaos = plan_fft((16, 16), mesh, faults=fp)
    with pytest.raises(InjectedFault, match=r"Exchange\(slab:model"):
        chaos.execute(torch.zeros(16, 16, dtype=torch.complex64))
    assert chaos.faults is fp and fp.injected == 1 and not fp.active()
    # decomp="pencil" / "auto" (ROADMAP A8) plan: pencil on a grid, slab on one axis
    for kwargs, decomp in ((dict(decomp="pencil"), "pencil"), (dict(decomp="auto"), "pencil"),
                           (dict(decomp="pencil", real=True), "pencil")):
        assert plan_fft((16, 16), grid, **kwargs).decomp == decomp
    assert plan_fft((16, 16), mesh, decomp="auto").decomp == "slab"
    with pytest.raises(ValueError, match=">= 2 axes"):
        plan_fft((16, 16), mesh, decomp="pencil")


# ---------------------------------------------------------------------------
# Identity with the reference's plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS + ("bisection", "xla_auto"))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_schedule_hash_and_comm_bytes_match_reference_p1(ndim, backend):
    """Reference plans on the one in-process jax device (P = 1)."""
    from repro.core import plan_fft as ref_plan_fft
    from repro.core.compat import make_mesh_1d

    shape = SHAPES[ndim]
    for pipeline in ("auto", False, 8):
        mine = plan_fft(shape, SimMesh(1, device="cpu"), ndim=ndim, backend=backend, pipeline=pipeline)
        theirs = ref_plan_fft(shape, make_mesh_1d(1), ndim=ndim, backend=backend, pipeline=pipeline)
        assert mine.schedule_hash() == theirs.schedule_hash()
        assert mine.comm_bytes() == theirs.comm_bytes()
        if ndim > 1:
            assert mine.schedule_hash(inverse=True) == theirs.schedule_hash(inverse=True)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_schedule_hash_matches_reference_builder(p):
    """The reference Plan lowers through build_schedule with its resolved
    pipeline; the port's Plan must produce the same schedule (the P = 4
    subprocess below checks real reference plans too)."""
    import repro.core.schedule as ref_sch

    for ndim in (1, 2, 3):
        shape = SHAPES[ndim]
        for backend in BACKENDS:
            for pipeline in ("auto", False, 3 * p):
                mine = plan_fft(shape, SimMesh(p, device="cpu"), ndim=ndim, backend=backend, pipeline=pipeline)
                theirs = ref_sch.build_schedule(
                    shape, ndim=ndim, decomp="slab", axis_name="model", p=p, backend=backend,
                    fused=mine.fused, n_chunks=mine.n_chunks,
                )
                assert mine.schedule_hash() == theirs.schedule_hash()
                assert mine.comm_bytes() == ref_sch.schedule_comm_bytes(theirs, 8, 8)
                prm = CommParams(alpha_s=2e-6, beta_bytes_s=100e9)
                assert sch.predict_seconds(mine.schedule(), prm, 1e-6, 8, 8) == pytest.approx(
                    ref_sch.predict_seconds(theirs, prm, 1e-6, 8, 8), rel=0, abs=0)


REF_PLANS_CODE = r"""
import json
import numpy as np
import jax.numpy as jnp
from repro.core import plan_fft
from repro.core.compat import make_mesh_1d

mesh = make_mesh_1d(4)
out = []
for c in json.loads(__CASES__):
    r = np.random.default_rng(c["seed"])
    shape = tuple(c["shape"])
    x = (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)
    plan = plan_fft(shape, mesh, ndim=c["ndim"], backend=c["backend"], pipeline=c["pipeline"],
                    transpose_back=c["tb"], local_impl="matmul")
    y = np.asarray(plan.execute(jnp.asarray(x)))
    out.append(dict(hash=plan.schedule_hash(), comm=plan.comm_bytes(), fused=plan.fused,
                    re=y.real.ravel().tolist(), im=y.imag.ravel().tolist()))
print("RESULT " + json.dumps(out))
"""

REF_CASES = [
    dict(shape=[8, 16], ndim=2, backend="scatter", pipeline="auto", tb=False, seed=1),
    dict(shape=[2, 8, 16], ndim=2, backend="alltoall", pipeline=False, tb=True, seed=2),
    dict(shape=[8, 4, 4], ndim=3, backend="pairwise_xor", pipeline="auto", tb=False, seed=3),
    dict(shape=[256], ndim=1, backend="scatter", pipeline=8, tb=False, seed=4),
    dict(shape=[16, 16], ndim=2, backend="bisection", pipeline="auto", tb=False, seed=5),
    dict(shape=[32, 32], ndim=2, backend="xla_auto", pipeline="auto", tb=False, seed=6),
]


def test_port_matches_reference_plans_4dev():
    """Reference plans at P = 4 on forced host devices; the port, on the
    same numpy inputs, must give the same schedule hash, comm bytes,
    fusion and (to c64 tolerance) the same output."""
    code = REF_PLANS_CODE.replace("__CASES__", repr(json.dumps(REF_CASES)))
    line = [ln for ln in run_subprocess(code, devices=4).splitlines() if ln.startswith("RESULT ")][-1]
    results = json.loads(line[len("RESULT "):])
    mesh = SimMesh(4, device="cpu")
    for c, res in zip(REF_CASES, results):
        r = np.random.default_rng(c["seed"])
        shape = tuple(c["shape"])
        x = (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)
        for impl in ("matmul", "kernel"):
            plan = plan_fft(shape, mesh, ndim=c["ndim"], backend=c["backend"], pipeline=c["pipeline"],
                            transpose_back=c["tb"], local_impl=impl)
            assert plan.schedule_hash() == res["hash"], c
            assert plan.comm_bytes() == res["comm"], c
            assert plan.fused == res["fused"], c
            y = plan.execute(torch.from_numpy(x)).numpy().ravel()
            exp = np.asarray(res["re"]) + 1j * np.asarray(res["im"])
            assert _rel(y, exp) < 5e-5, (c, impl)
