"""The port's slab r2c/c2r (repro_torch.core.real through plan_fft) at
P = 1, 2, 4 on SimMesh(device="cpu"), against the reference's
repro.core.real plans on the same numpy input (one subprocess over 4
forced host devices, meshes over the first P of them, x64 enabled) and
numpy.fft.rfftn: the spectrum in its padded layout, the inverse round
trip, the schedule hash, the wire bytes and the Hermitian lengths.
Shapes are tests/test_real.py's, odd batch and odd last axis included.
The reference runs local_impl="matmul" (float32) or "jnp" (float64):
its Pallas impl fails inside a plan (ROADMAP queue C). The port runs
its kernel impl (the kernels' plain versions on the CPU) for float32
and the library impl for float64, whose c2c kernels are complex64."""

import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import FFTConfig, SimMesh, irfft2, irfft3, plan_fft, rfft2, rfft3
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

TOL = {"float32": 1e-4, "float64": 1e-10}  # relative to the oracle's max


def _cases():
    cases = []
    for p in (1, 2, 4):
        def add(shape, ndim=2, backend="scatter", pipeline="auto", tb=False, dtype="float32", pad=True):
            cases.append(dict(p=p, shape=list(shape), ndim=ndim, backend=backend, pipeline=pipeline,
                              tb=tb, dtype=dtype, pad=pad, seed=len(cases)))

        for backend in ("scatter", "alltoall", "pairwise_xor", "bisection"):
            add((64, 64), backend=backend)
        add((64, 64), tb=True)
        add((64, 64), backend="alltoall", pipeline=False, tb=True)
        add((64, 64), pipeline=3 * p)
        add((5, 16, 16))
        add((24, 9), backend="alltoall", tb=True)
        add((64, 64), tb=True, dtype="float64")
        add((16, 8, 8), ndim=3)
        add((3, 16, 8, 8), ndim=3, backend="pairwise_xor")
        add((16, 8, 10), ndim=3, dtype="float64")
        add((16, 7, 6), ndim=3, backend="alltoall")
        add((64, 126), pad=False)
    return cases


CASES = _cases()


def _input(c):
    return np.random.default_rng(c["seed"]).standard_normal(c["shape"]).astype(c["dtype"])


def _case_id(c):
    return (f"P{c['p']}-{'x'.join(map(str, c['shape']))}-{c['backend']}-{c['pipeline']}"
            f"{'-tb' if c['tb'] else ''}-{c['dtype']}{'' if c['pad'] else '-nopad'}")


REF_CODE = r"""
import json
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import plan_fft

out = []
for c in json.loads(__CASES__):
    x = np.random.default_rng(c["seed"]).standard_normal(c["shape"]).astype(c["dtype"])
    mesh = Mesh(np.array(jax.devices()[: c["p"]]), ("model",))
    plan = plan_fft(tuple(c["shape"]), mesh, ndim=c["ndim"], real=True, backend=c["backend"],
                    pipeline=c["pipeline"], transpose_back=c["tb"], pad=c["pad"],
                    dtype=jnp.dtype(c["dtype"]),
                    local_impl="jnp" if c["dtype"] == "float64" else "matmul")
    y = plan.execute(jnp.asarray(x))
    z = np.asarray(plan.inverse(y))
    y = np.asarray(y)
    out.append(dict(hash=plan.schedule_hash(), inv_hash=plan.schedule_hash(inverse=True),
                    comm=plan.comm_bytes(), h=plan.hermitian_len, hp=plan.padded_hermitian_len,
                    ydtype=str(y.dtype), zdtype=str(z.dtype), shape=list(y.shape),
                    re=y.real.ravel().tolist(), im=y.imag.ravel().tolist(), z=z.ravel().tolist()))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    code = REF_CODE.replace("__CASES__", repr(json.dumps(CASES)))
    line = [ln for ln in run_subprocess(code, devices=4).splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _numpy_spectrum(x, c, h, hp):
    """numpy.fft.rfftn in the plan's spectrum layout (slab rfft2 without
    transpose_back: transposed, Hermitian rows zero-padded to hp)."""
    if c["ndim"] == 3:
        return np.fft.rfftn(x, axes=(-3, -2, -1))
    y = np.fft.rfft2(x)
    if c["tb"]:
        return y
    y = np.swapaxes(y, -1, -2)
    return np.concatenate([y, np.zeros(y.shape[:-2] + (hp - h, y.shape[-1]), y.dtype)], axis=-2)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_case_id(c) for c in CASES])
def test_real_plan_matches_reference_and_numpy(reference, i):
    c, ref = CASES[i], reference[i]
    x = _input(c)
    tol = TOL[c["dtype"]]
    plan = plan_fft(tuple(c["shape"]), SimMesh(c["p"], device="cpu"), ndim=c["ndim"], real=True,
                    backend=c["backend"], pipeline=c["pipeline"], transpose_back=c["tb"], pad=c["pad"],
                    dtype=getattr(torch, c["dtype"]),
                    local_impl="torch" if c["dtype"] == "float64" else "kernel")
    assert plan.schedule_hash() == ref["hash"] and plan.schedule_hash(inverse=True) == ref["inv_hash"]
    assert plan.comm_bytes() == ref["comm"]
    assert (plan.hermitian_len, plan.padded_hermitian_len) == (ref["h"], ref["hp"])

    y = plan.execute(torch.from_numpy(x))
    assert list(y.shape) == ref["shape"] and tuple(y.shape) == plan.spectrum_shape()
    assert str(y.dtype).replace("torch.", "") == ref["ydtype"]
    exp = _numpy_spectrum(x.astype(np.float64), c, plan.hermitian_len, plan.padded_hermitian_len)
    scale = np.abs(exp).max()
    got = y.numpy()
    theirs = (np.asarray(ref["re"]) + 1j * np.asarray(ref["im"])).reshape(ref["shape"])
    assert np.abs(got - exp).max() <= tol * scale
    assert np.abs(got - theirs).max() <= tol * scale
    if not c["tb"] and c["ndim"] == 2:
        assert not got[..., plan.hermitian_len:, :].any()  # the pad rows are exactly zero

    z = plan.inverse(y)
    assert str(z.dtype).replace("torch.", "") == ref["zdtype"] == c["dtype"]
    assert np.abs(z.numpy() - x).max() <= tol * np.abs(x).max()
    assert np.abs(z.numpy().ravel() - np.asarray(ref["z"])).max() <= tol * np.abs(x).max()


@pytest.mark.parametrize("p", [2, 4])
def test_functional_entry_points_match_plans(p):
    mesh = SimMesh(p, device="cpu")
    x2 = torch.from_numpy(np.random.default_rng(p).standard_normal((3, 8 * p, 9)).astype(np.float32))
    x3 = torch.from_numpy(np.random.default_rng(p + 1).standard_normal((4 * p, 5, 7)).astype(np.float32))
    for backend, fused, tb in (("scatter", True, False), ("alltoall", False, True), ("pairwise_xor", True, True)):
        cfg = FFTConfig(strategy=backend, fused=fused, transpose_back=tb, local_impl="kernel")
        plan = plan_fft(tuple(x2.shape), mesh, real=True, backend=backend, transpose_back=tb,
                        pipeline="auto" if fused else False, local_impl="kernel")
        y = rfft2(x2, mesh, "model", cfg)
        assert torch.equal(y, plan.execute(x2))
        assert torch.equal(irfft2(y, mesh, "model", cfg, n_last=9), plan.inverse(y))
        plan3 = plan_fft(tuple(x3.shape), mesh, ndim=3, real=True, backend=backend,
                         pipeline="auto" if fused else False, local_impl="kernel")
        y3 = rfft3(x3, mesh, "model", cfg)
        assert torch.equal(y3, plan3.execute(x3))
        assert torch.equal(irfft3(y3, mesh, "model", cfg, n_last=7), plan3.inverse(y3))
    with pytest.raises(ValueError, match="irfft2 needs n_last"):
        irfft2(y, mesh, "model", cfg)
    with pytest.raises(ValueError, match="do not match the rfft2 layout"):
        irfft2(y, mesh, "model", cfg, n_last=12)
    with pytest.raises(ValueError, match="Hermitian axis has length 4, expected 10//2\\+1=6"):
        irfft3(y3, mesh, "model", cfg, n_last=10)


@pytest.mark.parametrize(
    "shape,ndim,p",
    [((64, 64), 2, 8), ((16, 7, 6), 3, 8), ((10, 16), 2, 4), ((6, 4, 4), 3, 4)],
)
def test_pad_false_errors_name_the_axis_and_mesh_dim(shape, ndim, p):
    """pad=False on a non-divisible Hermitian axis (and a non-divisible
    data axis either way) fails at plan time with the reference's
    message, which names the data axis and the mesh dimension."""
    import repro.core.schedule as ref_sch

    with pytest.raises(ValueError) as theirs:
        ref_sch.check_divisible(shape, ndim, p=p, axis_name="model", real=True, pad=False)
    with pytest.raises(ValueError) as mine:
        plan_fft(shape, SimMesh(p, device="cpu"), ndim=ndim, real=True, pad=False)
    msg = str(mine.value)
    assert msg == str(theirs.value)
    assert f"P={p}" in msg and "'model'" in msg
    assert any(s in msg for s in ("Hermitian axis -1", "flattened axes (-2,-1)", "data axis -2", "data axis -3"))


def test_padded_lengths_match_reference():
    import repro.core.real as ref_real

    from repro_torch.core import real

    for n in (6, 7, 8, 9, 10, 126, 16384):
        for mult in (1, 2, 3, 4, 8):
            for weight in (1, 3, 7):
                assert real.padded_rfft_len(n, mult, weight) == ref_real.padded_rfft_len(n, mult, weight)
        assert real.rfft_len(n) == ref_real.rfft_len(n)
        assert real._pad_disabled_hint(n, 4, 3) == ref_real._pad_disabled_hint(n, 4, 3)
    assert real.check_divisible_slab((64, 64), 8, 2, "model") == ref_real.check_divisible_slab((64, 64), 8, 2, "model")


def test_c64_against_c128():
    """float32 plans give complex64 spectra at ~1e-6, float64 plans
    complex128 at ~1e-15, through the same schedule."""
    x = np.random.default_rng(11).standard_normal((3, 16, 8, 10))
    mesh = SimMesh(4, device="cpu")
    exp = np.fft.rfftn(x, axes=(-3, -2, -1))
    errs = {}
    for dt in ("float32", "float64"):
        plan = plan_fft(x.shape, mesh, ndim=3, real=True, dtype=getattr(torch, dt), backend="scatter")
        y = plan.execute(torch.from_numpy(x.astype(dt)))
        assert y.dtype == (torch.complex64 if dt == "float32" else torch.complex128)
        errs[dt] = np.abs(y.numpy() - exp).max() / np.abs(exp).max()
        assert errs[dt] <= TOL[dt]
        assert plan.inverse(y).dtype == getattr(torch, dt)
    assert errs["float64"] < 1e-6 * errs["float32"]
    with pytest.raises(ValueError, match="real plans take a real input dtype"):
        plan_fft((16, 16), mesh, real=True, dtype=torch.int32)


def test_spectral_axes_contract_matches_reference():
    """The layout contract the apps build on, against the reference's
    plans on its one in-process device (P = 1), and the padding where
    the axis stays sharded at P = 4."""
    import jax.numpy as jnp

    from repro.core import plan_fft as ref_plan_fft
    from repro.core.compat import make_mesh_1d

    from repro.core import comm_model as ref_cm

    from repro_torch.core import CommParams

    for shape, ndim, tb in (((8, 10), 2, False), ((8, 10), 2, True), ((4, 6, 8), 3, False), ((3, 8, 9), 2, False)):
        for real in (False, True):
            dt = torch.float32 if real else torch.complex64
            kw = dict(ndim=ndim, real=real, transpose_back=tb, chunk_compute_s=1e-6)
            mine = plan_fft(shape, SimMesh(1, device="cpu"), dtype=dt, params=CommParams(2e-6, 100e9), **kw)
            theirs = ref_plan_fft(shape, make_mesh_1d(1), dtype=jnp.float32 if real else jnp.complex64,
                                  params=ref_cm.CommParams(2e-6, 100e9), **kw)
            assert [tuple(a) for a in mine.spectral_axes()] == [tuple(a) for a in theirs.spectral_axes()]
            assert mine.spectrum_shape() == theirs.spectrum_shape()
            assert mine.comm_bytes() == theirs.comm_bytes()
            assert mine.local_bytes() == theirs.local_bytes()
            assert mine.predict() == theirs.predict()
    plan = plan_fft((8, 10), SimMesh(4, device="cpu"), real=True)
    assert plan.spectrum_shape() == (8, 8) and plan.spectral_axes()[0].n_out == 8  # H = 6 padded to 8
    assert plan_fft((8, 10), SimMesh(4, device="cpu"), real=True, transpose_back=True).spectrum_shape() == (8, 6)
    with pytest.raises(NotImplementedError, match="1-D real transform"):
        plan_fft((64,), SimMesh(4, device="cpu"), ndim=1, real=True)
