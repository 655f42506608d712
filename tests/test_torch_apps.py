"""The port's spectral apps (repro_torch.apps) against the reference's
repro.apps and the analytic / numpy oracles of tests/test_apps.py: the
Poisson solve, the spectral gradient and laplacian, FFT convolution and
correlation, and the wavenumber grids, through c2c and r2c slab plans
(natural and transposed spectrum layouts) and pencil plans on SimMesh
grids (natural 2-D, reversed 3-D, the Hermitian axis padded over the
grid; against the reference's pencil plans on a 1x1 grid). The port runs on
SimMesh(P, device="cpu") at P = 1 and 4 with the scatter backend and
the kernel impl (the kernels' plain versions on the CPU); the reference
runs on its one in-process device -- the apps' outputs are physical
fields, the same whatever the shard count."""

import numpy as np
import pytest
import torch

from repro_torch.apps import fft_convolve, fft_correlate, gradient, laplacian, solve_poisson, wavenumbers
from repro_torch.core import SimMesh, plan_fft
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

PS = (1, 4)
LAYOUTS = {  # name -> plan_fft kwargs, the slab plans of tests/test_apps.py (and c2c transposed back)
    "slab-c2c": dict(),
    "slab-c2c-tb": dict(transpose_back=True),
    "slab-r2c": dict(real=True),
    "slab-r2c-tb": dict(real=True, transpose_back=True),
}
REF_TOL = 1e-4  # port vs reference, relative to the reference's max (float32 both)


def _grid2(n):
    xs = np.arange(n) * 2 * np.pi / n
    return np.meshgrid(xs, xs, indexing="ij")


def _plans(shape, p, ndim=2):
    mesh = SimMesh(p, device="cpu")
    return {name: plan_fft(shape, mesh, ndim=ndim, backend="scatter", local_impl="kernel", **kw)
            for name, kw in LAYOUTS.items()}


def _ref_plan(shape, ndim=2, **kw):
    from repro.core import plan_fft as ref_plan_fft
    from repro.core.compat import make_mesh

    return ref_plan_fft(shape, make_mesh((1,), ("model",)), ndim=ndim, **kw)


def _cast(a, plan):
    return torch.from_numpy(a.astype(np.float32) if plan.real else a.astype(np.complex64))


def _ref_run(app, *arrays, plan_kw, shape, ndim=2, **kw):
    """The reference app on its own plan of the same kind; real output."""
    import jax.numpy as jnp

    import repro.apps as ref_apps

    plan = _ref_plan(shape, ndim, **plan_kw)
    dt = np.float32 if plan.real else np.complex64
    out = getattr(ref_apps, app)(*[jnp.asarray(a.astype(dt)) for a in arrays], plan, **kw)
    if isinstance(out, tuple):
        return [np.real(np.asarray(o)) for o in out]
    return np.real(np.asarray(out))


def _close_to_ref(got, ref):
    assert np.abs(got - ref).max() <= REF_TOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("p", PS)
def test_poisson_2d_all_layouts(p):
    n = 32
    X, Y = _grid2(n)
    u0 = np.sin(X) * np.cos(2 * Y)  # zero mean
    f = -(1 + 4) * u0
    for name, plan in _plans((n, n), p).items():
        u = np.real(solve_poisson(_cast(f, plan), plan).numpy())
        assert np.abs(u - u0).max() < 1e-4, name
        _close_to_ref(u, _ref_run("solve_poisson", f, plan_kw=LAYOUTS[name], shape=(n, n)))


@pytest.mark.parametrize("p", PS)
def test_poisson_nonunit_lengths(p):
    n = 64
    L = (4.0, 8.0)
    xs = np.arange(n) * L[0] / n
    ys = np.arange(n) * L[1] / n
    X, _ = np.meshgrid(xs, ys, indexing="ij")
    k0 = 2 * np.pi / L[0]
    u0 = np.sin(2 * k0 * X)
    f = -((2 * k0) ** 2) * u0
    plan = plan_fft((n, n), SimMesh(p, device="cpu"), real=True, backend="scatter", local_impl="kernel")
    u = solve_poisson(torch.from_numpy(f.astype(np.float32)), plan, lengths=L).numpy()
    assert u.dtype == np.float32 and np.abs(u - u0).max() < 1e-3
    _close_to_ref(u, _ref_run("solve_poisson", f, plan_kw=dict(real=True), shape=(n, n), lengths=L))


@pytest.mark.parametrize("p", PS)
def test_poisson_3d_batched(p):
    """Slab rfft3 / fft3 with an odd batch dim: each batch entry solved
    on its own."""
    n = 16
    xs = np.arange(n) * 2 * np.pi / n
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    u0 = np.stack([np.sin(X) * np.cos(Y) * np.sin(2 * Z), np.cos(3 * X) * np.sin(Z), np.sin(Y)])
    lap = np.array([6.0, 10.0, 1.0])[:, None, None, None]
    f = -lap * u0
    mesh = SimMesh(p, device="cpu")
    for real in (False, True):
        plan = plan_fft(f.shape, mesh, ndim=3, real=real, backend="scatter", local_impl="kernel")
        u = np.real(solve_poisson(_cast(f, plan), plan).numpy())
        assert np.abs(u - u0).max() < 1e-4, real
        _close_to_ref(u, _ref_run("solve_poisson", f, plan_kw=dict(real=real), shape=f.shape, ndim=3))


@pytest.mark.parametrize("p", PS)
def test_gradient_laplacian(p):
    n = 32
    X, Y = _grid2(n)
    u = np.sin(X) * np.cos(3 * Y)
    dux = np.cos(X) * np.cos(3 * Y)
    duy = -3 * np.sin(X) * np.sin(3 * Y)
    lap = -(1 + 9) * u
    for name, plan in _plans((n, n), p).items():
        gx, gy = gradient(_cast(u, plan), plan)
        gx, gy = np.real(gx.numpy()), np.real(gy.numpy())
        assert np.abs(gx - dux).max() < 1e-4, name
        assert np.abs(gy - duy).max() < 1e-4, name
        rx, ry = _ref_run("gradient", u, plan_kw=LAYOUTS[name], shape=(n, n))
        _close_to_ref(gx, rx)
        _close_to_ref(gy, ry)
        lp = np.real(laplacian(_cast(u, plan), plan).numpy())
        assert np.abs(lp - lap).max() < 1e-3, name
        _close_to_ref(lp, _ref_run("laplacian", u, plan_kw=LAYOUTS[name], shape=(n, n)))


@pytest.mark.parametrize("p", PS)
def test_convolve_correlate_vs_numpy(p):
    n = 16
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref_cv = np.real(np.fft.ifft2(np.fft.fft2(a) * np.fft.fft2(b)))
    ref_cr = np.real(np.fft.ifft2(np.fft.fft2(a) * np.conj(np.fft.fft2(b))))
    for name, plan in _plans((n, n), p).items():
        cv = np.real(fft_convolve(_cast(a, plan), _cast(b, plan), plan).numpy())
        cr = np.real(fft_correlate(_cast(a, plan), _cast(b, plan), plan).numpy())
        assert np.abs(cv - ref_cv).max() < 1e-3 * np.abs(ref_cv).max(), name
        assert np.abs(cr - ref_cr).max() < 1e-3 * np.abs(ref_cr).max(), name
        _close_to_ref(cv, _ref_run("fft_convolve", a, b, plan_kw=LAYOUTS[name], shape=(n, n)))
        _close_to_ref(cr, _ref_run("fft_correlate", a, b, plan_kw=LAYOUTS[name], shape=(n, n)))
    plan = _plans((n, n), p)["slab-r2c"]
    with pytest.raises(ValueError, match="share a shape"):
        fft_convolve(torch.zeros((n, n)), torch.zeros((n, 2 * n)), plan)


def test_wavenumbers_layouts():
    """k-grids land at the right output positions in the transposed and
    Hermitian-padded layouts, equal to the reference's where the
    reference shares the layout (P = 1)."""
    import repro.apps as ref_apps

    plan = plan_fft((8, 10), SimMesh(1, device="cpu"), real=True)  # spectrum (6, 8): (half C, R)
    kx, ky = wavenumbers(plan)
    assert kx.shape == (1, 8) and ky.shape == (6, 1)  # kx = orig axis -2 (R)
    assert float(ky[-1, 0]) == 5.0 and kx.dtype == torch.float32  # rfftfreq top mode of n=10
    np.testing.assert_allclose(kx.numpy().ravel(), np.fft.fftfreq(8) * 8, atol=1e-6)
    for (mine, theirs) in zip(wavenumbers(plan, (1.0, 3.0)), ref_apps.wavenumbers(_ref_plan((8, 10), real=True),
                                                                                  (1.0, 3.0))):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    padded = plan_fft((8, 10), SimMesh(4, device="cpu"), real=True)  # H = 6 padded to 8
    _, ky4 = wavenumbers(padded)
    assert ky4.shape == (8, 1) and not ky4[6:].any()  # padded Hermitian rows get k = 0
    plan3 = plan_fft((4, 6, 8), SimMesh(2, device="cpu"), ndim=3, real=True, dtype=torch.float64)
    k0, k1, k2 = wavenumbers(plan3)  # natural slab layout, ordered by original axis
    assert k0.shape == (4, 1, 1) and k1.shape == (1, 6, 1) and k2.shape == (1, 1, 5)
    assert k0.dtype == torch.float64
    with pytest.raises(ValueError, match="lengths"):
        wavenumbers(plan3, lengths=(1.0, 2.0))


# ---------------------------------------------------------------------------
# Pencil plans: natural 2-D layout, reversed 3-D layout, Hermitian axis
# padded over the grid
# ---------------------------------------------------------------------------

GRIDS = ((1, 1), (2, 2), (2, 4))
PENCIL_LAYOUTS = {  # name -> plan_fft kwargs on a ("rows", "cols") grid
    "pencil-c2c": dict(decomp="pencil"),
    "pencil-r2c": dict(decomp="pencil", real=True),
}
PENCIL3_LAYOUTS = {**PENCIL_LAYOUTS, "pencil-c2c-tb": dict(decomp="pencil", transpose_back=True),
                   "pencil-r2c-tb": dict(decomp="pencil", real=True, transpose_back=True)}


def _grid_plans(shape, grid, layouts, ndim=2):
    mesh = SimMesh(grid, axis_names=("rows", "cols"), device="cpu")
    return {name: plan_fft(shape, mesh, ndim=ndim, backend=("scatter", "pairwise_xor"), local_impl="kernel", **kw)
            for name, kw in layouts.items()}


def _ref_grid_run(app, *arrays, plan_kw, shape, ndim=2):
    """The reference app on a pencil plan over its one in-process device
    (a 1x1 grid); real output."""
    import jax.numpy as jnp

    import repro.apps as ref_apps
    from repro.core import plan_fft as ref_plan_fft
    from repro.core.compat import make_mesh

    plan = ref_plan_fft(shape, make_mesh((1, 1), ("rows", "cols")), ndim=ndim, **plan_kw)
    dt = np.float32 if plan.real else np.complex64
    out = getattr(ref_apps, app)(*[jnp.asarray(a.astype(dt)) for a in arrays], plan)
    if isinstance(out, tuple):
        return [np.real(np.asarray(o)) for o in out]
    return np.real(np.asarray(out))


@pytest.mark.parametrize("grid", GRIDS)
def test_poisson_pencil_2d_and_3d(grid):
    n = 16
    X, Y = _grid2(n)
    u0 = np.sin(X) * np.cos(2 * Y)
    for name, plan in _grid_plans((n, n), grid, PENCIL_LAYOUTS).items():
        u = np.real(solve_poisson(_cast(-5 * u0, plan), plan).numpy())
        assert np.abs(u - u0).max() < 1e-4, name
        if grid == (1, 1):
            _close_to_ref(u, _ref_grid_run("solve_poisson", -5 * u0, plan_kw=PENCIL_LAYOUTS[name], shape=(n, n)))
    n3 = 8
    xs = np.arange(n3) * 2 * np.pi / n3
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    u3 = np.sin(X) * np.cos(2 * Y) * np.sin(3 * Z)
    for name, plan in _grid_plans((n3,) * 3, grid, PENCIL3_LAYOUTS, ndim=3).items():
        u = np.real(solve_poisson(_cast(-14 * u3, plan), plan).numpy())
        assert np.abs(u - u3).max() < 1e-4, name


@pytest.mark.parametrize("grid", GRIDS)
def test_gradient_laplacian_convolve_pencil(grid):
    n = 16
    X, Y = _grid2(n)
    u = np.sin(X) * np.cos(3 * Y)
    rng = np.random.default_rng(4)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref_cv = np.real(np.fft.ifft2(np.fft.fft2(a) * np.fft.fft2(b)))
    for name, plan in _grid_plans((n, n), grid, PENCIL_LAYOUTS).items():
        gx, gy = (np.real(g.numpy()) for g in gradient(_cast(u, plan), plan))
        assert np.abs(gx - np.cos(X) * np.cos(3 * Y)).max() < 1e-4, name
        assert np.abs(gy + 3 * np.sin(X) * np.sin(3 * Y)).max() < 1e-4, name
        assert np.abs(np.real(laplacian(_cast(u, plan), plan).numpy()) + 10 * u).max() < 1e-3, name
        cv = np.real(fft_convolve(_cast(a, plan), _cast(b, plan), plan).numpy())
        assert np.abs(cv - ref_cv).max() < 1e-3 * np.abs(ref_cv).max(), name
        if grid == (1, 1):
            _close_to_ref(cv, _ref_grid_run("fft_convolve", a, b, plan_kw=PENCIL_LAYOUTS[name], shape=(n, n)))
    # the 3-D gradient in the reversed layout, one component per original axis
    n3 = 8
    xs = np.arange(n3) * 2 * np.pi / n3
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    u3 = np.sin(X) * np.cos(Y) * np.sin(2 * Z)
    plan = _grid_plans((n3,) * 3, grid, {"r": dict(decomp="pencil", real=True)}, ndim=3)["r"]
    g0, g1, g2 = (g.numpy() for g in gradient(_cast(u3, plan), plan))
    assert np.abs(g0 - np.cos(X) * np.cos(Y) * np.sin(2 * Z)).max() < 1e-4
    assert np.abs(g1 + np.sin(X) * np.sin(Y) * np.sin(2 * Z)).max() < 1e-4
    assert np.abs(g2 - 2 * np.sin(X) * np.cos(Y) * np.cos(2 * Z)).max() < 1e-4


def test_wavenumbers_pencil_layouts():
    """The reversed 3-D layout puts axis -1's wavenumbers first, padded
    over P_col; the natural 2-D layout pads the last axis over the grid."""
    mesh = SimMesh((2, 4), axis_names=("rows", "cols"), device="cpu")
    plan3 = plan_fft((4, 8, 10), mesh, ndim=3, real=True, decomp="pencil")  # spectrum (8, 8, 4): (Hp, D1, D0)
    k0, k1, k2 = wavenumbers(plan3)
    assert k0.shape == (1, 1, 4) and k1.shape == (1, 8, 1) and k2.shape == (8, 1, 1)
    assert float(k2[5, 0, 0]) == 5.0 and not k2[6:].any()  # rfftfreq of n=10, then the P_col pad
    plan2 = plan_fft((8, 12), mesh, real=True, decomp="pencil")  # natural (8, Hp=8): H = 7 padded over 2x4
    kx, ky = wavenumbers(plan2)
    assert kx.shape == (8, 1) and ky.shape == (1, 8) and float(ky[0, 6]) == 6.0 and not ky[0, 7:].any()
