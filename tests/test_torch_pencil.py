"""The port's pencil transforms (repro_torch.core.pencil, the pencil
half of real.py and plan_fft(decomp="pencil")) on SimMesh grids (1,1),
(2,2), (2,4), (4,2) and (1,4) against numpy.fft in the natural or
reversed layout: c2c fft2 / fft3 forward and inverse, fft3 with and
without transpose_back, fused and unfused, per-axis backend pairs
(mixed ones included), the library and the kernel local impls (the
kernels' plain versions on the CPU), and r2c / c2r rfft2 / rfft3 with
the Hermitian axis padded over P_col. Round trips go through
plan.inverse on the layout the forward produced.

One reference subprocess over 8 forced host devices runs the
reference's pencil plans on the (2, 4) and (4, 2) grids
(local_impl="matmul": its Pallas impl fails inside a plan, ROADMAP
queue C); the port must give the same schedule hashes, wire bytes,
predictions, spectrum layout and (within 5e-5) outputs. The reference
is imported only inside tests, so the cuda-marked test at the end also
runs on a machine without jax."""

import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import (
    CommParams, PencilConfig, SimMesh, make_grid, pencil_fft2, pencil_fft3, pencil_irfft2, pencil_irfft3,
    pencil_rfft2, pencil_rfft3, plan_fft,
)
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2), (1, 4)]
PAIRS = [("scatter", "scatter"), ("scatter", "bisection"), ("pairwise_xor", "alltoall"), ("alltoall", "alltoall")]
TOL = 5e-5  # relative to the oracle's max, complex64 / float32
PRM = dict(alpha_s=3e-6, beta_bytes_s=120e9)  # explicit, so both packages price alike
CHUNK_S = 2e-6


def _mesh(grid):
    return SimMesh(grid, axis_names=("rows", "cols"), device="cpu")


def _c64(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


def _f32(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, exp):
    return np.abs(got - exp).max() / np.abs(exp).max()


def _reversed(y):
    """The pencil fft3 output layout: the last three axes reversed."""
    return np.swapaxes(y, -1, -3)


@pytest.mark.parametrize("grid", GRIDS)
def test_pencil_c2c_matches_numpy(grid):
    mesh = _mesh(grid)
    x2, x3 = _c64(1, (2, 16, 32)), _c64(2, (8, 16, 8))
    for pair in PAIRS:
        for impl in ("torch", "kernel"):
            for pipeline in ("auto", False):
                kw = dict(decomp="pencil", backend=pair, local_impl=impl, pipeline=pipeline)
                plan = plan_fft(x2.shape, mesh, **kw)
                assert plan.fused == (pipeline == "auto" and any(
                    b in ("scatter", "pairwise_xor") and p > 1 for b, p in zip(pair, grid)))
                tag = (pair, impl, pipeline)
                y = plan.execute(torch.from_numpy(x2)).numpy()
                assert _rel(y, np.fft.fft2(x2)) < TOL, tag  # natural layout, not transposed
                assert _rel(plan.inverse(torch.from_numpy(y)).numpy(), x2) < TOL, tag
                for tb in (False, True):
                    plan3 = plan_fft(x3.shape, mesh, ndim=3, transpose_back=tb, **kw)
                    y3 = plan3.execute(torch.from_numpy(x3)).numpy()
                    exp = np.fft.fftn(x3)
                    assert _rel(y3, exp if tb else _reversed(exp)) < TOL, (tag, tb)
                    assert _rel(plan3.inverse(torch.from_numpy(y3)).numpy(), x3) < TOL, (tag, tb)
    inv = plan_fft(x3.shape, mesh, ndim=3, decomp="pencil", direction="inverse", backend="scatter")
    assert _rel(inv.execute(torch.from_numpy(x3)).numpy(), _reversed(np.fft.ifftn(x3))) < TOL
    sub = plan_fft(x2.shape, mesh, decomp="pencil", backend="scatter", pipeline=8, local_impl="kernel")
    assert sub.n_chunks == 8 and _rel(sub.execute(torch.from_numpy(x2)).numpy(), np.fft.fft2(x2)) < TOL


@pytest.mark.parametrize("grid", GRIDS)
def test_pencil_real_matches_numpy(grid):
    mesh = _mesh(grid)
    x2, x3 = _f32(3, (3, 16, 24)), _f32(4, (2, 8, 8, 10))
    for pair in (("scatter", "scatter"), ("scatter", "bisection"), ("alltoall", "pairwise_xor")):
        for pipeline in ("auto", False):
            kw = dict(decomp="pencil", real=True, backend=pair, local_impl="kernel", pipeline=pipeline)
            plan = plan_fft(x2.shape, mesh, **kw)
            y = plan.execute(torch.from_numpy(x2)).numpy()
            h = plan.hermitian_len
            assert y.shape == plan.spectrum_shape() and y.shape[-1] == plan.padded_hermitian_len
            assert y.shape[-1] % (grid[0] * grid[1]) == 0  # both sub-rings re-shard the Hermitian axis
            assert _rel(y[..., :h], np.fft.rfft2(x2)) < TOL and not y[..., h:].any()
            assert _rel(plan.inverse(torch.from_numpy(y)).numpy(), x2) < TOL
            for tb in (False, True):
                plan3 = plan_fft(x3.shape, mesh, ndim=3, transpose_back=tb, **kw)
                y3 = plan3.execute(torch.from_numpy(x3)).numpy()
                exp = np.fft.rfftn(x3, axes=(-3, -2, -1))
                assert y3.shape == plan3.spectrum_shape()
                if tb:
                    assert _rel(y3, exp) < TOL
                else:  # reversed, the Hermitian axis padded over P_col and zero there
                    hp = plan3.padded_hermitian_len
                    assert y3.shape[-3] == hp and hp % grid[1] == 0
                    assert _rel(y3[..., : plan3.hermitian_len, :, :], _reversed(exp)) < TOL
                    assert not y3[..., plan3.hermitian_len:, :, :].any()
                assert _rel(plan3.inverse(torch.from_numpy(y3)).numpy(), x3) < TOL


def test_functional_entry_points_match_plans():
    grid = make_grid((2, 4), device="cpu")
    x2, x3, r2, r3 = _c64(5, (16, 32)), _c64(6, (8, 8, 16)), _f32(7, (16, 24)), _f32(8, (8, 8, 10))
    cfg = PencilConfig(backend_row="scatter", backend_col="bisection", local_impl="kernel", fused=True)
    for fn, x, ndim in ((pencil_fft2, x2, 2), (pencil_fft3, x3, 3)):
        plan = plan_fft(x.shape, grid.mesh, ndim=ndim, decomp="pencil", backend=("scatter", "bisection"),
                        local_impl="kernel")
        y = fn(torch.from_numpy(x), grid, cfg)
        assert torch.allclose(y, plan.execute(torch.from_numpy(x)))
        # the functional inverse takes the natural (rows, cols) layout, as the reference's does
        z = fn(torch.from_numpy(x), grid, cfg, inverse=True).numpy()
        exp = np.fft.ifft2(x) if ndim == 2 else _reversed(np.fft.ifftn(x))
        assert _rel(z, exp) < TOL
    tb = PencilConfig(backend_row="pairwise_xor", backend_col="scatter", transpose_back=True)
    assert _rel(pencil_fft3(torch.from_numpy(x3), grid, tb).numpy(), np.fft.fftn(x3)) < TOL
    with pytest.raises(ValueError, match="natural layout"):
        pencil_fft2(torch.from_numpy(x2), grid, tb)
    y = pencil_rfft2(torch.from_numpy(r2), grid, cfg)
    assert y.shape == (16, 16)  # H = 13 padded to a multiple of P_row * P_col = 8
    assert _rel(pencil_irfft2(y, grid, cfg, n_last=24).numpy(), r2) < TOL
    with pytest.raises(ValueError, match="padded 16"):
        pencil_irfft2(y[..., :13], grid, cfg, n_last=24)
    for c in (PencilConfig(transpose_back=True), cfg):
        y3 = pencil_rfft3(torch.from_numpy(r3), grid, c)
        assert tuple(y3.shape) == ((8, 8, 6) if c.transpose_back else (8, 8, 8))  # Hp = 8 over P_col = 4
        assert _rel(pencil_irfft3(y3, grid, c, n_last=10).numpy(), r3) < TOL
    with pytest.raises(ValueError, match="do not match the pencil_rfft3 layout"):
        pencil_irfft3(y3[:6], grid, cfg, n_last=10)
    with pytest.raises(ValueError, match="n_last"):
        pencil_irfft3(y3, grid, cfg)
    with pytest.raises(ValueError, match="whole-transform"):
        pencil_fft2(torch.from_numpy(x2), grid, PencilConfig(backend_row="xla_auto"))


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_schedules_match_reference_builder(grid):
    """Every pencil plan lowers to the reference builder's schedule for
    the same arguments -- the c2c fft3 inverse without transpose_back
    with the grid roles and backends swapped -- and walks to the same
    bytes and predictions."""
    import repro.core.comm_model as ref_cm
    import repro.core.schedule as ref_sch

    import repro_torch.core.schedule as sch

    mesh = _mesh(grid)
    pr, pc = grid
    for ndim, shape, real in ((2, (16, 16), False), (3, (8, 8, 16), False), (2, (16, 24), True),
                              (3, (8, 8, 10), True)):
        for tb in ((False, True) if ndim == 3 else (False,)):
            for pipeline in ("auto", False, 16):
                plan = plan_fft(shape, mesh, ndim=ndim, real=real, decomp="pencil", transpose_back=tb,
                                backend=("scatter", "pairwise_xor"), pipeline=pipeline)
                for inv in (False, True):
                    swap = inv and not real and ndim == 3 and not tb
                    theirs = ref_sch.build_schedule(
                        shape[::-1] if swap else shape, ndim=ndim, inverse=inv, real=real, decomp="pencil",
                        row_axis="cols" if swap else "rows", col_axis="rows" if swap else "cols",
                        p_rows=pc if swap else pr, p_cols=pr if swap else pc,
                        backend_row="pairwise_xor" if swap else "scatter",
                        backend_col="scatter" if swap else "pairwise_xor",
                        fused=plan.fused, n_chunks=plan.n_chunks, transpose_back=tb,
                    )
                    mine = plan.schedule(inv)
                    assert mine.canonical() == theirs.canonical()
                    for items in ((4, 8), (8, 16)):
                        assert sch.schedule_comm_bytes(mine, *items) == ref_sch.schedule_comm_bytes(theirs, *items)
                        got = sch.predict_seconds(mine, CommParams(**PRM), CHUNK_S, *items)
                        assert got == ref_sch.predict_seconds(theirs, ref_cm.CommParams(**PRM), CHUNK_S, *items)
                    specs = sch.simulate_specs(mine, len(mine.global_shape))
                    assert specs == ref_sch.simulate_specs(theirs, len(theirs.global_shape))


REF_CODE = r"""
import json
import numpy as np
import jax.numpy as jnp
from repro.core import CommParams, plan_fft
from repro.core.compat import make_mesh

out = []
for c in json.loads(__CASES__):
    mesh = make_mesh(tuple(c["grid"]), ("rows", "cols"))
    r = np.random.default_rng(c["seed"])
    shape = tuple(c["shape"])
    if c["real"]:
        x = r.standard_normal(shape).astype(np.float32)
    else:
        x = (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)
    backend = c["backend"] if isinstance(c["backend"], str) else tuple(c["backend"])
    plan = plan_fft(shape, mesh, ndim=c["ndim"], real=c["real"], decomp=c["decomp"], backend=backend,
                    transpose_back=c["tb"], pipeline=c["pipeline"], local_impl="matmul",
                    params=CommParams(**c["prm"]), chunk_compute_s=c["chunk_s"])
    y = plan.execute(jnp.asarray(x))
    z = np.asarray(plan.inverse(y))
    y = np.asarray(y)
    res = dict(decomp=plan.decomp, backend=plan.backend, fused=plan.fused, hash=plan.schedule_hash(),
               inv_hash=plan.schedule_hash(inverse=True), comm=plan.comm_bytes(), predict=plan.predict(),
               spectral_axes=[list(a) for a in plan.spectral_axes()], spectrum_shape=list(plan.spectrum_shape()),
               shape=list(y.shape), re=y.real.ravel().tolist(), im=y.imag.ravel().tolist(),
               z_re=z.real.ravel().tolist(), z_im=z.imag.ravel().tolist())
    if plan.decomp == "pencil":
        res["predict_axes"] = list(plan.predict_axes())
        res["grid"] = list(plan.grid.shape)
    out.append(res)
print("RESULT " + json.dumps(out))
"""


def _ref_cases():
    cases = []
    for grid in ((2, 4), (4, 2)):
        def add(shape, ndim, real, backend, tb=False, pipeline="auto", decomp="pencil"):
            cases.append(dict(grid=list(grid), shape=list(shape), ndim=ndim, real=real, backend=backend, tb=tb,
                              pipeline=pipeline, decomp=decomp, prm=PRM, chunk_s=CHUNK_S, seed=len(cases)))

        add((2, 16, 32), 2, False, ["scatter", "alltoall"])
        add((16, 16), 2, False, ["pairwise_xor", "alltoall"], pipeline=False)
        add((8, 8, 16), 3, False, ["pairwise_xor", "scatter"])
        add((2, 8, 8, 16), 3, False, ["scatter", "bisection"], tb=True)
        add((3, 16, 24), 2, True, ["scatter", "scatter"])
        add((8, 8, 10), 3, True, ["scatter", "alltoall"])
        add((2, 8, 8, 10), 3, True, ["alltoall", "scatter"], tb=True)
        add((8, 8, 16), 3, False, "auto", decomp="auto")
        add((16, 32), 2, True, "auto", pipeline=4, decomp="auto")
    return cases


REF_CASES = _ref_cases()


@pytest.fixture(scope="module")
def reference():
    code = REF_CODE.replace("__CASES__", repr(json.dumps(REF_CASES)))
    line = [ln for ln in run_subprocess(code, devices=8).splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _input(c):
    r = np.random.default_rng(c["seed"])
    if c["real"]:
        return r.standard_normal(c["shape"]).astype(np.float32)
    return (r.standard_normal(c["shape"]) + 1j * r.standard_normal(c["shape"])).astype(np.complex64)


def _case_id(c):
    backend = "+".join(c["backend"]) if isinstance(c["backend"], list) else c["backend"]
    return (f"{c['grid'][0]}x{c['grid'][1]}-{'r2c' if c['real'] else 'c2c'}-ndim{c['ndim']}-{c['decomp']}-"
            f"{backend}{'-tb' if c['tb'] else ''}")


@pytest.mark.parametrize("i", range(len(REF_CASES)), ids=[_case_id(c) for c in REF_CASES])
def test_port_matches_reference_pencil_plans_8dev(reference, i):
    c, ref = REF_CASES[i], reference[i]
    backend = c["backend"] if isinstance(c["backend"], str) else tuple(c["backend"])
    x = _input(c)
    for impl in ("matmul", "kernel"):
        plan = plan_fft(tuple(c["shape"]), _mesh(tuple(c["grid"])), ndim=c["ndim"], real=c["real"],
                        decomp=c["decomp"], backend=backend, transpose_back=c["tb"], pipeline=c["pipeline"],
                        local_impl=impl, params=CommParams(**c["prm"]), chunk_compute_s=c["chunk_s"])
        assert (plan.decomp, plan.backend, plan.fused) == (ref["decomp"], ref["backend"], ref["fused"])
        assert plan.schedule_hash() == ref["hash"] and plan.schedule_hash(inverse=True) == ref["inv_hash"]
        assert plan.comm_bytes() == ref["comm"]
        assert plan.predict() == pytest.approx(ref["predict"], rel=1e-12)
        if plan.decomp == "pencil":
            assert list(plan.grid.shape) == ref["grid"]
            for mine, theirs in zip(plan.predict_axes(), ref["predict_axes"]):
                assert mine == pytest.approx(theirs, rel=1e-12)
        assert [list(a) for a in plan.spectral_axes()] == ref["spectral_axes"]
        assert list(plan.spectrum_shape()) == ref["spectrum_shape"]
        y = plan.execute(torch.from_numpy(x))
        assert list(y.shape) == ref["shape"]
        exp = (np.asarray(ref["re"]) + 1j * np.asarray(ref["im"])).reshape(ref["shape"])
        assert _rel(y.numpy(), exp) < TOL, impl
        z = plan.inverse(y).numpy().ravel()
        assert _rel(z, np.asarray(ref["z_re"]) + 1j * np.asarray(ref["z_im"])) < TOL, impl
        assert _rel(z, x.ravel()) < TOL, impl


def _launchable_pack(seen):
    """A stand-in for the pack wrapper that checks each call's operands
    as the CUDA wrapper would and records (chunk shape, fresh)."""
    from repro_torch.kernels import ref

    def pack(chunk, m, *, out=None):
        assert chunk.stride(-1) == 1 or chunk.stride(-2) == 1, chunk.stride()
        chunk.view(-1, *chunk.shape[-2:])
        if out is not None:
            assert out.stride(-1) == 1
            out.view(-1, *out.shape[-3:])
        seen.append((tuple(chunk.shape), out is None))
        if out is None:  # the kernel's fresh result is contiguous
            return ref.chunk_twiddle_pack_ref(chunk, m).contiguous()
        return ref.chunk_twiddle_pack_ref(chunk, m, out=out)

    return pack


def test_pencil_chunks_reach_the_pack_kernel_launchable(monkeypatch):
    """The pack kernel reads a chunk unit-stride along its columns (with
    its row stride) or along its rows (with its column stride), and an
    accumulator slot whose last axis is unit-stride; both need leading
    axes that collapse to one stride. The pencil fft2's swap_last2 hands
    the fused exchange a transposed block, whose own chunk is unit-stride
    along its rows, so every call is checked here as the CUDA wrapper
    would check it (the CPU takes the plain version)."""
    from repro_torch.kernels import fft_stage

    seen = []
    monkeypatch.setattr(fft_stage, "chunk_twiddle_pack_c64", _launchable_pack(seen))
    x2, x3 = _c64(9, (16, 32)), _c64(10, (8, 8, 16))
    for grid in ((2, 2), (2, 4)):
        plan = plan_fft(x2.shape, _mesh(grid), decomp="pencil", backend="scatter", local_impl="kernel")
        assert _rel(plan.execute(torch.from_numpy(x2)).numpy(), np.fft.fft2(x2)) < TOL
        plan3 = plan_fft(x3.shape, _mesh(grid), ndim=3, decomp="pencil", backend="scatter", local_impl="kernel")
        assert _rel(plan3.execute(torch.from_numpy(x3)).numpy(), _reversed(np.fft.fftn(x3))) < TOL
    # each fused exchange packs P_axis chunks a block: 2 * P * (P_row + P_col) a
    # plan, one of each block's P_axis fresh (the own chunk), the rest accumulating
    assert len(seen) == 2 * 4 * (2 + 2) + 2 * 8 * (2 + 4)
    assert sum(fresh for _, fresh in seen) == 2 * 4 * 2 + 2 * 8 * 2


def test_every_fused_pencil_direction_hands_the_pack_kernel_launchable_operands(monkeypatch):
    """The same check over the inverse c2c plans and the real (r2c / c2r)
    pencil plans, both directions, 3-D with and without transpose_back."""
    from repro_torch.kernels import fft_stage

    seen = []
    monkeypatch.setattr(fft_stage, "chunk_twiddle_pack_c64", _launchable_pack(seen))
    x2, x3 = _c64(11, (16, 32)), _c64(12, (8, 8, 16))
    r2, r3 = _f32(13, (2, 16, 24)), _f32(14, (8, 8, 10))
    kw = dict(decomp="pencil", backend="scatter", local_impl="kernel")
    for grid in ((2, 2), (2, 4)):
        mesh = _mesh(grid)
        for x, ndim in ((x2, 2), (x3, 3)):
            plan = plan_fft(x.shape, mesh, ndim=ndim, **kw)
            assert _rel(plan.inverse(plan.execute(torch.from_numpy(x))).numpy(), x) < TOL
        plan = plan_fft(r2.shape, mesh, real=True, **kw)
        y = plan.execute(torch.from_numpy(r2))
        assert _rel(y.numpy()[..., : plan.hermitian_len], np.fft.rfft2(r2)) < TOL
        assert _rel(plan.inverse(y).numpy(), r2) < TOL
        for tb in (False, True):
            plan = plan_fft(r3.shape, mesh, ndim=3, real=True, transpose_back=tb, **kw)
            assert _rel(plan.inverse(plan.execute(torch.from_numpy(r3))).numpy(), r3) < TOL
    assert seen and any(not fresh for _, fresh in seen)


def test_input_spec_names_each_directions_layout():
    """The caller-side layouts (the reference's input_sharding /
    input_spec): a rank of a ProcessGroupMesh passes
    mesh.split(x, spec.tail)[0]; they are the schedules' own in_tails."""
    mesh = _mesh((2, 4))
    for ndim, shape, real, tb in ((3, (8, 8, 16), False, False), (3, (8, 8, 10), True, False),
                                  (3, (8, 8, 10), True, True), (2, (16, 24), True, False)):
        plan = plan_fft(shape, mesh, ndim=ndim, real=real, decomp="pencil", transpose_back=tb)
        for opposite in (False, True):
            spec = plan.input_spec(opposite=opposite)
            sched = plan.schedule(inverse=opposite)
            assert spec.tail == sched.in_tail
            assert spec.shape[-ndim:] == (sched.global_shape if not (real and opposite)
                                          else plan.spectrum_shape())[-ndim:]
    c3 = plan_fft((8, 8, 16), mesh, ndim=3, decomp="pencil")
    assert c3.input_spec(opposite=True) == ((16, 8, 8), torch.complex64, ("cols", "rows", None))
    assert c3.spectrum_tail() == ("cols", "rows", None)
    slab = plan_fft((8, 8), SimMesh(4, device="cpu"), real=True)
    assert slab.input_spec(opposite=True) == ((5 + 3, 8), torch.complex64, ("model", None))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_pencil_fft2_on_the_card(cuda_device):
    """A 2x2 pencil fft2 at (1024, 1024) through the kernels against
    torch.fft.fft2. The fused plan's post-exchange transforms are length
    512 (the matmul FFT), so it launches the pack; the unfused plan
    transforms whole length-1024 rows and launches both stages."""
    from repro_torch.kernels import fft_stage

    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x = torch.randn((1024, 1024), dtype=torch.complex64, device=cuda_device, generator=g)
    mesh = SimMesh((2, 2), axis_names=("rows", "cols"), device=cuda_device)
    exp = torch.fft.fft2(x)
    for backend, pipeline, launched in ((("scatter", "scatter"), "auto", ("chunk_twiddle_pack_c64",)),
                                        (("alltoall", "alltoall"), False, ("stage_left", "stage_right"))):
        plan = plan_fft(tuple(x.shape), mesh, decomp="pencil", backend=backend, pipeline=pipeline,
                        local_impl="kernel")
        fft_stage.reset_launches()
        y = plan.execute(x)
        torch.cuda.synchronize()
        assert all(fft_stage.LAUNCHES[name] > 0 for name in launched), fft_stage.LAUNCHES
        assert ((y - exp).abs().max() / exp.abs().max()).item() < 1e-4
        z = plan.inverse(y)
        assert ((z - x).abs().max() / x.abs().max()).item() < 1e-4
