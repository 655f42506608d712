"""The port's pencil-grid plumbing against the reference, host side: the
grid factorizations, ProcessGrid / grid_from_mesh / make_grid
validation over SimMesh grids, the per-axis cost model (cheapest_pair,
t_pencil) equal to the reference's values, the pencil divisibility and
backend checks (pure data, compared in process), the 2-D mesh's
split / gather / rings, and decomp="auto" / decomp="pencil" plan
plumbing. The multi-rank numerics are in tests/test_torch_pencil.py."""

import numpy as np
import pytest
import torch

from repro_torch.core import CommParams, ProcessGrid, SimMesh, backends, comm_model, plan_fft
from repro_torch.core.grid import auto_grid_shape, grid_from_mesh, grid_shapes, make_grid
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

PRM = dict(alpha_s=3e-6, beta_bytes_s=120e9)  # explicit, so both packages price alike


def _grid_mesh(shape, names=("rows", "cols")):
    return SimMesh(shape, axis_names=names, device="cpu")


# ---------------------------------------------------------------------------
# factorizations, held against the reference's
# ---------------------------------------------------------------------------


def test_grid_shapes_and_auto_grid_shape_match_reference():
    from repro.core import grid as ref_grid

    for p in range(1, 17):
        assert grid_shapes(p) == ref_grid.grid_shapes(p)
        assert auto_grid_shape(p) == ref_grid.auto_grid_shape(p)
        pr, pc = auto_grid_shape(p)
        assert pr * pc == p and pr <= pc and all(max(a, b) >= pc for a, b in grid_shapes(p))
    for bad in (grid_shapes, auto_grid_shape):
        with pytest.raises(ValueError, match="positive"):
            bad(0)


# ---------------------------------------------------------------------------
# ProcessGrid / resolution (tests/test_grid.py's rules, on SimMesh grids)
# ---------------------------------------------------------------------------


def test_process_grid_validates_axes():
    mesh = _grid_mesh((2, 4))
    g = ProcessGrid(mesh)
    assert g.shape == (2, 4) and g.size == 8 and (g.p_rows, g.p_cols) == (2, 4)
    assert g.axis_of("row") == "rows" and g.axis_of("col") == "cols"
    assert repr(g) == "ProcessGrid(2x4, row_axis='rows', col_axis='cols')"
    with pytest.raises(ValueError, match="distinct"):
        ProcessGrid(mesh, "rows", "rows")
    with pytest.raises(ValueError, match="not an axis"):
        ProcessGrid(mesh, "rows", "model")
    with pytest.raises(ValueError, match="'row' or 'col'"):
        g.axis_of("diag")


def test_grid_from_mesh_resolution_rules():
    g = grid_from_mesh(_grid_mesh((1, 1)))
    assert (g.row_axis, g.col_axis) == ("rows", "cols")
    g = grid_from_mesh(_grid_mesh((2, 2), ("data", "model")))  # the last two axes
    assert (g.row_axis, g.col_axis) == ("data", "model")
    g = grid_from_mesh(_grid_mesh((2, 4), ("a", "b")), row_axis="b", col_axis="a")
    assert (g.row_axis, g.col_axis, g.shape) == ("b", "a", (4, 2))
    with pytest.raises(ValueError, match="both"):
        grid_from_mesh(_grid_mesh((1, 1), ("a", "b")), row_axis="a")
    with pytest.raises(ValueError, match=">= 2 axes"):
        grid_from_mesh(SimMesh(4, device="cpu"))


def test_make_grid_validates():
    g = make_grid((2, 3), device="cpu")
    assert g.shape == (2, 3) and g.mesh.shape == {"rows": 2, "cols": 3}
    with pytest.raises(ValueError, match="positive"):
        make_grid((0, 1), device="cpu")
    with pytest.raises(ValueError, match="one axis name per dim"):
        SimMesh((2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        SimMesh((2, 2), axis_names=("a", "a"), device="cpu")


# ---------------------------------------------------------------------------
# the 2-D mesh: row-major ranks, rings, split / gather by axis name
# ---------------------------------------------------------------------------


def test_grid_mesh_rings_split_and_gather():
    mesh = _grid_mesh((2, 4))
    assert mesh.p == 8 and mesh.coords(6) == {"rows": 1, "cols": 2}
    # the rows ring is the ranks sharing a column index, and vice versa
    assert [idx for _, idx in mesh.rings("rows")] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert [idx for _, idx in mesh.rings("cols")] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    ring, _ = mesh.rings("rows")[0]
    assert ring.shape == {"rows": 2} and ring.local_ranks() == [0, 1]
    x = torch.arange(8 * 12 * 3).reshape(8, 12, 3)
    for tail in (("rows", "cols", None), ("cols", "rows", None), ("cols", None, None), (None, "rows", None)):
        blocks = mesh.split(x, tail)
        assert len(blocks) == 8
        assert torch.equal(mesh.gather(blocks, tail), x)
    blocks = mesh.split(x, ("cols", "rows", None))  # reversed pencil layout
    assert torch.equal(blocks[6], x[4:6, 6:12])  # rank (row 1, col 2)
    with pytest.raises(ValueError, match="needs one axis"):
        mesh.all_to_all(blocks, split_axis=1, concat_axis=0)
    with pytest.raises(ValueError, match="names a mesh axis twice"):
        mesh.split(x, ("rows", "rows", None))
    with pytest.raises(ValueError, match="not divisible by the 4 ranks of mesh axis 'cols'"):
        mesh.split(x, (None, None, "cols"))
    with mesh.running(6):
        assert mesh.axis_index("rows") == 1 and mesh.axis_index("cols") == 2


def test_gather_holds_no_reference_to_the_blocks():
    """The blocks are freed as soon as the caller drops them, without
    the cyclic garbage collector (a reference cycle through the gather
    would keep a transform's blocks alive on the card after it ends)."""
    import gc
    import weakref

    gc.disable()
    try:
        for mesh, tail in ((_grid_mesh((2, 4)), ("cols", "rows", None)), (SimMesh(4, device="cpu"), ("model", None))):
            blocks = [torch.randn(2, 3, 4) for _ in range(mesh.p)]
            alive = weakref.ref(blocks[-1])
            out = mesh.gather(blocks, tail)
            assert out.shape[-1] == 4
            del blocks
            assert alive() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# per-axis cost model, equal to the reference's values
# ---------------------------------------------------------------------------


def test_available_kind_filter():
    shard = backends.available(kind="shard_map")
    assert "xla_auto" not in shard and "scatter" in shard
    assert set(shard) | {"xla_auto"} == set(backends.available())
    assert backends.available(kind="global") == ("xla_auto",)


@pytest.mark.parametrize("grid", [(8, 2), (2, 8), (4, 4), (3, 5), (1, 6)])
def test_cheapest_pair_and_t_pencil_match_reference(grid):
    from repro.core import backends as ref_backends
    from repro.core import comm_model as ref_cm

    pr, pc = grid
    for m in (2**12, 4 * 2**20, 2**30):
        for prm_kw in (PRM, dict(alpha_s=1.0, beta_bytes_s=1e12)):
            prm, ref_prm = CommParams(**prm_kw), ref_cm.CommParams(**prm_kw)
            for kw in (dict(), dict(chunk_compute_s=4e-6, n_chunks=16), dict(fused=False)):
                got = backends.cheapest_pair(m, pr, pc, prm, **kw)
                assert got == ref_backends.cheapest_pair(m, pr, pc, ref_prm, **kw)
                assert got[0] == backends.cheapest(m, pr, prm, names=backends.supporting(pr, "shard_map"), **kw)
            for ndim, tb in ((2, False), (3, False), (3, True)):
                for br, bc in (("scatter", "bisection"), ("alltoall", "scatter")):
                    kw = dict(ndim=ndim, transpose_back=tb, chunk_compute_s=1e-6, first_col_m_bytes=m / 2)
                    assert comm_model.t_pencil(m, pr, pc, br, bc, prm, **kw) == ref_cm.t_pencil(
                        m, pr, pc, br, bc, ref_prm, **kw)
    # global backends are never selected per axis, even when named
    assert backends.cheapest_pair(2**20, 2, 2, names=("alltoall", "xla_auto")) == ("alltoall", "alltoall")


def test_t_pencil_sums_per_axis_costs():
    m, pr, pc = 2 * 2**20, 4, 2
    prm = CommParams()
    t = comm_model.t_pencil(m, pr, pc, "scatter", "bisection", prm, ndim=3)
    expect = comm_model.t_scatter_ring(m, pr, prm) + comm_model.t_bisection(m, pc, prm)
    assert abs(t - expect) < 1e-18
    t2 = comm_model.t_pencil(m, pr, pc, "scatter", "bisection", prm, ndim=2)
    assert abs(t2 - 2 * expect) < 1e-18  # fft2: two exchanges per sub-ring
    tb = comm_model.t_pencil(m, pr, pc, "scatter", "bisection", prm, ndim=3, transpose_back=True)
    assert abs(tb - 2 * expect) < 1e-18
    with pytest.raises(ValueError, match="ndim 2 or 3"):
        comm_model.t_pencil(m, pr, pc, "scatter", "scatter", ndim=1)


# ---------------------------------------------------------------------------
# divisibility and backend checks, message for message (pure data)
# ---------------------------------------------------------------------------


class _FakeGrid:
    row_axis, col_axis = "rows", "cols"

    def __init__(self, pr, pc):
        self.p_rows, self.p_cols = pr, pc


DIVISIBILITY = [  # (shape, ndim, (pr, pc), real, pad) that fail: tests/test_grid.py + tests/test_real.py
    ((9, 8, 8), 3, (2, 4), False, True), ((8, 9, 8), 3, (2, 4), False, True),
    ((8, 8, 9), 3, (2, 4), False, True), ((9, 4, 8), 3, (3, 4), False, True),
    ((9, 8), 2, (2, 4), False, True), ((8, 12), 2, (2, 4), False, True), ((8, 8), 1, (2, 4), False, True),
    ((9, 8, 8), 3, (2, 4), True, True), ((8, 6, 8), 3, (2, 4), True, True), ((8, 4, 8), 3, (8, 4), True, True),
    ((16, 8, 8), 3, (2, 4), True, False), ((16, 16), 2, (2, 4), True, False), ((12, 16), 2, (2, 4), True, True),
    ((16, 6), 2, (2, 4), True, True),
]


@pytest.mark.parametrize("shape,ndim,grid,real,pad", DIVISIBILITY)
def test_pencil_divisibility_messages_match_reference(shape, ndim, grid, real, pad):
    import repro.core.schedule as ref_sch

    import repro_torch.core.schedule as sch

    kw = dict(p_rows=grid[0], p_cols=grid[1], row_axis="rows", col_axis="cols", real=real, pad=pad)
    with pytest.raises((ValueError, NotImplementedError)) as theirs:
        ref_sch.check_divisible(shape, ndim, **kw)
    with pytest.raises(type(theirs.value)) as mine:
        sch.check_divisible(shape, ndim, **kw)
    assert str(mine.value) == str(theirs.value)
    if ndim == 3 and not real and grid == (2, 4):
        from repro_torch.core.pencil import check_divisible

        with pytest.raises(ValueError, match=r"axis -\d .*P_(row|col)="):
            check_divisible(shape, _FakeGrid(*grid), 3)
    if real and not pad:  # the pad error names the Hermitian axis and the grid dim
        with pytest.raises(ValueError, match=r"Hermitian axis -1 .*P_(col=4|row\*P_col=8)"):
            plan_fft(shape, _grid_mesh(grid), ndim=ndim, real=True, decomp="pencil", pad=False)


def test_pencil_divisibility_ok_matches_reference():
    import repro.core.schedule as ref_sch

    import repro_torch.core.schedule as sch

    for shape, ndim, grid in (((8, 8, 10), 3, (2, 4)), ((16, 24), 2, (2, 4)), ((3, 16, 10), 2, (4, 2))):
        kw = dict(p_rows=grid[0], p_cols=grid[1], row_axis="rows", col_axis="cols", real=True)
        assert sch.check_divisible(shape, ndim, **kw) == ref_sch.check_divisible(shape, ndim, **kw)


@pytest.mark.parametrize("grid", [(2, 4), (3, 2), (1, 1)])
def test_check_backends_matches_reference(grid):
    from repro.core import pencil as ref_pencil

    from repro_torch.core import pencil

    for br in ("alltoall", "scatter", "pairwise_xor", "bisection", "xla_auto", "lci"):
        for bc in ("scatter", "pairwise_xor", "xla_auto"):
            try:
                ref_pencil._check_backends(ref_pencil.PencilConfig(br, bc), _FakeGrid(*grid))
            except ValueError as e:
                with pytest.raises(ValueError) as mine:
                    pencil._check_backends(pencil.PencilConfig(br, bc), _FakeGrid(*grid))
                assert str(mine.value) == str(e)
            else:
                pencil._check_backends(pencil.PencilConfig(br, bc), _FakeGrid(*grid))


# ---------------------------------------------------------------------------
# plan-level decomp plumbing
# ---------------------------------------------------------------------------


def test_pencil_plan_predict_decomposes_per_axis():
    plan = plan_fft((8, 8, 8), _grid_mesh((2, 4)), ndim=3, decomp="pencil")
    assert plan.decomp == "pencil" and plan.grid.shape == (2, 4) and plan.shards == 8
    pred = plan.predict()
    rowc, colc = plan.predict_axes()
    for r in rowc:
        for c in colc:
            assert pred[f"{r}+{c}"] == rowc[r] + colc[c]
    assert len(pred) == len(backends.supporting(2, "shard_map")) * len(backends.supporting(4, "shard_map"))
    assert plan.backend == f"{plan.backend_row}+{plan.backend_col}"
    assert pred[plan.backend] == min(pred.values())  # backend="auto" is the per-axis argmin
    assert "grid=2x4" in repr(plan) and "grid=2x4" in plan.describe()
    with pytest.raises(ValueError, match="pencil-plan method"):
        plan_fft((8, 8), SimMesh(2, device="cpu")).predict_axes()


def test_decomp_auto_picks_pencil_on_2d_mesh_slab_on_1d():
    mesh2 = _grid_mesh((1, 1))
    auto2 = plan_fft((8, 8, 8), mesh2, ndim=3, decomp="auto")
    assert auto2.decomp == "pencil" and auto2.grid is not None
    auto1 = plan_fft((8, 8), SimMesh(1, device="cpu"), decomp="auto")
    assert auto1.decomp == "slab" and auto1.grid is None
    assert plan_fft((4096,), mesh2, ndim=1, decomp="auto").decomp == "slab"  # 1-D is slab-only
    # a degenerate (P, 1) grid doubles the fft2 exchanges over one ring: slab wins it
    tall = plan_fft((16, 16), _grid_mesh((4, 1)), decomp="auto", params=CommParams(**PRM))
    assert tall.decomp == "slab" and tall.axis_name == "rows" and tall.shards == 4


def test_decomp_auto_steered_by_pinned_backend():
    mesh2 = _grid_mesh((1, 1))
    p = plan_fft((8, 8, 8), mesh2, ndim=3, decomp="auto", backend="xla_auto")
    assert p.decomp == "slab" and p.backend == "xla_auto"
    p2 = plan_fft((8, 8, 8), mesh2, ndim=3, decomp="auto", backend=("scatter", "bisection"))
    assert p2.decomp == "pencil" and p2.backend == "scatter+bisection"
    with pytest.raises(ValueError, match=r"neither decomposition.*pencil:.*slab:"):
        plan_fft((8, 8), mesh2, decomp="auto", backend=("xla_auto", "xla_auto"))


def test_decomp_auto_matches_reference_decisions():
    """On the reference's one in-process device (a 1x1 grid) both
    packages resolve the same decomposition, backends and schedule."""
    from repro.core import CommParams as RefParams
    from repro.core import plan_fft as ref_plan_fft
    from repro.core.compat import make_mesh, make_mesh_1d

    for shape, ndim, real, backend in (((8, 8, 8), 3, False, "auto"), ((8, 8), 2, True, "auto"),
                                       ((8, 8, 8), 3, False, "xla_auto"), ((8, 8), 2, False, ("scatter", "alltoall"))):
        for ref_mesh, mesh in ((make_mesh((1, 1), ("rows", "cols")), _grid_mesh((1, 1))),
                               (make_mesh_1d(1), SimMesh(1, device="cpu"))):
            kw = dict(ndim=ndim, real=real, backend=backend, decomp="auto", chunk_compute_s=1e-6)
            try:
                theirs = ref_plan_fft(shape, ref_mesh, params=RefParams(**PRM), **kw)
            except ValueError as e:  # a pinned pair on a 1-D mesh fits neither
                with pytest.raises(ValueError, match="neither decomposition") as mine:
                    plan_fft(shape, mesh, params=CommParams(**PRM), **kw)
                assert str(mine.value).split(" -- slab: ")[1] == str(e).split(" -- slab: ")[1]
                continue
            mine = plan_fft(shape, mesh, params=CommParams(**PRM), **kw)
            assert (mine.decomp, mine.backend, mine.schedule_hash()) == (
                theirs.decomp, theirs.backend, theirs.schedule_hash())


def test_decomp_validation_errors():
    mesh2 = _grid_mesh((1, 1))
    mesh1 = SimMesh(1, device="cpu")
    with pytest.raises(ValueError, match="decomp"):
        plan_fft((8, 8), mesh2, decomp="brick")
    with pytest.raises(ValueError, match="ndim 2 or 3"):
        plan_fft((4096,), mesh2, ndim=1, decomp="pencil")
    with pytest.raises(ValueError, match="natural layout"):
        plan_fft((8, 8), mesh2, decomp="pencil", transpose_back=True)
    with pytest.raises(ValueError, match=">= 2 axes"):
        plan_fft((8, 8), mesh1, decomp="pencil")
    with pytest.raises(ValueError, match="decomp='pencil'"):
        plan_fft((8, 8), mesh2, decomp="slab", row_axis="rows", col_axis="cols")
    with pytest.raises(ValueError, match="one backend name"):
        plan_fft((8, 8), mesh1, backend="scatter+bisection")
    with pytest.raises(ValueError, match="whole-transform"):
        plan_fft((8, 8), mesh2, decomp="pencil", backend="xla_auto")
    with pytest.raises(ValueError, match="registered backends"):
        plan_fft((8, 8), mesh2, decomp="pencil", backend=("scatter", "lci"))
    with pytest.raises(ValueError, match="2 entries"):
        plan_fft((8, 8), mesh2, decomp="pencil", backend=("a", "b", "c"))
    with pytest.raises(ValueError, match="does not support P_row=3"):
        plan_fft((12, 12), _grid_mesh((3, 2)), decomp="pencil", backend="pairwise_xor")
    with pytest.raises(ValueError, match=r"axis -2 .*P_row\*P_col=8"):
        plan_fft((12, 16), _grid_mesh((2, 4)), decomp="pencil")


def test_auto_does_not_swallow_axis_argument_errors():
    mesh2 = _grid_mesh((1, 1))
    with pytest.raises(ValueError, match="both row_axis and col_axis"):
        plan_fft((8, 8), mesh2, decomp="auto", row_axis="rows")
    with pytest.raises(ValueError, match="not an axis"):
        plan_fft((8, 8), mesh2, decomp="auto", row_axis="rows", col_axis="model")
    p = plan_fft((8, 8), mesh2, decomp="auto", row_axis="cols", col_axis="rows")
    assert p.decomp == "pencil" and p.grid.row_axis == "cols"


def test_slab_plan_on_a_grid_mesh_replicates_the_other_axis():
    """decomp="slab" on a 2-D mesh shards over one axis and replicates
    over the other, as jax does: each ring of that axis runs the same
    exchange."""
    mesh = _grid_mesh((2, 4))
    x = np.random.default_rng(5).standard_normal((8, 16)).astype(np.complex64)
    for axis in ("rows", "cols"):
        plan = plan_fft(x.shape, mesh, axis_name=axis, backend="scatter", local_impl="kernel")
        assert plan.decomp == "slab" and plan.shards == mesh.shape[axis] and plan.fused
        y = plan.execute(torch.from_numpy(x)).numpy()
        assert np.abs(y - np.fft.fft2(x).T).max() < 5e-5 * np.abs(y).max()
        z = plan.inverse(torch.from_numpy(y)).numpy()
        assert np.abs(z - x).max() < 5e-5 * np.abs(x).max()
    assert plan_fft(x.shape, mesh).axis_name == "cols"  # fft_axis: the last axis
