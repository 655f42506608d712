"""Port parity for the stage-schedule IR: all 52 golden schedules (15
slab c2c, 13 slab r2c, 24 pencil) byte for byte, the byte and cost
walks against the reference's, the divisibility messages, the rewrites
and the spec simulation."""

import json
import os

import pytest

import repro_torch.core.schedule as sch
from repro_torch.core import CommParams
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_schedules.json")


def slab_c2c_cases():
    """key -> build_schedule kwargs: the slab c2c entries of
    tests/test_schedule.py's snapshot grid (the kwargs are the same)."""
    cases = {}
    for ndim, shape in ((2, (16, 16)), (3, (8, 8, 8))):
        for inverse in (False, True):
            for fused in (False, True):
                for tb in ((False, True) if ndim == 2 else (False,)):
                    key = (
                        f"slab/ndim{ndim}/c2c/{'inv' if inverse else 'fwd'}/"
                        f"{'fused' if fused else 'unfused'}" + ("/tb" if tb else "")
                    )
                    cases[key] = dict(
                        global_shape=shape, ndim=ndim, inverse=inverse, real=False,
                        decomp="slab", axis_name="x", p=4, backend="scatter",
                        fused=fused, transpose_back=tb,
                    )
    for fused in (False, True):
        cases[f"slab/ndim1/c2c/fwd/{'fused' if fused else 'unfused'}"] = dict(
            global_shape=(64,), ndim=1, inverse=False, decomp="slab",
            axis_name="x", p=4, backend="scatter", fused=fused,
        )
    cases["slab/ndim2/c2c/fwd/xla_auto"] = dict(
        global_shape=(16, 16), ndim=2, inverse=False, decomp="slab",
        axis_name="x", p=4, backend="xla_auto",
    )
    return cases


def slab_r2c_cases():
    """key -> build_schedule kwargs: the slab r2c entries of
    tests/test_schedule.py's snapshot grid."""
    cases = {}
    for key, kw in slab_c2c_cases().items():
        if key.startswith(("slab/ndim2/c2c/", "slab/ndim3/c2c/")):
            cases[key.replace("/c2c/", "/r2c/")] = dict(kw, real=True)
    return cases


def pencil_cases():
    """key -> build_schedule kwargs: the pencil entries of
    tests/test_schedule.py's snapshot grid (a 2x2 grid, scatter over
    rows and alltoall over cols)."""
    cases = {}
    for ndim, shape in ((2, (16, 16)), (3, (8, 8, 8))):
        for real in (False, True):
            for inverse in (False, True):
                for fused in (False, True):
                    for tb in ((False, True) if ndim == 3 else (False,)):
                        key = (
                            f"pencil/ndim{ndim}/{'r2c' if real else 'c2c'}/{'inv' if inverse else 'fwd'}/"
                            f"{'fused' if fused else 'unfused'}" + ("/tb" if tb else "")
                        )
                        cases[key] = dict(
                            global_shape=shape, ndim=ndim, inverse=inverse, real=real, decomp="pencil",
                            row_axis="rows", col_axis="cols", p_rows=2, p_cols=2,
                            backend_row="scatter", backend_col="alltoall", fused=fused, transpose_back=tb,
                        )
    return cases


C2C_CASES = slab_c2c_cases()
R2C_CASES = slab_r2c_cases()
PENCIL_CASES = pencil_cases()
CASES = {**C2C_CASES, **R2C_CASES, **PENCIL_CASES}


def test_case_grid_covers_every_slab_c2c_golden():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    slab_c2c = {k for k in golden if k.startswith(("slab/ndim1/", "slab/ndim2/c2c/", "slab/ndim3/c2c/"))}
    assert set(C2C_CASES) == slab_c2c and len(C2C_CASES) == 15


def test_case_grid_covers_every_slab_r2c_golden():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    slab_r2c = {k for k in golden if k.startswith(("slab/ndim2/r2c/", "slab/ndim3/r2c/"))}
    assert set(R2C_CASES) == slab_r2c and len(R2C_CASES) == 13
    assert len(CASES) == 52 and set(CASES) == set(golden)


def test_case_grid_covers_every_pencil_golden():
    """The port's pencil cases are the reference's snapshot kwargs, one
    for one (tests/test_schedule.py::snapshot_cases)."""
    from test_schedule import snapshot_cases

    ref = {k: kw for k, kw in snapshot_cases().items() if k.startswith("pencil/")}
    assert PENCIL_CASES == ref and len(PENCIL_CASES) == 24


@pytest.mark.parametrize("key", sorted(CASES))
def test_golden_schedule_byte_identical(key):
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert sch.build_schedule(**CASES[key]).canonical() == golden[key]


@pytest.mark.parametrize("key", sorted(CASES))
def test_byte_and_cost_walks_match_reference(key):
    import repro.core.comm_model as ref_cm
    import repro.core.schedule as ref_sch

    mine = sch.build_schedule(**CASES[key])
    theirs = ref_sch.build_schedule(**CASES[key])
    assert mine.schedule_hash() == theirs.schedule_hash()
    for r_item, c_item in ((8, 8), (16, 16), (4, 8)):
        assert sch.schedule_comm_bytes(mine, r_item, c_item) == ref_sch.schedule_comm_bytes(theirs, r_item, c_item)
    for alpha, beta, cc, n_chunks in ((1e-6, 200e9, 0.0, None), (5e-6, 450e9, 3e-6, 16)):
        for fused in (False, True):
            a = sch.with_pipeline(mine, fused, n_chunks)
            b = ref_sch.with_pipeline(theirs, fused, n_chunks)
            got = sch.predict_seconds(a, CommParams(alpha_s=alpha, beta_bytes_s=beta), cc, 4, 8)
            exp = ref_sch.predict_seconds(b, ref_cm.CommParams(alpha_s=alpha, beta_bytes_s=beta), cc, 4, 8)
            assert got == exp


@pytest.mark.parametrize("key", sorted(CASES))
def test_specs_land_on_out_tail(key):
    built = sch.build_schedule(**CASES[key])
    specs = sch.simulate_specs(built, len(built.global_shape))
    assert specs[0][-len(built.in_tail):] == built.in_tail
    assert specs[-1][-len(built.out_tail):] == built.out_tail
    assert len(specs) == len(built.stages) + 1


@pytest.mark.parametrize(
    "shape,ndim,p",
    [((10, 16), 2, 4), ((16, 10), 2, 4), ((6, 4, 4), 3, 4), ((8, 3, 3), 3, 4), ((40,), 1, 4)],
)
def test_check_divisible_messages_match_reference(shape, ndim, p):
    import repro.core.schedule as ref_sch

    with pytest.raises(ValueError) as theirs:
        ref_sch.check_divisible(shape, ndim, p=p, axis_name="model")
    with pytest.raises(ValueError) as mine:
        sch.check_divisible(shape, ndim, p=p, axis_name="model")
    assert str(mine.value) == str(theirs.value)


def test_rewrites_and_describe():
    base = sch.build_schedule((16, 16), ndim=2, axis_name="x", p=4, backend="scatter", fused=True)
    other = sch.with_backends(base, slab="alltoall")
    assert {st.backend for st in other.exchanges()} == {"alltoall"}
    assert other.schedule_hash() != base.schedule_hash()
    unfused = sch.with_pipeline(base, False, 8)
    assert all(not st.fused and st.n_chunks == 8 for st in unfused.exchanges())
    text = base.describe(params=CommParams())
    assert base.schedule_hash() in text and "Exchange(slab:x, scatter, p=4, fft, fused)" in text


def test_builders_cover_pencil_and_reject_what_the_reference_rejects():
    c2c = sch.build_schedule((16, 16), ndim=2, decomp="pencil", row_axis="r", col_axis="c", p_rows=2, p_cols=2)
    assert c2c.kind == "fft2" and c2c.decomp == "pencil" and c2c.in_tail == c2c.out_tail == ("r", "c")
    assert [st.role for st in c2c.exchanges()] == ["col", "col", "row", "row"]
    r2c = sch.build_schedule((16, 16), ndim=2, real=True, decomp="pencil", row_axis="r", col_axis="c",
                             p_rows=2, p_cols=2)
    assert r2c.kind == "rfft2" and r2c.exchanges()[0].payload == "real" and r2c.hp == 12
    fft3 = sch.build_schedule((8, 8, 8), ndim=3, decomp="pencil", row_axis="r", col_axis="c", p_rows=2, p_cols=4)
    assert fft3.out_tail == ("c", "r", None)  # the reversed layout
    with pytest.raises(ValueError, match="pencil fft2 already returns the natural layout"):
        sch.build_schedule((16, 16), ndim=2, decomp="pencil", row_axis="r", col_axis="c", p_rows=2, p_cols=2,
                           transpose_back=True)
    with pytest.raises(ValueError, match="pencil decomposition supports ndim 2 or 3"):
        sch.build_schedule((64,), ndim=1, decomp="pencil", row_axis="r", col_axis="c", p_rows=2, p_cols=2)
    with pytest.raises(NotImplementedError, match="real pencil transforms support ndim 2 or 3"):
        sch.build_schedule((64,), ndim=1, real=True, decomp="pencil", row_axis="r", col_axis="c",
                           p_rows=2, p_cols=2)
    assert sch.build_schedule((16, 16), ndim=2, real=True, axis_name="x", p=4).kind == "rfft2"
    with pytest.raises(NotImplementedError, match="real transforms support ndim 2 or 3"):
        sch.build_schedule((64,), ndim=1, real=True, axis_name="x", p=4)
    with pytest.raises(NotImplementedError, match="conjugate externally"):
        sch.build_schedule((64,), ndim=1, inverse=True, axis_name="x", p=4)
    with pytest.raises(ValueError, match="must factor as rows"):
        sch.build_schedule((66,), ndim=1, axis_name="x", p=4, backend="scatter")
