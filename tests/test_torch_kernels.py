"""Port parity for the Hopper kernels' wrappers.

On the CPU the wrappers run their plain PyTorch versions; these tests
hold them against the reference's Pallas kernels (interpret mode) on the
shapes and tolerances of tests/test_kernels.py. The class marked
``cuda`` runs the same comparisons kernel-vs-plain on the card and skips
where there is none; it needs no jax, so it also runs where only the
port is installed (``pytest -m cuda tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fft_stage, ops, ref
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)


def _reference():
    """The reference's kernel modules + jax.numpy (imported only by the
    parity tests, so the card tests run without jax)."""
    pytest.importorskip("jax", reason="the reference package needs jax")
    import jax.numpy as jnp
    from repro.kernels import fft_stage as ref_fft_stage
    from repro.kernels import ops as ref_ops

    return ref_fft_stage, ref_ops, jnp

LEFT_CASES = [(1, 128, 128, 128), (2, 256, 64, 128), (3, 128, 512, 256), (1, 384, 128, 384)]
RIGHT_CASES = [(1, 128, 128, 128), (2, 128, 256, 128)]
PACK_CASES = [((3,), 4, 6, 8), ((2, 5), 8, 4, 2), ((1,), 1, 3, 4)]


def _planar(seed, shape):
    r = np.random.default_rng(seed)
    return (
        r.standard_normal(shape).astype(np.float32),
        r.standard_normal(shape).astype(np.float32),
    )


def _t(pair, device="cpu"):
    return tuple(torch.from_numpy(p).to(device) for p in pair)


def _c64(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


def _pack(pair):
    return torch.complex(*_t(pair))


def _unpack(c):
    return c.real.contiguous(), c.imag.contiguous()


# each stage through both entry points: the reference's planar signature
# and the interleaved complex64 one ops.fft_last_axis calls
FORMS = {
    "planar": (ops.stage_left, ops.stage_right),
    "c64": (
        lambda w, a, t: _unpack(fft_stage.stage_left_c64(*(torch.complex(*x) for x in (w, a, t)))),
        lambda a, w: _unpack(fft_stage.stage_right_c64(torch.complex(*a), torch.complex(*w))),
    ),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("b,m,k,n", LEFT_CASES)
def test_stage_left_matches_reference(b, m, k, n, form):
    _, ref_ops, _ = _reference()
    w, a, t = _planar(1, (m, k)), _planar(2, (b, k, n)), _planar(3, (m, n))
    before = dict(fft_stage.LAUNCHES)
    got = FORMS[form][0](_t(w), _t(a), _t(t))
    exp = ref_ops.stage_left(w, a, t)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-4, atol=2e-3)
    assert fft_stage.LAUNCHES == before  # the plain path launches nothing


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("b,m,k,n", RIGHT_CASES)
def test_stage_right_matches_reference(b, m, k, n, form):
    _, ref_ops, _ = _reference()
    a, w = _planar(4, (b, m, k)), _planar(5, (n, k))
    got = FORMS[form][1](_t(a), _t(w))
    exp = ref_ops.stage_right(a, w)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-4, atol=2e-3)


def test_fft_last_axis_reads_stage_right_transposed_layout(monkeypatch):
    """On the card stage_right_c64 returns the (B, M, N) view of a
    (B, N, M) buffer. fft_last_axis must give the same values from it,
    and its final transpose + reshape must be a view of that buffer."""
    buffers = []

    def transposed_right(a, w):
        out = ref.stage_right_c64_ref(a, w).mT.contiguous()  # (B, N, M)
        buffers.append(out)
        return out.mT

    x = torch.from_numpy(_c64(16384, (3, 16384)))
    exp = ops.fft_last_axis(x)
    monkeypatch.setattr(fft_stage, "stage_right_c64", transposed_right)
    got = ops.fft_last_axis(x)
    assert got.shape == exp.shape and got.dtype == torch.complex64
    assert got.data_ptr() == buffers[-1].data_ptr()  # no copy after the kernel
    torch.testing.assert_close(got, exp, rtol=0, atol=0)


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 values (round to 10 mantissa bits,
    ties away from zero)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_one_pass_tf32_misses_the_fft_tolerance_and_3xtf32_holds_it():
    """Why the kernels split each operand: the four-step FFT at n = 16384
    with one-pass TF32 products misses the 2e-5 tolerance the card tests
    hold fft_last_axis to; the 3xTF32 sum (big*big + big*small +
    small*big, fp32 operands split as on the card) meets it."""
    n1, n2 = ops._kernel_factors(16384)
    x = _c64(5, (2, n1, n2))
    w1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / 16384 * n2).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / 16384).astype(np.complex64)
    w2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2).astype(np.complex64)

    def cplx(f):
        return lambda x: f(x.real) + 1j * f(x.imag)

    one = cplx(_tf32)
    big, small = one, cplx(lambda v: _tf32(v - _tf32(v)))

    def matmul(a, b, three):
        a, b = a.astype(np.complex64), b.astype(np.complex64)
        if not three:
            return (one(a).astype(np.complex128) @ one(b)).astype(np.complex64)
        return (big(a) @ big(b) + big(a) @ small(b) + small(a) @ big(b)).astype(np.complex64)

    oracle = np.fft.fft(x.reshape(2, -1))
    errs = {}
    for three in (False, True):
        d = matmul(matmul(w1, x, three) * tw, w2.T, three)
        got = d.transpose(0, 2, 1).reshape(2, -1)
        errs[three] = np.abs(got - oracle).max() / np.abs(oracle).max()
    assert errs[False] > 2e-5, errs
    assert errs[True] < 2e-6, errs


@pytest.mark.parametrize("lead,rows,c,p", PACK_CASES)
def test_chunk_twiddle_pack_matches_reference(lead, rows, c, p):
    ref_fft_stage, _, jnp = _reference()
    chunk, m = _c64(6, lead + (rows, c)), _c64(7, (p, rows))
    got = fft_stage.chunk_twiddle_pack_c64(torch.from_numpy(chunk), torch.from_numpy(m)).numpy()
    exp = np.asarray(ref_fft_stage.chunk_twiddle_pack_c64(jnp.asarray(chunk), jnp.asarray(m)))
    assert got.shape == lead + (c, p, rows)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)


def test_chunk_twiddle_pack_rejects_wrong_dtype_and_shape():
    ref_fft_stage, _, jnp = _reference()
    chunk = torch.zeros((2, 4, 6), dtype=torch.complex64)
    for fn, mk in ((fft_stage.chunk_twiddle_pack_c64, torch.zeros),
                   (ref_fft_stage.chunk_twiddle_pack_c64, jnp.zeros)):
        real = mk((2, 4, 6), dtype=torch.float32 if mk is torch.zeros else jnp.float32)
        m = mk((8, 4), dtype=torch.complex64 if mk is torch.zeros else jnp.complex64)
        with pytest.raises(ValueError, match="planar-f32"):
            fn(real, m)
    with pytest.raises(ValueError, match=r"m must be \(p, rows\)=\(8, 4\), got \(8, 5\)"):
        fft_stage.chunk_twiddle_pack_c64(chunk, torch.zeros((8, 5), dtype=torch.complex64))
    with pytest.raises(ValueError, match=r"m must be \(p, rows\)=\(8, 4\), got \(8, 5\)"):
        ref_fft_stage.chunk_twiddle_pack_c64(jnp.asarray(chunk.numpy()), jnp.zeros((8, 5), jnp.complex64))


# accumulate-form cases: leading batch axes, odd c, p in {2, 3, 4}
ACC_CASES = [((2, 3), 6, 5, 2), ((3,), 8, 7, 3), ((), 4, 9, 4), ((1,), 5, 3, 4)]
#: how the accumulate tests lay out their operands: a contiguous chunk and
#: accumulator, one sub-chunk's column slot of a wider accumulator, and a
#: chunk unit-stride along its rows (a transposed block's own chunk)
ACC_LAYOUTS = ("contiguous", "slot", "rows-unit")


def _acc_operands(lead, rows, c, p, layout, device="cpu"):
    """(chunk, m, out, the accumulator's numpy start, the whole buffer
    out is a view of) as the accumulate tests use them."""
    chunk, m = _c64(6, lead + (rows, c)), _c64(7, (p, rows))
    acc0 = _c64(8, lead + (c, p, rows))
    tc = torch.from_numpy(chunk).to(device)
    if layout == "rows-unit":
        tc = torch.from_numpy(np.ascontiguousarray(np.swapaxes(chunk, -1, -2))).to(device).transpose(-1, -2)
        assert tc.stride(-2) == 1
    if layout == "slot":  # columns [rows, 2 rows) of a (..., c, p, 3 rows) buffer
        whole = torch.from_numpy(_c64(9, lead + (c, p, 3 * rows))).to(device)
        whole[..., rows : 2 * rows] = torch.from_numpy(acc0).to(device)
        out = whole[..., rows : 2 * rows]
    else:
        whole = out = torch.from_numpy(acc0.copy()).to(device)
    return tc, torch.from_numpy(m).to(device), out, acc0, whole


@pytest.mark.parametrize("layout", ACC_LAYOUTS)
@pytest.mark.parametrize("lead,rows,c,p", ACC_CASES)
def test_chunk_twiddle_pack_accumulates_like_reference(lead, rows, c, p, layout):
    """out= adds the reference pack's result into the accumulator in
    place, whatever the accumulator's and the chunk's strides."""
    ref_fft_stage, _, jnp = _reference()
    chunk, m, out, acc0, whole = _acc_operands(lead, rows, c, p, layout)
    before = whole.clone()
    got = fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out)
    assert got is out
    exp = acc0 + np.asarray(ref_fft_stage.chunk_twiddle_pack_c64(
        jnp.asarray(chunk.numpy()), jnp.asarray(m.numpy())))
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-5, atol=1e-5)
    if layout == "slot":  # the slots either side are untouched
        torch.testing.assert_close(whole[..., :rows], before[..., :rows], rtol=0, atol=0)
        torch.testing.assert_close(whole[..., 2 * rows :], before[..., 2 * rows :], rtol=0, atol=0)
    # the fresh form of a unit-stride-row chunk agrees with the reference too
    fresh = fft_stage.chunk_twiddle_pack_c64(chunk, m).numpy()
    np.testing.assert_allclose(fresh, exp - acc0, rtol=1e-5, atol=1e-5)


def test_chunk_twiddle_pack_accumulate_is_the_plain_add():
    """On the CPU the accumulate form is exactly out.add_(fresh): the sum
    the fused exchange formed before it existed, bit for bit."""
    chunk, m, out, acc0, _ = _acc_operands((2,), 6, 5, 3, "slot")
    exp = torch.from_numpy(acc0).add_(ref.chunk_twiddle_pack_ref(chunk, m))
    fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out)
    torch.testing.assert_close(out, exp, rtol=0, atol=0)


def test_chunk_twiddle_pack_rejects_bad_accumulators_and_layouts():
    chunk = torch.zeros((2, 4, 6), dtype=torch.complex64)
    m = torch.zeros((3, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match=r"out must be \(2, 6, 3, 4\), got \(2, 6, 3, 5\)"):
        fft_stage.chunk_twiddle_pack_c64(chunk, m, out=torch.zeros((2, 6, 3, 5), dtype=torch.complex64))
    with pytest.raises(ValueError, match="out must be complex64"):
        fft_stage.chunk_twiddle_pack_c64(chunk, m, out=torch.zeros((2, 6, 3, 4), dtype=torch.complex128))
    # the kernel's layout rule: unit stride along the columns or the rows, never a copy
    assert fft_stage._pack_layout(chunk) == ("cols", 6)
    assert fft_stage._pack_layout(chunk.mT.contiguous().mT) == ("rows", 4)
    assert fft_stage._pack_layout(torch.zeros((8, 1), dtype=torch.complex64)[::2]) == ("cols", 2)
    with pytest.raises(ValueError, match="unit-stride along its rows or its columns"):
        fft_stage._pack_layout(torch.zeros((8, 12), dtype=torch.complex64)[::2, ::2])


def test_stage_wrappers_reject_bad_shapes_and_mixed_devices():
    w, a, t = _t(_planar(1, (8, 4))), _t(_planar(2, (2, 4, 3))), _t(_planar(3, (8, 3)))
    with pytest.raises(ValueError, match="t planes must be"):
        fft_stage.stage_left(w, a, (t[0][:, :2], t[1][:, :2]))
    with pytest.raises(ValueError, match="w planes must be"):
        fft_stage.stage_right(a, (w[0][:, :2], w[1][:, :2]))
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="different devices"):
        fft_stage.stage_left((meta, meta), a, t)


@pytest.mark.parametrize("n", [1024, 4096, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_last_axis_matches_reference(n, inverse):
    _, ref_ops, jnp = _reference()
    x = _c64(n, (2, n))
    got = ops.fft_last_axis(torch.from_numpy(x), inverse=inverse).numpy()
    exp = np.asarray(ref_ops.fft_last_axis(jnp.asarray(x), inverse=inverse))
    assert got.dtype == np.complex64
    assert np.abs(got - exp).max() / (np.abs(exp).max() + 1e-9) < 2e-5
    oracle = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 2e-5


def test_fft_last_axis_takes_factors_the_reference_tiling_rejects():
    """n = 1000 factors as (500, 2): the reference's Pallas tiling
    (bm = 128 must divide n1) raises; the Hopper kernels take any
    (n1, n2) that _kernel_factors returns (ROADMAP §C)."""
    _, ref_ops, jnp = _reference()
    x = _c64(1000, (2, 1000))
    with pytest.raises(ValueError, match="must tile by"):
        ref_ops.fft_last_axis(jnp.asarray(x))
    assert ops._kernel_factors(1000) == (500, 2)
    got = ops.fft_last_axis(torch.from_numpy(x)).numpy()
    assert np.abs(got - np.fft.fft(x)).max() / np.abs(np.fft.fft(x)).max() < 2e-5


def test_fft_last_axis_fallback_odd_size_and_c128():
    # 1021 prime: no kernel factors, the reference's own matmul fallback
    x = _c64(1021, (1021,))
    got = ops.fft_last_axis(torch.from_numpy(x)).numpy()
    assert np.abs(got - np.fft.fft(x)).max() / np.abs(np.fft.fft(x)).max() < 1e-4
    # c128 input: complex64 out, as the reference's contract says
    x = _c64(3, (2, 4096)).astype(np.complex128)
    got = ops.fft_last_axis(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - np.fft.fft(x)).max() / np.abs(np.fft.fft(x)).max() < 2e-5


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("form", sorted(FORMS))
    @pytest.mark.parametrize("b,m,k,n", LEFT_CASES + [(3, 100, 37, 5), (2, 500, 500, 2), (64, 512, 512, 32)])
    def test_stage_left(self, cuda_device, b, m, k, n, form):
        w, a, t = _planar(1, (m, k)), _planar(2, (b, k, n)), _planar(3, (m, n))
        left = FORMS[form][0]
        before = fft_stage.LAUNCHES["stage_left"]
        got = left(_t(w, cuda_device), _t(a, cuda_device), _t(t, cuda_device))
        torch.cuda.synchronize()
        assert fft_stage.LAUNCHES["stage_left"] == before + 1
        exp = ref.stage_left_ref(_t(w, cuda_device), _t(a, cuda_device), _t(t, cuda_device))
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(), rtol=2e-4, atol=2e-3)
        # folding the batch into the GEMM's columns must not change any batch
        one = left(_t(w, cuda_device), tuple(p[-1:] for p in _t(a, cuda_device)), _t(t, cuda_device))
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[-1:].cpu().numpy(), o.cpu().numpy(), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("form", sorted(FORMS))
    @pytest.mark.parametrize("b,m,k,n", RIGHT_CASES + [(3, 7, 33, 17), (2, 5, 9, 40), (4, 16, 8, 8),
                                                       (2, 500, 2, 2), (2, 3, 64, 5), (256, 512, 32, 32),
                                                       (1024, 512, 8, 8)])
    def test_stage_right(self, cuda_device, b, m, k, n, form):
        a, w = _planar(4, (b, m, k)), _planar(5, (n, k))
        before = fft_stage.LAUNCHES["stage_right"]
        got = FORMS[form][1](_t(a, cuda_device), _t(w, cuda_device))
        torch.cuda.synchronize()
        assert fft_stage.LAUNCHES["stage_right"] == before + 1
        exp = ref.stage_right_ref(_t(a, cuda_device), _t(w, cuda_device))
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(), rtol=2e-4, atol=2e-3)

    def test_stage_right_c64_returns_a_transposed_view(self, cuda_device):
        b, m, k, n = 3, 64, 32, 32
        a = torch.from_numpy(_c64(10, (b, m, k))).to(cuda_device)
        w = torch.from_numpy(_c64(11, (n, k))).to(cuda_device)
        got = fft_stage.stage_right_c64(a, w)
        assert got.shape == (b, m, n) and got.stride() == (m * n, 1, m)
        exp = ref.stage_right_c64_ref(a, w)
        np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(), rtol=2e-4, atol=2e-3)

    @pytest.mark.parametrize("lead,rows,c,p", PACK_CASES + [((2,), 100, 70, 3)])
    def test_chunk_twiddle_pack(self, cuda_device, lead, rows, c, p):
        chunk = torch.from_numpy(_c64(6, lead + (rows, c))).to(cuda_device)
        m = torch.from_numpy(_c64(7, (p, rows))).to(cuda_device)
        got = fft_stage.chunk_twiddle_pack_c64(chunk, m)
        torch.cuda.synchronize()
        exp = ref.chunk_twiddle_pack_ref(chunk, m)
        np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(), rtol=1e-5, atol=1e-5)

    def test_chunk_twiddle_pack_reads_strided_rows(self, cuda_device):
        block = torch.from_numpy(_c64(8, (2, 64, 96))).to(cuda_device)
        chunk = block[..., 32:64]  # a peer's columns: rows keep the block's stride
        m = torch.from_numpy(_c64(9, (3, 64))).to(cuda_device)
        got = fft_stage.chunk_twiddle_pack_c64(chunk, m)
        exp = ref.chunk_twiddle_pack_ref(chunk, m)
        np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("layout", ACC_LAYOUTS)
    @pytest.mark.parametrize("lead,rows,c,p", ACC_CASES + [((2,), 101, 67, 3), ((3,), 130, 257, 2),
                                                          ((), 257, 96, 4), ((2,), 66, 129, 2)])
    def test_chunk_twiddle_pack_modes_and_layouts(self, cuda_device, lead, rows, c, p, layout):
        """Both modes and both chunk layouts against the plain version at
        ragged shapes (odd rows fall to the scalar tail), each one counted
        launch with its mode and layout in SHAPES."""
        chunk, m, out, _, whole = _acc_operands(lead, rows, c, p, layout, cuda_device)
        unit = "rows" if layout == "rows-unit" and rows > 1 and c > 1 else "cols"
        B = int(np.prod(lead, dtype=int))
        fft_stage.reset_launches()
        fresh = fft_stage.chunk_twiddle_pack_c64(chunk, m)
        exp = ref.chunk_twiddle_pack_ref(chunk, m)
        assert fresh.is_contiguous()
        np.testing.assert_allclose(fresh.cpu().numpy(), exp.cpu().numpy(), rtol=1e-5, atol=1e-5)
        expect = out.clone().add_(exp)
        before = whole.clone()
        assert fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out) is out
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), expect.cpu().numpy(), rtol=1e-5, atol=1e-5)
        if layout == "slot":
            assert torch.equal(whole[..., :rows], before[..., :rows])
            assert torch.equal(whole[..., 2 * rows :], before[..., 2 * rows :])
        assert fft_stage.LAUNCHES["chunk_twiddle_pack_c64"] == 2
        assert fft_stage.SHAPES["chunk_twiddle_pack_c64"] == {
            (B, rows, c, p, "fresh", unit): 1, (B, rows, c, p, "accumulate", unit): 1}

    def test_chunk_twiddle_pack_raises_for_unlaunchable_layouts(self, cuda_device):
        m = torch.from_numpy(_c64(7, (2, 4))).to(cuda_device)
        both = torch.from_numpy(_c64(6, (8, 12))).to(cuda_device)[::2, ::2]  # (4, 6), strided both ways
        before = fft_stage.LAUNCHES["chunk_twiddle_pack_c64"]
        with pytest.raises(ValueError, match="unit-stride along its rows or its columns"):
            fft_stage.chunk_twiddle_pack_c64(both, m)
        chunk = both.contiguous()
        out = torch.zeros((4, 2, 6), dtype=torch.complex64, device=cuda_device).permute(2, 1, 0)  # (6, 2, 4)
        with pytest.raises(ValueError, match="last axis must be unit-stride"):
            fft_stage.chunk_twiddle_pack_c64(chunk, m, out=out)
        with pytest.raises(ValueError, match="lazy conj"):
            fft_stage.chunk_twiddle_pack_c64(chunk, m, out=torch.zeros((6, 2, 4), dtype=torch.complex64,
                                                                      device=cuda_device).conj())
        assert fft_stage.LAUNCHES["chunk_twiddle_pack_c64"] == before

    def test_wrappers_raise_instead_of_falling_back(self, cuda_device):
        w = _t(_planar(1, (8, 4)), cuda_device)
        a = tuple(p.double() for p in _t(_planar(2, (2, 4, 3)), cuda_device))
        t = _t(_planar(3, (8, 3)), cuda_device)
        with pytest.raises(ValueError, match="float32"):
            fft_stage.stage_left(w, a, t)
        a = tuple(p.transpose(-1, -2).contiguous().transpose(-1, -2) for p in _t(_planar(2, (2, 4, 3)), cuda_device))
        with pytest.raises(ValueError, match="contiguous"):
            fft_stage.stage_left(w, a, t)
        # the complex64 entry points
        wc, tc = (torch.complex(*x) for x in (w, t))
        ac = torch.from_numpy(_c64(2, (2, 4, 3))).to(cuda_device)
        with pytest.raises(ValueError, match="complex64"):
            fft_stage.stage_left_c64(wc, ac.to(torch.complex128), tc)
        with pytest.raises(ValueError, match="contiguous"):
            fft_stage.stage_left_c64(wc, ac.mT.contiguous().mT, tc)
        with pytest.raises(ValueError, match="lazy conj"):
            fft_stage.stage_left_c64(wc.conj(), ac, tc)
        w2 = torch.from_numpy(_c64(3, (5, 3))).to(cuda_device)
        with pytest.raises(ValueError, match="complex64"):
            fft_stage.stage_right_c64(ac.to(torch.complex128), w2)
        with pytest.raises(ValueError, match="contiguous"):
            fft_stage.stage_right_c64(ac, w2.mT.contiguous().mT)
        with pytest.raises(ValueError, match=r"w must be \(5, 3\)"):
            fft_stage.stage_right_c64(ac, w2[:, :2].contiguous())

    def test_fft_last_axis_holds_fp32_precision(self, cuda_device):
        """n = 16384 at a main-path-like batch: one-pass TF32 products
        reach ~4e-4 here (test_one_pass_tf32_misses_the_fft_tolerance_...)."""
        x = torch.from_numpy(_c64(12, (64, 16384))).to(cuda_device)
        before = dict(fft_stage.LAUNCHES)
        got = ops.fft_last_axis(x)
        assert fft_stage.LAUNCHES["stage_left"] == before["stage_left"] + 1
        assert fft_stage.LAUNCHES["stage_right"] == before["stage_right"] + 1
        exp = torch.fft.fft(x)
        assert ((got - exp).abs().max() / exp.abs().max()).item() <= 2e-5

    @pytest.mark.parametrize("n", [1024, 4096, 16384, 1000])
    @pytest.mark.parametrize("inverse", [False, True])
    def test_fft_last_axis(self, cuda_device, n, inverse):
        x = torch.from_numpy(_c64(n, (4, n))).to(cuda_device)
        got = ops.fft_last_axis(x, inverse=inverse)
        exp = ref.fft_last_axis_ref(x, inverse=inverse)
        assert ((got - exp).abs().max() / exp.abs().max()).item() < 2e-5
