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


@pytest.mark.parametrize("b,m,k,n", LEFT_CASES)
def test_stage_left_matches_reference(b, m, k, n):
    _, ref_ops, _ = _reference()
    w, a, t = _planar(1, (m, k)), _planar(2, (b, k, n)), _planar(3, (m, n))
    before = dict(fft_stage.LAUNCHES)
    got = ops.stage_left(_t(w), _t(a), _t(t))
    exp = ref_ops.stage_left(w, a, t)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-4, atol=2e-3)
    assert fft_stage.LAUNCHES == before  # the plain path launches nothing


@pytest.mark.parametrize("b,m,k,n", RIGHT_CASES)
def test_stage_right_matches_reference(b, m, k, n):
    _, ref_ops, _ = _reference()
    a, w = _planar(4, (b, m, k)), _planar(5, (n, k))
    got = ops.stage_right(_t(a), _t(w))
    exp = ref_ops.stage_right(a, w)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-4, atol=2e-3)


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
    @pytest.mark.parametrize("b,m,k,n", LEFT_CASES + [(3, 100, 37, 5)])
    def test_stage_left(self, cuda_device, b, m, k, n):
        w, a, t = _planar(1, (m, k)), _planar(2, (b, k, n)), _planar(3, (m, n))
        before = fft_stage.LAUNCHES["stage_left"]
        got = fft_stage.stage_left(_t(w, cuda_device), _t(a, cuda_device), _t(t, cuda_device))
        torch.cuda.synchronize()
        assert fft_stage.LAUNCHES["stage_left"] == before + 1
        exp = ref.stage_left_ref(_t(w, cuda_device), _t(a, cuda_device), _t(t, cuda_device))
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(), rtol=2e-4, atol=2e-3)
        # folding the batch into the GEMM's columns must not change any batch
        one = fft_stage.stage_left(_t(w, cuda_device), tuple(p[-1:] for p in _t(a, cuda_device)),
                                   _t(t, cuda_device))
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[-1:].cpu().numpy(), o.cpu().numpy(), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("b,m,k,n", RIGHT_CASES + [(3, 7, 33, 17), (2, 5, 9, 40), (4, 16, 8, 8)])
    def test_stage_right(self, cuda_device, b, m, k, n):
        a, w = _planar(4, (b, m, k)), _planar(5, (n, k))
        got = fft_stage.stage_right(_t(a, cuda_device), _t(w, cuda_device))
        torch.cuda.synchronize()
        exp = ref.stage_right_ref(_t(a, cuda_device), _t(w, cuda_device))
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(), rtol=2e-4, atol=2e-3)

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

    def test_wrappers_raise_instead_of_falling_back(self, cuda_device):
        w = _t(_planar(1, (8, 4)), cuda_device)
        a = tuple(p.double() for p in _t(_planar(2, (2, 4, 3)), cuda_device))
        t = _t(_planar(3, (8, 3)), cuda_device)
        with pytest.raises(ValueError, match="float32"):
            fft_stage.stage_left(w, a, t)
        a = tuple(p.transpose(-1, -2).contiguous().transpose(-1, -2) for p in _t(_planar(2, (2, 4, 3)), cuda_device))
        with pytest.raises(ValueError, match="contiguous"):
            fft_stage.stage_left(w, a, t)

    @pytest.mark.parametrize("n", [1024, 4096, 16384, 1000])
    @pytest.mark.parametrize("inverse", [False, True])
    def test_fft_last_axis(self, cuda_device, n, inverse):
        x = torch.from_numpy(_c64(n, (4, n))).to(cuda_device)
        got = ops.fft_last_axis(x, inverse=inverse)
        exp = ref.fft_last_axis_ref(x, inverse=inverse)
        assert ((got - exp).abs().max() / exp.abs().max()).item() < 2e-5
