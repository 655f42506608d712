"""Port parity: repro_torch.core.fftmath against repro.core.fftmath.

Tables bit for bit, factor choice over a wide range, and local_fft for
every impl pair (torch/jnp, matmul/matmul, kernel/pallas) on the same
numpy input. The kernel impl runs its plain path here (CPU tensors);
the reference's pallas impl runs in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.fftmath as ref_lf
import repro.kernels.ops as ref_ops
import repro_torch.core.fftmath as lf
import repro_torch.kernels.ops as kops
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

IMPL_PAIRS = [("torch", "jnp"), ("matmul", "matmul"), ("kernel", "pallas")]


def _rand_c64(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("n", [1, 2, 4, 7, 8, 32, 512])
def test_dft_table_bit_identical(n, dtype):
    assert np.array_equal(lf._dft_matrix_np(n, dtype), ref_lf._dft_matrix_np(n, dtype))
    got = lf.dft_matrix(n, getattr(torch, dtype), "cpu").numpy()
    assert got.dtype == np.dtype(dtype)
    assert np.array_equal(got, ref_lf._dft_matrix_np(n, dtype))


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("n1,n2", [(4, 4096), (512, 32), (512, 8), (8, 16)])
def test_twiddle_table_bit_identical(n1, n2, dtype):
    assert np.array_equal(lf._twiddle_np(n1, n2, dtype), ref_lf._twiddle_np(n1, n2, dtype))
    got = lf.twiddle(n1, n2, getattr(torch, dtype), "cpu").numpy()
    assert np.array_equal(got, ref_lf._twiddle_np(n1, n2, dtype))


@pytest.mark.parametrize("lo", range(1, 70001, 10000))
def test_split_factor_and_kernel_factors_agree(lo):
    for n in range(lo, min(lo + 10000, 70001)):
        assert lf.split_factor(n) == ref_lf.split_factor(n), n
        assert kops._kernel_factors(n) == ref_ops._kernel_factors(n), n


def test_main_path_factors_are_largest_factor():
    # the reference picks the LARGEST factor <= 512, not the one nearest sqrt(n)
    assert kops._kernel_factors(16384) == (512, 32)
    assert kops._kernel_factors(4096) == (512, 8)
    assert kops._kernel_factors(512) is None
    assert kops._kernel_factors(1021) is None


@pytest.mark.parametrize("impl,ref_impl", IMPL_PAIRS)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1024, 4096])
def test_local_fft_matches_reference(n, inverse, impl, ref_impl):
    x = _rand_c64(n + inverse, (3, n))
    got = lf.local_fft(torch.from_numpy(x), inverse=inverse, impl=impl).numpy()
    exp = np.asarray(ref_lf.local_fft(jnp.asarray(x), inverse=inverse, impl=ref_impl))
    assert got.dtype == np.complex64
    scale = np.abs(exp).max()
    assert np.abs(got - exp).max() / scale < 2e-5
    oracle = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 2e-5


@pytest.mark.parametrize("impl", ["torch", "matmul", "kernel"])
def test_local_fft_axis_argument(impl):
    x = _rand_c64(7, (4, 8, 16))
    got = lf.local_fft(torch.from_numpy(x), axis=1, impl=impl).numpy()
    exp = np.fft.fft(x, axis=1)
    assert np.abs(got - exp).max() / np.abs(exp).max() < 1e-5


@pytest.mark.parametrize("n", [1, 2, 100, 384, 1021, 12288])
def test_fft_matmul_matches_reference(n):
    x = _rand_c64(n, (2, n))
    got = lf.fft_matmul(torch.from_numpy(x)).numpy()
    exp = np.asarray(ref_lf.fft_matmul(jnp.asarray(x)))
    assert np.abs(got - exp).max() / (np.abs(exp).max() + 1e-9) < 2e-5
    z = lf.fft_matmul(torch.from_numpy(got), inverse=True).numpy()
    assert np.abs(z - x).max() < 1e-4


def test_local_fft2_and_unknown_impl():
    x = _rand_c64(3, (2, 16, 32))
    got = lf.local_fft2(torch.from_numpy(x), impl="matmul").numpy()
    assert np.abs(got - np.fft.fft2(x)).max() / np.abs(np.fft.fft2(x)).max() < 1e-5
    with pytest.raises(ValueError, match="unknown local FFT impl"):
        lf.local_fft(torch.from_numpy(x), impl="jnp")
