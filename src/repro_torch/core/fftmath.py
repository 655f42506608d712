"""Local (on-device) FFT in matmul form, PyTorch port of
``repro.core.fftmath``.

For a length-``n`` transform with ``n = n1 * n2`` (the Cooley-Tukey /
Bailey four-step factorization)::

    A           = x.reshape(n1, n2)                    # j = j1*n2 + j2
    B[k1, j2]   = sum_j1 W_n1[k1, j1] * A[j1, j2]      # DFT over j1  (matmul)
    C[k1, j2]   = B[k1, j2] * exp(-2*pi*i*k1*j2 / n)   # twiddle
    D[k1, k2]   = sum_j2 C[k1, j2] * W_n2[k2, j2]      # DFT over j2  (matmul)
    X[k1+n1*k2] = D[k1, k2]                            # transposed read-out

The recursion bottoms out at a direct DFT matmul of size <= ``max_dft``.

Implementations (``impl=``), each the counterpart of a reference name:

``"torch"``  (reference ``"jnp"``)    -- ``torch.fft``, the oracle path.
``"matmul"`` (reference ``"matmul"``) -- the four-step DFT matmuls above.
``"kernel"`` (reference ``"pallas"``) -- both four-step stages in the
hand-written Hopper kernels (:mod:`repro_torch.kernels.ops`).

All twiddle/DFT tables are computed host-side in float64 numpy and then
cast -- bit for bit the reference's tables -- which keeps the matmul-FFT
error ~1e-5 relative even for n = 2^14.
"""

from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import torch

LocalImpl = Literal["torch", "matmul", "kernel"]

#: Largest direct DFT-matrix applied as a single matmul (the reference's
#: value, kept for parity: the four-step factors, and so the kernels'
#: shapes, follow from it).
MAX_DFT = 512


@functools.lru_cache(maxsize=64)
def _dft_matrix_np(n: int, dtype: str = "complex64") -> np.ndarray:
    """DFT matrix W[k, j] = exp(-2*pi*i*k*j/n), computed in float64 and
    cast to ``dtype`` (the fused exchange stages keep complex128 tables
    so c128 transforms stay at double precision)."""
    k = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(k, k) / n).astype(dtype)


@functools.lru_cache(maxsize=64)
def _twiddle_np(n1: int, n2: int, dtype: str = "complex64") -> np.ndarray:
    """Four-step twiddle T[k1, j2] = exp(-2*pi*i*k1*j2/(n1*n2)), float64."""
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(k1, j2) / (n1 * n2)).astype(dtype)


def _np_name(dtype: torch.dtype) -> str:
    if dtype == torch.complex64:
        return "complex64"
    if dtype == torch.complex128:
        return "complex128"
    raise ValueError(f"DFT tables are complex64 or complex128, got {dtype}")


@functools.lru_cache(maxsize=128)
def _table(kind: str, dims: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    # one upload per (table, device): the tables are read-only constants
    arr = _dft_matrix_np(*dims, _np_name(dtype)) if kind == "dft" else _twiddle_np(
        *dims, _np_name(dtype)
    )
    return torch.from_numpy(arr).to(device)


def dft_matrix(n: int, dtype=torch.complex64, device="cpu") -> torch.Tensor:
    return _table("dft", (n,), dtype, str(torch.device(device)))


def twiddle(n1: int, n2: int, dtype=torch.complex64, device="cpu") -> torch.Tensor:
    return _table("twiddle", (n1, n2), dtype, str(torch.device(device)))


def split_factor(n: int, max_dft: int = MAX_DFT) -> int:
    """Pick n1 | n with n1 <= max_dft: the LARGEST such factor (the
    reference's behaviour, kept for parity -- its docstring's "as close
    to sqrt(n) as possible" is not what it computes).

    Returns 0 if ``n`` has no factor in [2, max_dft] (prime beyond the
    direct-DFT limit) -- the caller falls back to a direct O(n^2) DFT.
    """
    if n <= max_dft:
        return n
    best = 0
    f = 2
    while f * f <= n:
        if n % f == 0:
            for cand in (n // f, f):
                if cand <= max_dft and cand > best:
                    best = cand
        f += 1
    return best


def _fft_matmul_c64(x: torch.Tensor, max_dft: int) -> torch.Tensor:
    """Forward FFT along the last axis via recursive four-step matmuls."""
    n = x.shape[-1]
    if n == 1:
        return x
    n1 = split_factor(n, max_dft)
    if n1 in (0, n):
        # Direct DFT: either small enough, or prime beyond the limit.
        return x @ dft_matrix(n, device=x.device).T
    n2 = n // n1
    a = x.reshape(x.shape[:-1] + (n1, n2))
    b = dft_matrix(n1, device=x.device) @ a
    b = b * twiddle(n1, n2, device=x.device)
    c = _fft_matmul_c64(b, max_dft)  # transform along last (j2 -> k2) axis
    d = c.transpose(-1, -2)  # (..., k2, k1): index k1 + n1*k2
    return d.reshape(x.shape[:-1] + (n,))


def fft_matmul(x: torch.Tensor, *, inverse: bool = False, max_dft: int = MAX_DFT) -> torch.Tensor:
    """FFT along the last axis, matmul formulation. Unnormalized forward;
    inverse carries the 1/n factor (matches torch.fft). Computes in
    complex64, as the reference does."""
    x = x.to(torch.complex64)
    if inverse:
        n = x.shape[-1]
        return torch.conj(_fft_matmul_c64(torch.conj(x), max_dft)).resolve_conj() / n
    return _fft_matmul_c64(x, max_dft)


def local_fft(
    x: torch.Tensor,
    *,
    axis: int = -1,
    inverse: bool = False,
    impl: LocalImpl = "torch",
    max_dft: int = MAX_DFT,
) -> torch.Tensor:
    """1-D FFT along ``axis`` with a selectable implementation (see the
    module docstring for the impl names)."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    if axis != -1 and axis != x.ndim - 1:
        x = torch.movedim(x, axis, -1)
        y = local_fft(x, axis=-1, inverse=inverse, impl=impl, max_dft=max_dft)
        return torch.movedim(y, -1, axis)
    if impl == "torch":
        return torch.fft.ifft(x, norm="backward") if inverse else torch.fft.fft(x)
    if impl == "matmul":
        return fft_matmul(x, inverse=inverse, max_dft=max_dft)
    if impl == "kernel":
        # imported lazily, as the reference imports its kernels
        from repro_torch.kernels import ops as kops

        return kops.fft_last_axis(x, inverse=inverse)
    raise ValueError(f"unknown local FFT impl: {impl!r}")


def local_fft2(x: torch.Tensor, *, inverse: bool = False, impl: LocalImpl = "torch") -> torch.Tensor:
    """2-D FFT over the last two axes (single-device reference)."""
    y = local_fft(x, axis=-1, inverse=inverse, impl=impl)
    return local_fft(y, axis=-2, inverse=inverse, impl=impl)
