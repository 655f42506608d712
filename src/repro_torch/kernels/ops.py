"""Public wrappers around the Hopper FFT kernels.

``fft_last_axis(x)`` runs the four-step local FFT with both matmul stages
executed by the kernels (fft_stage.py):

    A = x.reshape(-1, n1, n2)
    B = stage_left_c64(W_n1, A, T_n1n2)  # column DFT + twiddle, fused
    D = stage_right_c64(B, W_n2)         # row DFT
    out[k1 + n1*k2] = D[k1, k2]

all in interleaved complex64. For CPU tensors the stage wrappers run
their plain PyTorch versions --
the same math, so the CPU tests check the path the card runs.

Factor choice (:func:`_kernel_factors`) is the reference's: n1 is the
LARGEST factor of n not above 512, so n = 16384 runs as (512, 32) and
n = 4096 as (512, 8). The kernels take every (n1, n2) it returns, so the
reference's TPU fallback for factors that are not multiples of 128 has
no counterpart; the only fallback left is the reference's own rule --
no factors (n <= 512, or no factor within reach) -- to the matmul FFT.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

import repro_torch.core.fftmath as lf
from repro_torch.kernels import fft_stage


@functools.lru_cache(maxsize=64)
def _tables(n1: int, n2: int, inverse: bool, device: str):
    """(W_n1, T_n1n2, W_n2) as complex64 on ``device``, built in float64.
    The inverse's tables are the conjugates, with 1/n folded into W_n2:
    conj(fft(conj(x))) / n with no conj or scale pass over the data."""
    w1 = lf.dft_matrix(n1, dtype=torch.complex128)
    tw = lf.twiddle(n1, n2, dtype=torch.complex128)
    w2 = lf.dft_matrix(n2, dtype=torch.complex128)
    if inverse:
        w1, tw, w2 = w1.conj(), tw.conj(), w2.conj() / (n1 * n2)
    return tuple(t.resolve_conj().to(torch.complex64).to(device) for t in (w1, tw, w2))


def _kernel_factors(n: int) -> Optional[tuple[int, int]]:
    """(n1, n2) with n1 * n2 = n, both <= MAX_DFT, or None."""
    n1 = lf.split_factor(n, lf.MAX_DFT)
    if n1 in (0, n):
        return None
    n2 = n // n1
    if n2 > lf.MAX_DFT:
        return None
    return n1, n2


def fft_last_axis(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """FFT along the last axis via the fused-stage kernels. Returns
    complex64 whatever the input precision, as the reference does.

    On the card the data stays interleaved complex64 throughout:
    ``stage_right_c64`` writes its result in the flattened order
    (k1 + n1*k2), so the final transpose and reshape are views."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    n = x.shape[-1]
    factors = _kernel_factors(n)
    if factors is None:
        return lf.fft_matmul(x, inverse=inverse)
    n1, n2 = factors
    lead = x.shape[:-1]
    a = x.to(torch.complex64).resolve_conj().reshape((-1, n1, n2)).contiguous()
    w1, tw, w2 = _tables(n1, n2, inverse, str(x.device))
    d = fft_stage.stage_right_c64(fft_stage.stage_left_c64(w1, a, tw), w2)  # (B, k1, k2)
    return d.transpose(-1, -2).reshape(lead + (n,))


def stage_left(w, a, t):
    """Fused complex (W@A)*T -- thin public re-export (planar operands)."""
    return fft_stage.stage_left(w, a, t)


def stage_right(a, w):
    """Complex A @ W^T -- thin public re-export (planar operands)."""
    return fft_stage.stage_right(a, w)
