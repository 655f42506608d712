"""Distributed FFT convolution / correlation through a plan.

Circular (periodic) convolution via the convolution theorem: two forward
transforms, a pointwise product, one inverse -- every transform being
the plan's distributed FFT. With a real plan both operands and the
result stay real and every exchange ships the Hermitian-truncated
payload. For linear (non-circular) convolution, zero-pad the operands to
``len(a) + len(b) - 1`` per axis before planning, as usual.
"""

from __future__ import annotations

import torch

from repro_torch.apps.spectral import plan_directions


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ValueError(
            f"fft convolution operands must share a shape (and the plan's "
            f"layout), got {tuple(a.shape)} vs {tuple(b.shape)}"
        )


def fft_convolve(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """Circular convolution ``(a * b)[n] = sum_m a[m] b[n-m]`` over the
    plan's transform axes (leading dims are batch)."""
    _check_shapes(a, b)
    fwd, inv = plan_directions(plan)
    return inv(fwd(a) * fwd(b))


def fft_correlate(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """Circular cross-correlation ``c[n] = sum_m a[m + n] conj(b[m])``
    over the plan's transform axes."""
    _check_shapes(a, b)
    fwd, inv = plan_directions(plan)
    return inv(torch.conj(fwd(b)) * fwd(a))
