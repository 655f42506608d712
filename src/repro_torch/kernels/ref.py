"""Plain PyTorch versions of the Hopper kernels (the allclose targets).

The wrappers in :mod:`repro_torch.kernels.fft_stage` run these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on
the card."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Planar = Tuple[torch.Tensor, torch.Tensor]


def _to_c(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re.float(), im.float())


def stage_left_c64_ref(w: torch.Tensor, a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(W @ A) * T, complex64: w (M,K), a (B,K,N), t (M,N) -> (B,M,N)."""
    return (w @ a) * t


def stage_right_c64_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A @ W^T, complex64: a (B,M,K), w (N,K) -> (B,M,N)."""
    return a @ w.T


def to_planes(c: torch.Tensor) -> Planar:
    """Complex -> contiguous (re, im) planes."""
    return c.real.contiguous(), c.imag.contiguous()


def stage_left_ref(w: Planar, a: Planar, t: Planar) -> Planar:
    """(W @ A) * T, complex planar: w (M,K), a (B,K,N), t (M,N)."""
    return to_planes(stage_left_c64_ref(_to_c(*w), _to_c(*a), _to_c(*t)))


def stage_right_ref(a: Planar, w: Planar) -> Planar:
    """A @ W^T, complex planar: a (B,M,K), w (N,K)."""
    return to_planes(stage_right_c64_ref(_to_c(*a), _to_c(*w)))


def chunk_twiddle_pack_ref(
    chunk: torch.Tensor, m: torch.Tensor, *, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """out[..., j, k, t] = chunk[..., t, j] * m[k, t]: the relayout of one
    arriving chunk (..., rows, c) -> (..., c, rows) followed by the
    broadcast multiply with ``m`` (p, rows) -- the two-op path of the
    fused exchange's chunk callback. With ``out`` (..., c, p, rows) the
    product is added to it in place (``out.add_``) and ``out`` returned."""
    ct = chunk.transpose(-1, -2)  # (..., c, rows)
    prod = ct[..., None, :] * m  # (..., c, p, rows)
    return prod if out is None else out.add_(prod)


def fft_last_axis_ref(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Oracle for ops.fft_last_axis: the library FFT."""
    x = x.to(torch.complex64)
    return torch.fft.ifft(x) if inverse else torch.fft.fft(x)
