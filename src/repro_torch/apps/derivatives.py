"""Spectral derivatives on a distributed plan: gradient and laplacian.

Differentiation is multiplication by ``i*k`` (or ``-|k|^2``) in
frequency space; the wavenumber grids come from the plan's
:meth:`~repro_torch.core.Plan.spectral_axes` contract, so the same code
runs in the slab-transposed and Hermitian-padded layouts. Real plans
keep everything real outside the transform: the derivative of a real
field through an r2c plan is computed on the half spectrum and lands
back as a real array.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.apps.spectral import plan_directions, wavenumbers


def gradient(u: torch.Tensor, plan, lengths: Optional[Sequence[float]] = None) -> Tuple[torch.Tensor, ...]:
    """``(du/dx_0, ..., du/dx_{ndim-1})``, ordered like the trailing
    transform axes of the input. One forward transform, one inverse per
    component."""
    fwd, inv = plan_directions(plan)
    uh = fwd(u)
    return tuple(inv(uh * (1j * k)) for k in wavenumbers(plan, lengths))


def laplacian(u: torch.Tensor, plan, lengths: Optional[Sequence[float]] = None) -> torch.Tensor:
    """``sum_d d^2 u / dx_d^2`` via one forward + one inverse transform."""
    fwd, inv = plan_directions(plan)
    ks = wavenumbers(plan, lengths)
    k2 = sum(k * k for k in ks)
    return inv(fwd(u) * (-k2))
