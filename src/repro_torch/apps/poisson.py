"""Periodic FFT Poisson solver on a distributed plan.

Solves ``laplacian(u) = f`` on a periodic box by dividing the spectrum
by ``-|k|^2``: the textbook spectral method, but the transform is the
plan's distributed FFT, so the solve inherits the plan's collective
backend and r2c/c2r payload halving -- solving a real-field Poisson
problem through a ``plan_fft(real=True)`` plan moves half the wire
bytes of the complex path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.apps.spectral import plan_directions, wavenumbers


def solve_poisson(f: torch.Tensor, plan, lengths: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Solve ``laplacian(u) = f`` with periodic BCs; returns the
    zero-mean solution ``u`` (the ``k = 0`` mode is gauge freedom and is
    set to zero -- a solution only exists up to a constant, and only for
    zero-mean ``f``; any mean in ``f`` is projected out).

    ``plan`` must cover ``f``'s trailing dims (leading dims are batch);
    ``lengths`` are the domain sizes per transform axis (default
    ``2*pi``). Real plans take (and return) real fields.
    """
    fwd, inv = plan_directions(plan)
    ks = wavenumbers(plan, lengths)
    k2 = sum(k * k for k in ks)
    # -1/|k|^2 with the k=0 (and Hermitian-padding) entries zeroed
    scale = torch.where(k2 > 0, -1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    return inv(fwd(f) * scale)
