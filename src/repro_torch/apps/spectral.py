"""Shared spectral plumbing: wavenumber grids in the plan's own layout.

A distributed plan's spectrum is rarely the natural ``fftn`` layout --
slab 2-D output is transposed, pencil 3-D output is axis-reversed, real
plans carry a shard-padded Hermitian axis. Anything multiplying in
frequency space (Poisson, derivatives, filters) therefore needs the
frequency of every *output* position, not of the natural layout.
:meth:`repro_torch.core.Plan.spectral_axes` is the layout contract;
:func:`wavenumbers` turns it into broadcast-ready coordinate tensors,
so the solvers in this package are written once and run under every
decomposition x backend x real/complex x mesh combination the plan layer supports.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def plan_directions(plan) -> Tuple:
    """(to_spectrum, from_spectrum) callables of a plan, regardless of
    which direction it was planned in."""
    if plan.direction == "forward":
        return plan.execute, plan.inverse
    return plan.inverse, plan.execute


def wavenumbers(plan, lengths: Optional[Sequence[float]] = None) -> Tuple[torch.Tensor, ...]:
    """Angular wavenumbers ``k_d`` for each original transform axis,
    shaped to broadcast against the plan's spectrum layout, on the
    plan's mesh device.

    ``lengths[d]`` is the physical domain length of original data axis
    ``d`` (ordered like the trailing ``plan.ndim`` dims of the input;
    default ``2*pi`` each, making ``k`` the integer mode numbers). The
    returned tuple is ordered by *original* axis, each entry a tensor of
    ones-except-one-dim shape placed at that axis's position in the
    spectrum layout -- ``sum(k*k for k in wavenumbers(plan))`` is
    ``|k|^2`` in the plan's own output layout. On a ``ProcessGroupMesh``
    each entry placed at a sharded position of the spectrum
    (:meth:`~repro_torch.core.Plan.spectrum_tail`: the slab's leading
    dim, both of a pencil plan's leading dims) holds the rank's own
    block of it.

    Padded Hermitian positions get ``k = 0``: the plan guarantees the
    data there is exactly zero, so any multiplicative use is unaffected.
    """
    nd = plan.ndim
    axes = plan.spectral_axes()
    if lengths is None:
        lengths = (2 * np.pi,) * nd
    lengths = tuple(float(L) for L in lengths)
    if len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries (one per transform axis), got {len(lengths)}")
    mesh = plan.mesh
    spec = plan.spectrum_tail()
    out = [None] * nd
    for pos, ax in enumerate(axes):
        scale = 2 * np.pi / lengths[ax.orig + nd]
        if ax.half:
            k = np.fft.rfftfreq(ax.n) * ax.n * scale
            k = np.pad(k, (0, ax.n_out - k.shape[0]))
        else:
            k = np.fft.fftfreq(ax.n) * ax.n * scale
        shape = [1] * nd
        shape[pos] = ax.n_out
        kt = torch.as_tensor(k.reshape(shape), dtype=plan.dtype.to_real(), device=mesh.device)
        if spec[pos] is not None:  # this rank's block of the sharded position
            kt = mesh.global_output(kt, tuple(a if i == pos else None for i, a in enumerate(spec)))
        out[ax.orig + nd] = kt
    return tuple(out)
