"""Distributed real-to-complex FFTs (rfftn / irfftn) over the backend
registry -- half the wire bytes for real-input workloads. PyTorch port
of ``repro.core.real``, slab and pencil.

The paper's FFTW3+MPI reference is what scientific users drive with
*real* data: an r2c transform keeps only the Hermitian-non-redundant
half of the last axis (``H = N//2 + 1`` complex values instead of
``N``), so every exchange after the first local pass ships about half
the bytes of the complex-to-complex path.

- the r2c pass runs **locally on the contiguous last axis** (it is the
  only pass whose input is real);
- every remaining pass is an ordinary c2c FFT fed through the same
  strategy-switched exchange (:mod:`repro_torch.core.transpose`), so
  the whole backend registry applies unchanged -- just on the truncated
  payload, fused into the arriving chunks on streaming backends;
- c2r mirrors the chain in reverse and restores the real layout.

**The N//2+1 divisibility problem.** ``H`` is almost never divisible by
the shard count. With ``pad=True`` (default) the half spectrum is
zero-padded to the next divisible length ``Hp`` before the exchange and
the pad is trimmed wherever the axis ends up local again; the padded
tail is exactly zero. With ``pad=False`` a non-divisible ``H`` raises a
plan-time ``ValueError`` naming the offending data axis and the mesh
dimension.

Spectrum layouts (global values; ``H``/``Hp`` along the original last
axis):

====================  =====================================================
slab ``rfft2``        ``(..., Hp, R)`` transposed, Hp-sharded (the slab
                      c2c convention); ``transpose_back`` -> exact
                      natural ``(..., R, H)``
slab ``rfft3``        natural ``(..., D0, D1, H)``, D0-sharded (exact)
pencil ``rfft2``      natural ``(..., R, Hp)``, (rows, cols)-sharded
pencil ``rfft3``      reversed ``(..., Hp, D1, D0)``, (cols, rows)-sharded;
                      ``transpose_back`` -> exact natural
====================  =====================================================

Each ``irfft*`` consumes exactly the layout its ``rfft*`` produces.
``n_last`` (the original real length) is explicit on every inverse --
``H`` alone cannot distinguish even ``2*(H-1)`` from odd ``2*H-1``.

Arrays are the mesh's caller arrays: global on a
:class:`~repro_torch.core.mesh.SimMesh`, the rank's own block on a
:class:`~repro_torch.core.mesh.ProcessGroupMesh`. Every transform is a
thin builder over :mod:`repro_torch.core.schedule`.
"""

from __future__ import annotations

import torch

import repro_torch.core.schedule as sch
from repro_torch.core import backends
from repro_torch.core.distributed_fft import FFTConfig
from repro_torch.core.grid import ProcessGrid
from repro_torch.core.mesh import Mesh
from repro_torch.core.pencil import PencilConfig, _check_backends
from repro_torch.core.schedule import (  # noqa: F401  (re-exported API)
    _pad_disabled_hint,
    local_irfft,
    local_rfft,
    padded_rfft_len,
    rfft_len,
)


def check_divisible_slab(global_shape, p: int, ndim: int, axis_name, *, pad: bool = True):
    """Validate a slab r2c problem; returns ``(h, hp)`` for the Hermitian
    axis. Raises a ValueError naming the offending data axis and mesh
    axis -- delegates to the one schedule-level validator
    (:func:`repro_torch.core.schedule.check_divisible`)."""
    return sch.check_divisible(global_shape, ndim, p=p, axis_name=axis_name, real=True, pad=pad)


def check_divisible_pencil(global_shape, grid: ProcessGrid, ndim: int, *, pad: bool = True):
    """Validate a pencil r2c problem; returns ``(h, hp)``. Errors name
    the data axis and grid dimension -- delegates to the one
    schedule-level validator."""
    return sch.check_divisible(
        global_shape, ndim, p_rows=grid.p_rows, p_cols=grid.p_cols,
        row_axis=grid.row_axis, col_axis=grid.col_axis, real=True, pad=pad,
    )


def _build_slab(shape, mesh: Mesh, axis_name: str, cfg: FFTConfig, *, ndim, inverse, pad) -> sch.Schedule:
    backends.get(cfg.strategy)  # raises listing the registry
    return sch.build_schedule(
        shape, ndim=ndim, inverse=inverse, real=True, decomp="slab",
        axis_name=axis_name, p=mesh.shape[axis_name], backend=cfg.strategy,
        fused=cfg.fused, n_chunks=cfg.n_chunks,
        transpose_back=cfg.transpose_back, pad=pad,
    )


def rfft2(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(), *,
          pad: bool = True) -> torch.Tensor:
    """Slab-decomposed 2-D r2c FFT of real (..., R, C), R sharded.

    Returns the transposed half spectrum ``(..., Hp, C->R)`` (global
    value ``rfftn(x).swapaxes(-1, -2)`` with ``Hp - H`` zero rows
    appended), Hp-sharded -- the one exchange ships only the Hermitian
    payload. ``cfg.transpose_back`` restores the exact natural
    ``(..., R, H)`` layout with a second (equally truncated) exchange.
    """
    shape = mesh.global_shape(x.shape, (axis_name, None))
    plan = _build_slab(shape, mesh, axis_name, cfg, ndim=2, inverse=False, pad=pad)
    return sch.run_schedule(x, plan, mesh, impl=cfg.local_impl)


def irfft2(y: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(),
           n_last: int = 0, *, pad: bool = True) -> torch.Tensor:
    """Inverse of :func:`rfft2`: consumes exactly its layout (transposed
    padded half spectrum, or natural when ``cfg.transpose_back``) and
    returns the real (..., R, C=``n_last``), R sharded."""
    if n_last <= 0:
        raise ValueError("irfft2 needs n_last (the original real length of axis -1)")
    yshape = mesh.global_shape(y.shape, (axis_name, None))
    r_glob = yshape[-2] if cfg.transpose_back else yshape[-1]
    shape = yshape[:-2] + (r_glob, n_last)
    plan = _build_slab(shape, mesh, axis_name, cfg, ndim=2, inverse=True, pad=pad)
    h, hp = plan.h, plan.hp
    expect = (r_glob, h) if cfg.transpose_back else (hp, r_glob)
    if yshape[-2:] != expect:
        raise ValueError(
            f"irfft2: spectrum axes {yshape[-2:]} do not match the rfft2 "
            f"layout {expect} for n_last={n_last} "
            f"(transpose_back={cfg.transpose_back}, pad={pad})"
        )
    return sch.run_schedule(y, plan, mesh, impl=cfg.local_impl)


def rfft3(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(), *,
          pad: bool = True) -> torch.Tensor:
    """Slab-decomposed 3-D r2c FFT of real (..., D0, D1, D2), D0 sharded.

    Exact natural output ``(..., D0, D1, H)`` = ``numpy.fft.rfftn`` over
    the last three axes (the internal ``Hp`` padding rides the two
    exchanges flattened with D1 and is trimmed before returning -- the
    trim is free because the Hermitian axis ends up local)."""
    shape = mesh.global_shape(x.shape, (axis_name, None, None))
    plan = _build_slab(shape, mesh, axis_name, cfg, ndim=3, inverse=False, pad=pad)
    return sch.run_schedule(x, plan, mesh, impl=cfg.local_impl)


def irfft3(y: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(),
           n_last: int = 0, *, pad: bool = True) -> torch.Tensor:
    """Inverse of :func:`rfft3`: natural half spectrum (..., D0, D1, H)
    to the real (..., D0, D1, ``n_last``), D0 sharded."""
    if n_last <= 0:
        raise ValueError("irfft3 needs n_last (the original real length of axis -1)")
    yshape = mesh.global_shape(y.shape, (axis_name, None, None))
    plan = _build_slab(yshape[:-1] + (n_last,), mesh, axis_name, cfg, ndim=3, inverse=True, pad=pad)
    if yshape[-1] != plan.h:
        raise ValueError(
            f"irfft3: Hermitian axis has length {yshape[-1]}, expected "
            f"{n_last}//2+1={plan.h} for n_last={n_last}"
        )
    return sch.run_schedule(y, plan, mesh, impl=cfg.local_impl)


# ---------------------------------------------------------------------------
# Pencil r2c / c2r
# ---------------------------------------------------------------------------


def _build_pencil(shape, grid: ProcessGrid, cfg: PencilConfig, *, ndim, inverse, pad) -> sch.Schedule:
    return sch.build_schedule(
        shape, ndim=ndim, inverse=inverse, real=True, decomp="pencil",
        row_axis=grid.row_axis, col_axis=grid.col_axis,
        p_rows=grid.p_rows, p_cols=grid.p_cols,
        backend_row=cfg.backend_row, backend_col=cfg.backend_col,
        fused=cfg.fused, n_chunks=cfg.n_chunks,
        transpose_back=cfg.transpose_back, pad=pad,
    )


def _natural(grid: ProcessGrid, ndim: int):
    """The (rows, cols)-sharded tail of a pencil array."""
    return (grid.row_axis, grid.col_axis) + (None,) * (ndim - 2)


def pencil_rfft3(x: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig = PencilConfig(), *,
                 pad: bool = True) -> torch.Tensor:
    """Pencil-decomposed 3-D r2c FFT of real (..., D0, D1, D2) with D0
    sharded over ``grid.row_axis`` and D1 over ``grid.col_axis``.

    Returns the reversed-axes half spectrum ``(..., Hp, D1, D0)``
    (global value ``rfftn(x).permute(..., -1, -2, -3)`` with zero rows
    appended) sharded (Hp over cols, D1 over rows) -- the c2c pencil
    convention on the truncated payload. ``cfg.transpose_back`` restores
    the exact natural ``(..., D0, D1, H)`` with two more sub-exchanges.
    """
    _check_backends(cfg, grid)
    shape = grid.mesh.global_shape(x.shape, _natural(grid, 3))
    plan = _build_pencil(shape, grid, cfg, ndim=3, inverse=False, pad=pad)
    return sch.run_schedule(x, plan, grid.mesh, impl=cfg.local_impl)


def pencil_irfft3(y: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig = PencilConfig(),
                  n_last: int = 0, *, pad: bool = True) -> torch.Tensor:
    """Inverse of :func:`pencil_rfft3`: consumes exactly its layout
    (reversed padded half spectrum, or exact natural when
    ``cfg.transpose_back``) and returns the real (..., D0, D1,
    ``n_last``) sharded (rows, cols)."""
    _check_backends(cfg, grid)
    if n_last <= 0:
        raise ValueError("pencil_irfft3 needs n_last (the original real length of axis -1)")
    if cfg.transpose_back:
        yshape = grid.mesh.global_shape(y.shape, _natural(grid, 3))
        d0, d1 = yshape[-3], yshape[-2]
    else:
        yshape = grid.mesh.global_shape(y.shape, (grid.col_axis, grid.row_axis, None))
        d0, d1 = yshape[-1], yshape[-2]
    shape = yshape[:-3] + (d0, d1, n_last)
    plan = _build_pencil(shape, grid, cfg, ndim=3, inverse=True, pad=pad)
    expect = (d0, d1, plan.h) if cfg.transpose_back else (plan.hp, d1, d0)
    if yshape[-3:] != expect:
        raise ValueError(
            f"pencil_irfft3: spectrum axes {yshape[-3:]} do not match the "
            f"pencil_rfft3 layout {expect} for n_last={n_last} "
            f"(transpose_back={cfg.transpose_back}, pad={pad})"
        )
    return sch.run_schedule(y, plan, grid.mesh, impl=cfg.local_impl)


def pencil_rfft2(x: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig = PencilConfig(), *,
                 pad: bool = True) -> torch.Tensor:
    """Pencil-decomposed 2-D r2c FFT of real (..., R, C) with R sharded
    over ``grid.row_axis`` and C over ``grid.col_axis``.

    Natural-layout output ``(..., R, Hp)`` sharded (rows, cols), zero
    columns beyond ``H``. Four sub-exchanges, like the c2c
    :func:`~repro_torch.core.pencil.pencil_fft2` -- but only the first
    (which localizes the real axis for the r2c pass) ships full-width
    data, and at the *real* dtype. ``transpose_back`` is rejected
    (already natural)."""
    if cfg.transpose_back:
        raise ValueError(
            "pencil rfft2 already returns the natural layout; "
            "transpose_back applies to slab transforms and pencil rfft3 only"
        )
    _check_backends(cfg, grid)
    shape = grid.mesh.global_shape(x.shape, _natural(grid, 2))
    plan = _build_pencil(shape, grid, cfg, ndim=2, inverse=False, pad=pad)
    return sch.run_schedule(x, plan, grid.mesh, impl=cfg.local_impl)


def pencil_irfft2(y: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig = PencilConfig(),
                  n_last: int = 0, *, pad: bool = True) -> torch.Tensor:
    """Inverse of :func:`pencil_rfft2`: padded natural half spectrum
    (..., R, Hp) to the real (..., R, ``n_last``), both (rows, cols)
    sharded. The final (real-payload) exchange restores the real layout."""
    if cfg.transpose_back:
        raise ValueError(
            "pencil irfft2 consumes the natural layout; transpose_back "
            "applies to slab transforms and pencil rfft3 only"
        )
    _check_backends(cfg, grid)
    if n_last <= 0:
        raise ValueError("pencil_irfft2 needs n_last (the original real length of axis -1)")
    yshape = grid.mesh.global_shape(y.shape, _natural(grid, 2))
    plan = _build_pencil(yshape[:-1] + (n_last,), grid, cfg, ndim=2, inverse=True, pad=pad)
    if yshape[-1] != plan.hp:
        raise ValueError(
            f"pencil_irfft2: Hermitian axis has length {yshape[-1]}, expected "
            f"the padded {plan.hp} (H={plan.h}) for n_last={n_last} on grid "
            f"{grid.p_rows}x{grid.p_cols} (pad={pad})"
        )
    return sch.run_schedule(y, plan, grid.mesh, impl=cfg.local_impl)
