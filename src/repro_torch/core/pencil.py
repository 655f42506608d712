"""Pencil-decomposed distributed FFTs over a 2-D process grid, PyTorch
port of ``repro.core.pencil``.

Slab decomposition (:mod:`repro_torch.core.distributed_fft`) shards one
data dimension over one mesh axis: parallelism caps at P <= N and every
transpose is one global exchange over all P ranks. The pencil
decomposition shards TWO data dimensions over a
(:class:`~repro_torch.core.grid.ProcessGrid`) of P_row x P_col
processes, so

- parallelism scales to P_row * P_col <= N0 * N1, and
- each transpose is a **sub-axis** exchange over only P_row or P_col
  ranks -- smaller rings, independently strategy-switched. ``scatter``
  over the rows axis and ``bisection`` over cols is a legal
  combination: the 2-D analogue of the paper's parcelport switch.

``pencil_fft3`` is the canonical shape: three local FFT passes
separated by two sub-axis transposes,

    (X/Pr, Y/Pc, Z)  --fft Z-->  --T_cols-->  (X/Pr, Z/Pc, Y)
                     --fft Y-->  --T_rows-->  (Z/Pc, Y/Pr, X)  --fft X-->

returning the reversed-axes spectrum ``fftn(x).permute(..., -1, -2, -3)``
(``transpose_back=True`` restores the natural layout with two more
sub-exchanges).

``pencil_fft2`` transforms each data dimension over its own grid axis
(transpose / FFT / transpose-back per axis -- four sub-exchanges, two
per sub-ring) and returns the **natural-layout** ``fft2(x)``. Both data
dims must divide P_row*P_col.

Every sub-exchange dispatches through :mod:`repro_torch.core.backends`
by name, exactly like the slab path; whole-transform (``kind="global"``)
backends have no per-rank transpose and are rejected per axis. Arrays
are the mesh's caller arrays: global on a
:class:`~repro_torch.core.mesh.SimMesh` grid, the rank's own block on a
:class:`~repro_torch.core.mesh.ProcessGroupMesh` grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import repro_torch.core.schedule as sch
from repro_torch.core import backends
from repro_torch.core.grid import ProcessGrid


@dataclasses.dataclass(frozen=True)
class PencilConfig:
    """Per-axis exchange strategy + local-FFT settings for the pencil
    transforms. ``backend_row``/``backend_col`` name registered per-rank
    backends, resolved and validated independently. ``transpose_back``
    applies to ``pencil_fft3`` only (``pencil_fft2`` is already
    natural-layout). ``fused`` folds each sub-exchange's following FFT
    pass into the arriving chunks wherever that leg's backend streams;
    ``n_chunks`` is the per-exchange total-chunk target."""

    backend_row: str = "alltoall"
    backend_col: str = "alltoall"
    local_impl: str = "torch"
    transpose_back: bool = False
    fused: bool = False
    n_chunks: Optional[int] = None


def _check_backends(cfg: PencilConfig, grid: ProcessGrid) -> None:
    for role, name, p in (
        ("row", cfg.backend_row, grid.p_rows),
        ("col", cfg.backend_col, grid.p_cols),
    ):
        b = backends.get(name)  # raises listing the registry
        if b.kind != "shard_map":
            raise ValueError(
                f"backend_{role}={name!r} is a whole-transform backend; "
                f"pencil sub-axis exchanges need shard_map backends "
                f"({list(backends.available(kind='shard_map'))})"
            )
        if not b.supports(p):
            raise ValueError(
                f"backend_{role}={name!r} does not support "
                f"P_{role}={p} (grid {grid.p_rows}x{grid.p_cols})"
            )


def check_divisible(global_shape, grid: ProcessGrid, ndim: int) -> None:
    """Raise a ValueError naming the offending data axis and grid
    dimension when ``global_shape`` cannot be pencil-sharded (the
    schedule-level validator, grid-flavored)."""
    sch.check_divisible(
        global_shape, ndim, p_rows=grid.p_rows, p_cols=grid.p_cols,
        row_axis=grid.row_axis, col_axis=grid.col_axis,
    )


def _run(x: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig, *, ndim: int,
         inverse: bool) -> torch.Tensor:
    _check_backends(cfg, grid)
    in_tail = (grid.row_axis, grid.col_axis) + (None,) * (ndim - 2)
    built = sch.build_schedule(
        grid.mesh.global_shape(x.shape, in_tail), ndim=ndim, inverse=inverse, decomp="pencil",
        row_axis=grid.row_axis, col_axis=grid.col_axis, p_rows=grid.p_rows, p_cols=grid.p_cols,
        backend_row=cfg.backend_row, backend_col=cfg.backend_col, fused=cfg.fused,
        n_chunks=cfg.n_chunks, transpose_back=cfg.transpose_back,
    )
    return sch.run_schedule(x, built, grid.mesh, impl=cfg.local_impl)


def pencil_fft3(x: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig = PencilConfig(), *,
                inverse: bool = False) -> torch.Tensor:
    """Pencil-decomposed 3-D FFT of (..., D0, D1, D2) with D0 sharded
    over ``grid.row_axis`` and D1 over ``grid.col_axis``.

    Returns the reversed-axes spectrum (global value
    ``fftn(x).permute(..., -1, -2, -3)``) sharded (D2 over cols, D1 over
    rows), or the natural layout with ``cfg.transpose_back`` (two extra
    sub-exchanges). ``inverse`` computes the matching ifftn of the same
    layout (1/(D0*D1*D2) normalization)."""
    return _run(x, grid, cfg, ndim=3, inverse=inverse)


def pencil_fft2(x: torch.Tensor, grid: ProcessGrid, cfg: PencilConfig = PencilConfig(), *,
                inverse: bool = False) -> torch.Tensor:
    """Pencil-decomposed 2-D FFT of (..., R, C) with R sharded over
    ``grid.row_axis`` and C over ``grid.col_axis``: the natural-layout
    ``fft2(x)``, same sharding. ``cfg.transpose_back`` must be False.
    Both R and C must divide P_row*P_col (every sub-ring re-shards
    both dims)."""
    if cfg.transpose_back:
        raise ValueError(
            "pencil fft2 already returns the natural layout; "
            "transpose_back applies to slab transforms and pencil fft3 only"
        )
    return _run(x, grid, cfg, ndim=2, inverse=inverse)
