"""Slab-decomposed distributed FFT entry points over the stage-schedule
IR (the paper's application, §2), PyTorch port of
``repro.core.distributed_fft``.

Global data model for ``fft2``: x has shape (..., R, C) with R sharded
over ``axis_name`` (P shards); leading axes are batch. The paper's four
steps per dimension -- local FFT along the contiguous axis, chunk +
communicate (``distributed_transpose``, strategy-switchable), chunk
re-transpose (folded into the strategy) -- then the second dimension's
local FFT. Output is the transposed spectrum F^T (C sharded) by
default, or the natural layout with ``transpose_back=True`` (one more
exchange).

``fused=True`` (any chunk-streaming strategy) folds the *next
dimension's DFT itself* into the exchange via decimation across source
ranks (:func:`repro_torch.core.transpose.transpose_then_fft`);
``n_chunks`` decouples the streamed chunk count from P.

Every transform here is a thin builder over
:mod:`repro_torch.core.schedule`. ``x`` is the caller's array of the
mesh: the global array on a :class:`~repro_torch.core.mesh.SimMesh`,
the rank's own block on a :class:`~repro_torch.core.mesh.ProcessGroupMesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import repro_torch.core.schedule as sch
from repro_torch.core import backends
from repro_torch.core.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class FFTConfig:
    """Transform config carrier (``plan_fft`` resolves ``pipeline=`` into
    the ``fused``/``n_chunks`` fields here). ``strategy`` names any
    backend registered in :mod:`repro_torch.core.backends`."""

    strategy: str = "alltoall"
    local_impl: str = "torch"
    transpose_back: bool = False  # return natural (row-sharded) layout
    fused: bool = False  # streaming backends: fuse the next FFT stage
    n_chunks: Optional[int] = None  # total-chunk target (None = P)


def _check(cfg: FFTConfig) -> backends.CollectiveBackend:
    backend = backends.get(cfg.strategy)  # raises listing the registry
    if cfg.fused and not (backend.kind == "shard_map" and backend.supports_chunk_fn):
        raise ValueError(
            f"fused requires a chunk-streaming backend "
            f"(got {cfg.strategy!r}; streaming: "
            f"{[b for b in backends.available() if backends.get(b).supports_chunk_fn]})"
        )
    return backend


def _build(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig, *,
           ndim: int, inverse: bool, rows: Optional[int] = None) -> sch.Schedule:
    return sch.build_schedule(
        mesh.global_shape(x.shape, (axis_name,) + (None,) * (ndim - 1)), ndim=ndim, inverse=inverse,
        decomp="slab", axis_name=axis_name, p=mesh.shape[axis_name], backend=cfg.strategy,
        fused=cfg.fused, n_chunks=cfg.n_chunks,
        transpose_back=cfg.transpose_back, rows=rows,
    )


def fft2(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(), *,
         inverse: bool = False) -> torch.Tensor:
    """Distributed 2-D FFT of (..., R, C), R sharded over ``axis_name``.

    Returns F^T (= fft2(x).swapaxes(-1,-2)) with C sharded, unless
    ``cfg.transpose_back``. With ``inverse``, computes the unnormalized-
    forward convention's ifft2 (1/(R*C) factor), same layout."""
    _check(cfg)
    built = _build(x, mesh, axis_name, cfg, ndim=2, inverse=inverse)
    return sch.run_schedule(x, built, mesh, impl=cfg.local_impl)


def ifft2(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig()) -> torch.Tensor:
    return fft2(x, mesh, axis_name, cfg, inverse=True)


def fft3(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(), *,
         inverse: bool = False) -> torch.Tensor:
    """Slab-decomposed 3-D FFT of (..., D0, D1, D2), D0 sharded: local
    batched 2-D FFT over (D1, D2), one strategy-switched exchange to
    localize D0, FFT, and the exchange back (natural layout)."""
    _check(cfg)
    built = _build(x, mesh, axis_name, cfg, ndim=3, inverse=inverse)
    return sch.run_schedule(x, built, mesh, impl=cfg.local_impl)


def fft1d_large(x: torch.Tensor, mesh: Mesh, axis_name: str, cfg: FFTConfig = FFTConfig(), *,
                rows: Optional[int] = None) -> torch.Tensor:
    """Distributed 1-D FFT of a signal too large for one device: x
    (..., N) viewed as (R, C) row-major with R = rows (default P)
    sharded. Six-step algorithm: transpose, FFT_R, twiddle (fused into
    the second exchange's chunks on streaming backends), transpose,
    FFT_C, transpose. Returns the standard-ordered spectrum."""
    _check(cfg)
    built = _build(x, mesh, axis_name, cfg, ndim=1, inverse=False, rows=rows)
    return sch.run_schedule(x, built, mesh, impl=cfg.local_impl)


def reference_fft2(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Single-device oracle (numpy semantics) for tests/benchmarks."""
    return torch.fft.ifft2(x) if inverse else torch.fft.fft2(x)
