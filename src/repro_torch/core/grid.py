"""2-D process grids for pencil decomposition, PyTorch port of
``repro.core.grid``.

The paper's FFT benchmark shards over a *single* mesh axis (slab
decomposition), which caps parallelism at P <= N and forces one global
exchange over all P ranks. Arranging the P processes as a
(P_row x P_col) **pencil grid** makes each transpose a *sub-axis*
exchange over only P_row or P_col ranks -- smaller rings, more
parallelism, and (because each sub-exchange goes through the backend
registry independently) a 2-D analogue of the paper's parcelport switch.

:class:`ProcessGrid` is the thin, validated handle the rest of the stack
passes around: a grid mesh (:class:`~repro_torch.core.mesh.SimMesh` or
:class:`~repro_torch.core.mesh.ProcessGroupMesh` with ``grid=``) plus
which two of its axes play the row/column roles. Build the mesh however
you like (:func:`make_grid` is the convenience path for a simulated
grid on one device) and wrap it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core.mesh import GRID_AXES, Mesh, SimMesh


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """A (P_row x P_col) view of two axes of a mesh.

    ``row_axis`` shards the leading transform dimension; ``col_axis``
    shards the next one. The pencil transforms exchange over each axis
    independently (one sub-ring of size ``p_rows``, one of ``p_cols``),
    which is what lets ``backend_row`` / ``backend_col`` differ.
    """

    mesh: Mesh
    row_axis: str = GRID_AXES[0]
    col_axis: str = GRID_AXES[1]

    def __post_init__(self):
        if self.row_axis == self.col_axis:
            raise ValueError(
                f"pencil grid needs two distinct mesh axes, got "
                f"row_axis == col_axis == {self.row_axis!r}"
            )
        for role, ax in (("row_axis", self.row_axis), ("col_axis", self.col_axis)):
            if ax not in self.mesh.shape:
                raise ValueError(
                    f"{role}={ax!r} is not an axis of the mesh "
                    f"(mesh axes: {list(self.mesh.shape)})"
                )

    @property
    def p_rows(self) -> int:
        return int(self.mesh.shape[self.row_axis])

    @property
    def p_cols(self) -> int:
        return int(self.mesh.shape[self.col_axis])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.p_rows, self.p_cols)

    @property
    def size(self) -> int:
        """Total shards participating in the pencil decomposition."""
        return self.p_rows * self.p_cols

    def axis_of(self, role: str) -> str:
        """Mesh axis name for ``"row"`` or ``"col"``."""
        if role == "row":
            return self.row_axis
        if role == "col":
            return self.col_axis
        raise ValueError(f"role must be 'row' or 'col', got {role!r}")

    def __repr__(self) -> str:
        return (
            f"ProcessGrid({self.p_rows}x{self.p_cols}, "
            f"row_axis={self.row_axis!r}, col_axis={self.col_axis!r})"
        )


def make_grid(shape: Tuple[int, int], axis_names: Tuple[str, str] = GRID_AXES,
              device=None) -> ProcessGrid:
    """A fresh (P_row x P_col) :class:`~repro_torch.core.mesh.SimMesh` on
    ``device`` (``None``: the card), wrapped as a ProcessGrid. Ranks are
    numbered row-major, rows varying slowest, as the reference orders
    devices. (Over processes, build ``init_process_mesh(...,
    grid=shape)`` and pass it to :func:`grid_from_mesh`.)"""
    pr, pc = int(shape[0]), int(shape[1])
    if pr < 1 or pc < 1:
        raise ValueError(f"grid shape must be positive, got {(pr, pc)}")
    return ProcessGrid(SimMesh((pr, pc), axis_names=tuple(axis_names), device=device), *axis_names)


def grid_from_mesh(mesh: Mesh, row_axis: Optional[str] = None,
                   col_axis: Optional[str] = None) -> ProcessGrid:
    """Resolve the pencil grid on an existing mesh.

    Explicit ``row_axis``/``col_axis`` always win. Otherwise the
    conventional ``("rows", "cols")`` names are used when both exist,
    else the mesh's last two axes (mirroring ``fft_axis``'s last-axis
    fallback for slab). A 1-axis mesh has no pencil grid -- that is a
    ``ValueError`` here, which ``plan_fft(decomp="auto")`` catches to
    fall back to slab.
    """
    axes = list(mesh.shape)
    if row_axis is not None or col_axis is not None:
        if row_axis is None or col_axis is None:
            raise ValueError("pass both row_axis and col_axis, or neither")
        return ProcessGrid(mesh, row_axis, col_axis)
    if all(a in mesh.shape for a in GRID_AXES):
        return ProcessGrid(mesh, *GRID_AXES)
    if len(axes) < 2:
        raise ValueError(
            f"pencil decomposition needs a mesh with >= 2 axes "
            f"(got axes {axes}); build one with repro_torch.core.grid.make_grid"
        )
    return ProcessGrid(mesh, axes[-2], axes[-1])


def grid_shapes(p: int) -> List[Tuple[int, int]]:
    """Every (P_row, P_col) factorization of ``p``, rows ascending --
    the sweep set for the slab-vs-pencil comparisons."""
    if p < 1:
        raise ValueError(f"process count must be positive, got {p}")
    return [(d, p // d) for d in range(1, p + 1) if p % d == 0]


def auto_grid_shape(p: int) -> Tuple[int, int]:
    """Most-square (P_row, P_col) factorization with P_row <= P_col.

    Squarer grids minimize the larger sub-ring, hence the larger of the
    two exchange costs -- the default when nothing is pinned."""
    if p < 1:
        raise ValueError(f"process count must be positive, got {p}")
    pr = 1
    for d in range(1, int(math.isqrt(p)) + 1):
        if p % d == 0:
            pr = d
    return (pr, p // pr)
