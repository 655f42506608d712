"""repro_torch.core -- the paper's contribution: distributed FFT over
strategy-switchable collectives, ported from ``repro.core``.

The collective strategies are pluggable backends
(:mod:`repro_torch.core.backends`); the user-facing entry point is the
FFTW-style plan/executor (``plan_fft`` -> ``Plan``) over a mesh: the
one-device :class:`~repro_torch.core.mesh.SimMesh` or the
``torch.distributed`` :class:`~repro_torch.core.mesh.ProcessGroupMesh`
(one rank per process, joined with ``init_process_mesh``), each with one
axis (slab) or a 2-D grid of them (pencil, :mod:`repro_torch.core.grid`);
plus the decomposed-collective overlap layer
(:mod:`repro_torch.core.overlap`) over the same meshes."""

from repro_torch.core import backends
from repro_torch.core.backends import CollectiveBackend
from repro_torch.core.comm_model import CommParams
from repro_torch.core.distributed_fft import FFTConfig, fft1d_large, fft2, fft3, ifft2, reference_fft2
from repro_torch.core.fftmath import MAX_DFT, dft_matrix, fft_matmul, local_fft, local_fft2
from repro_torch.core.grid import ProcessGrid, auto_grid_shape, grid_from_mesh, grid_shapes, make_grid
from repro_torch.core.mesh import ProcessGroupMesh, SimMesh, init_process_mesh
from repro_torch.core.overlap import collective_matmul_ag, ring_all_gather, ring_reduce_scatter, ring_scatter_reduce
from repro_torch.core.pencil import PencilConfig, pencil_fft2, pencil_fft3
from repro_torch.core.plan import FFTPlan, InputSpec, Plan, SpectralAxis, make_plan, plan_fft
from repro_torch.core.planner import export_wisdom, forget_wisdom, import_wisdom, wisdom_size
from repro_torch.core.real import (
    irfft2, irfft3, pencil_irfft2, pencil_irfft3, pencil_rfft2, pencil_rfft3, rfft2, rfft3, rfft_len,
)
from repro_torch.core.transpose import distributed_transpose, transpose_then_fft

__all__ = [
    "CollectiveBackend", "CommParams", "FFTConfig", "FFTPlan", "InputSpec", "MAX_DFT", "PencilConfig",
    "Plan", "ProcessGrid", "ProcessGroupMesh", "SimMesh", "SpectralAxis", "auto_grid_shape", "backends",
    "collective_matmul_ag", "dft_matrix", "distributed_transpose", "export_wisdom", "fft1d_large", "fft2", "fft3", "fft_matmul",
    "forget_wisdom", "grid_from_mesh", "grid_shapes", "ifft2", "import_wisdom", "init_process_mesh",
    "irfft2", "irfft3", "local_fft", "local_fft2", "make_grid", "make_plan", "pencil_fft2", "pencil_fft3",
    "pencil_irfft2", "pencil_irfft3", "pencil_rfft2", "pencil_rfft3", "plan_fft", "reference_fft2", "rfft2", "rfft3", "rfft_len",
    "ring_all_gather", "ring_reduce_scatter", "ring_scatter_reduce", "transpose_then_fft",
    "wisdom_size",
]
