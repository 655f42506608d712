"""repro_torch.core -- the paper's contribution: distributed FFT over
strategy-switchable collectives, ported from ``repro.core``.

The collective strategies are pluggable backends
(:mod:`repro_torch.core.backends`); the user-facing entry point is the
FFTW-style plan/executor (``plan_fft`` -> ``Plan``) over a
:class:`~repro_torch.core.mesh.SimMesh`."""

from repro_torch.core import backends
from repro_torch.core.backends import CollectiveBackend
from repro_torch.core.comm_model import CommParams
from repro_torch.core.distributed_fft import FFTConfig, fft1d_large, fft2, fft3, ifft2, reference_fft2
from repro_torch.core.fftmath import MAX_DFT, dft_matrix, fft_matmul, local_fft, local_fft2
from repro_torch.core.mesh import SimMesh
from repro_torch.core.plan import Plan, plan_fft
from repro_torch.core.transpose import distributed_transpose, transpose_then_fft

__all__ = [
    "CollectiveBackend", "CommParams", "FFTConfig", "MAX_DFT", "Plan", "SimMesh",
    "backends", "dft_matrix", "distributed_transpose", "fft1d_large", "fft2", "fft3",
    "fft_matmul", "ifft2", "local_fft", "local_fft2", "plan_fft", "reference_fft2",
    "transpose_then_fft",
]
