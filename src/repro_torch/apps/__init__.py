"""repro_torch.apps -- spectral applications on top of the FFT plan
front-end, PyTorch port of ``repro.apps``.

Each solver takes a :class:`repro_torch.core.Plan`, so every choice the
plan layer offers -- collective backend, r2c vs c2c transforms, the
mesh (one-device simulated or ``torch.distributed``) -- flows through
the application unchanged. The apps never look at the mesh: they read
the plan's :meth:`~repro_torch.core.Plan.spectral_axes` layout contract
and operate in whatever frequency-domain layout (transposed,
axis-reversed, Hermitian-padded) the plan produces. Arrays are the plan's caller
arrays: global on a ``SimMesh``, the rank's own block on a
``ProcessGroupMesh``.

- :mod:`repro_torch.apps.poisson` -- periodic FFT Poisson solver
- :mod:`repro_torch.apps.convolve` -- distributed circular convolution/correlation
- :mod:`repro_torch.apps.derivatives` -- spectral gradient / laplacian
- :mod:`repro_torch.apps.spectral` -- shared wavenumber-grid plumbing
"""

from repro_torch.apps.convolve import fft_convolve, fft_correlate
from repro_torch.apps.derivatives import gradient, laplacian
from repro_torch.apps.poisson import solve_poisson
from repro_torch.apps.spectral import plan_directions, wavenumbers

__all__ = [
    "fft_convolve",
    "fft_correlate",
    "gradient",
    "laplacian",
    "plan_directions",
    "solve_poisson",
    "wavenumbers",
]
