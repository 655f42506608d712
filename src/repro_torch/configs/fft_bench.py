"""The paper's own FFT problem configurations.

Figure 4/5 strong scaling uses a 2-D FFT of size 2^14 x 2^14 (c64 = 4
GiB); Figure 3's chunk-size scaling sweeps the per-chunk message size on
two nodes. Full sizes are exercised abstractly by the dry-run; the CPU
benchmark harness uses the scaled sizes below.
"""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FFTBenchConfig:
    name: str
    global_shape: Tuple[int, ...]
    ndim_transform: int = 2


#: the paper's production problem (Figs. 4-5)
PAPER_2D = FFTBenchConfig("paper_2d_16k", (16384, 16384), 2)

#: CPU-container scaled problems (same shape family, tractable on 1 core)
BENCH_2D = FFTBenchConfig("bench_2d_1k", (1024, 1024), 2)
BENCH_2D_SMALL = FFTBenchConfig("bench_2d_256", (256, 256), 2)
BENCH_3D = FFTBenchConfig("bench_3d_128", (128, 128, 128), 3)
BENCH_1D = FFTBenchConfig("bench_1d_1m", (1 << 20,), 1)
