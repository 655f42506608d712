"""Hand-written Hopper (sm_90a) kernels for the FFT compute hot-spot.

csrc/fft_stage.cu: the kernels (CUDA C++, plain C entry points);
build.py: nvcc at first use + ctypes loading; fft_stage.py: the
wrappers (launch counters, argument checks, plain path for CPU
tensors); ops.py: the four-step fft_last_axis; ref.py: plain PyTorch
versions."""
