"""repro_torch -- the PyTorch/CUDA port of the distributed-FFT framework
in ``repro`` (the JAX reference, which this package never imports).

Same module layout and public names as ``repro`` (``core/``,
``kernels/``); entry points run on the card unless the caller passes
``device="cpu"``."""
