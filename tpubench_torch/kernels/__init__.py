"""Hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc``
on first use (:mod:`.build`) and wrapped for PyTorch (:mod:`.landing`)."""
