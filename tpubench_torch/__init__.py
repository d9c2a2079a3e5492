"""tpubench_torch — the PyTorch/CUDA port of tpubench.

Storage→GPU-HBM ingest on NVIDIA Hopper: the same workloads, config and
result JSON as the JAX package ``tpubench``, which stays beside it as the
reference. This package imports ``torch`` and numpy, never ``jax`` and
never a ``tpubench`` module. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
