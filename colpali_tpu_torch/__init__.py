"""PyTorch/CUDA port of colpali_tpu for NVIDIA Hopper GPUs.

The JAX package ``colpali_tpu`` is the reference; this package keeps its
module and public names. It imports ``torch`` and never ``jax``.
"""
