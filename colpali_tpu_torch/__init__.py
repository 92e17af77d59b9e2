"""PyTorch/CUDA port of colpali_tpu for NVIDIA Hopper GPUs.

The JAX package ``colpali_tpu`` is the reference; this package keeps its
module and public names, so moving from one to the other is a change of the
import. It imports ``torch`` and never ``jax``; the CUDA kernels are built
and loaded at their first launch, not on import.
"""

__version__ = "0.3.0"

from colpali_tpu_torch.auto import load_retriever  # noqa: F401
from colpali_tpu_torch.ops.maxsim import score_multi_vector, score_single_vector  # noqa: F401
