from colpali_tpu_torch.ops.maxsim import (  # noqa: F401
    maxsim,
    maxsim_pairwise,
    score_multi_vector,
    score_single_vector,
)
from colpali_tpu_torch.ops.quant import (  # noqa: F401
    binarize_words,
    dequantize_per_token,
    quantize_per_token,
    unpack_words,
)
