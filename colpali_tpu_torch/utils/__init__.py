from colpali_tpu_torch.utils.tensor_utils import (  # noqa: F401
    pad_sequences,
    round_up,
    unbind_padded_multivector_embeddings,
)
