"""Contrastive losses of the port (counterpart of :mod:`colpali_tpu.losses`)."""

from colpali_tpu_torch.losses.bi_encoder import (  # noqa: F401
    BiEncoderLoss,
    BiNegativeCELoss,
    BiPairedEncoderLoss,
    BiPairwiseCELoss,
    BiPairwiseNegativeCELoss,
    BiSigmoidLoss,
)
from colpali_tpu_torch.losses.late_interaction import (  # noqa: F401
    ColbertLoss,
    ColbertNegativeCELoss,
    ColbertPairwiseCELoss,
    ColbertPairwiseNegativeCELoss,
    ColbertSigmoidLoss,
)
