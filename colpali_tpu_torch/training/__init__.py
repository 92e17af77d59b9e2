"""Training of the port (counterpart of :mod:`colpali_tpu.training`)."""

from colpali_tpu_torch.training.lora import DEFAULT_TARGET_PATTERN, LoraAdapters, LoraSpec  # noqa: F401
from colpali_tpu_torch.training.trainer import TrainConfig  # noqa: F401
