"""Training of the port (counterpart of :mod:`colpali_tpu.training`)."""

from colpali_tpu_torch.training.checkpointing import CheckpointManager, save_pretrained  # noqa: F401
from colpali_tpu_torch.training.lora import DEFAULT_TARGET_PATTERN, LoraAdapters, LoraSpec  # noqa: F401
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: F401
from colpali_tpu_torch.training.trainer import TrainConfig, create_train_state, make_train_step  # noqa: F401
