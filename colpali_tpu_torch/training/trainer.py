"""Contrastive training steps (counterpart of
:mod:`colpali_tpu.training.trainer`, single device).

Three forwards per step (query / positive doc / optional negative docs) on
key-prefixed batches, the loss over the whole batch, then the JAX package's
optimizer: clip by global norm, AdamW with decoupled weight decay, linear
warm-up from 0 and linear decay to 0. The schedule is read at the update
count, which starts at 0, so the first step of a warm-up runs at rate 0.
The clip multiplies by ``max_norm / norm`` when the norm reaches
``max_norm`` (no epsilon), on the device and without a host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec

Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999


def learning_rate_at(config: TrainConfig, count: int) -> float:
    """The schedule at update ``count`` (0 for the first update): linear from
    0 to ``learning_rate`` over ``warmup_steps``, then linear to 0 over
    ``max(total_steps - warmup_steps, 1)`` and 0 from there on."""
    if count < config.warmup_steps:
        return config.learning_rate * count / config.warmup_steps
    decay = max(config.total_steps - config.warmup_steps, 1)
    return config.learning_rate * (1.0 - min(count - config.warmup_steps, decay) / decay)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm over all gradients, a 0-d tensor on their device."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where the norm is not
    below ``max_norm``; returns the norm before clipping."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class TrainState:
    """The model, what trains of it, the optimizer and the update count.

    With ``adapters`` the model is the frozen base and only the adapters
    train, so optimizer state exists for them alone; without, every
    parameter of the model that takes a gradient trains."""

    def __init__(self, model: nn.Module, config: TrainConfig, adapters: Optional[LoraAdapters] = None):
        self.model = model
        self.adapters = adapters
        self.config = config
        self.step = 0
        self.params = list(adapters.parameters()) if adapters is not None else [
            p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.AdamW(self.params, lr=config.learning_rate, betas=(config.b1, config.b2),
                                           eps=1e-8, weight_decay=config.weight_decay)

    def apply_gradients(self) -> torch.Tensor:
        """Clip, take one AdamW update at this count's rate, advance the
        count; returns the gradient norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.config.max_grad_norm)
        rate = learning_rate_at(self.config, self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = rate
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return norm

    def state_dict(self) -> Dict[str, Any]:
        trainable = self.adapters.state_dict() if self.adapters is not None else self.model.state_dict()
        return {"step": self.step, "trainable": trainable, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        (self.adapters if self.adapters is not None else self.model).load_state_dict(state["trainable"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_train_state(model: nn.Module, config: TrainConfig, adapters: Optional[LoraAdapters] = None) -> TrainState:
    return TrainState(model, config, adapters)


def to_device(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy arrays or tensors) as tensors on ``device``;
    token ids become int64."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
        if key.endswith("input_ids"):
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
    return out


# the inputs of a prefixed sub-batch that the models' forwards take beside ids and mask: the pages' pixels, the
# Qwen2-VL family's vision geometry, window ids and M-RoPE positions, Qwen3-VL's position-table taps, and the
# Idefics3 family's tile validity
MODEL_INPUTS = ("pixel_values", "vision_hpos", "vision_wpos", "patch_mask", "window_id", "pos_idx", "pos_weight",
                "position_ids", "tile_mask")


def forward_prefixed(model: nn.Module, batch: Batch, prefix: str) -> torch.Tensor:
    """One prefixed forward, with every input of :data:`MODEL_INPUTS` the
    sub-batch holds (the JAX package's ``_forward`` passes the pixels
    alone, which loses the Qwen models' geometry). Negative docs arrive as
    ``(B, n_neg, ...)`` and are flattened into the batch dim for the model:
    axis 0 and 1 of each input (the Idefics3 tiles ``(B, n_neg, T, S, S,
    3)`` and ``tile_mask (B, n_neg, T)`` too), but axes 1 and 2 of
    ``position_ids (3, B, n_neg, S)``, whose batch axis is its second (the
    collator may also hand them over already flat, ``(3, B * n_neg, S)``)."""
    ids = batch[f"{prefix}input_ids"]
    mask = batch[f"{prefix}attention_mask"]
    inputs = {name: batch[f"{prefix}{name}"] for name in MODEL_INPUTS if f"{prefix}{name}" in batch}
    if ids.ndim == 3:
        b, n, s = ids.shape
        inputs = {name: x.reshape(3, b * n, -1) if name == "position_ids" else x.reshape(b * n, *x.shape[2:])
                  for name, x in inputs.items()}
        emb = model(ids.reshape(b * n, s), mask.reshape(b * n, s), **inputs)
        return emb.reshape(b, n, *emb.shape[1:])
    return model(ids, mask, **inputs)


def compute_loss(model: nn.Module, batch: Batch, loss_fn: Callable, has_negatives: bool):
    """``(loss, query embeddings, doc embeddings)`` of one batch."""
    q = forward_prefixed(model, batch, "query_")
    d = forward_prefixed(model, batch, "doc_")
    if has_negatives and "neg_doc_input_ids" in batch:
        return loss_fn(q, d, forward_prefixed(model, batch, "neg_doc_")), q, d
    return loss_fn(q, d), q, d


def begin_step(state: TrainState, peft: Optional[LoraSpec], seed: int) -> None:
    """Before a training forward: draw the step's LoRA dropout masks from
    ``(seed, state.step)`` and put the model in training mode."""
    if state.adapters is not None:
        if peft is not None and peft.dropout > 0.0:
            state.adapters.draw_masks(seed, state.step)
        else:
            state.adapters.clear_masks()
    state.model.train()


def make_train_step(loss_fn: Callable, has_negatives: bool = False, peft: Optional[LoraSpec] = None,
                    seed: int = 0) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """Build ``train_step(state, batch) -> {"loss", "grad_norm"}`` (0-d
    tensors on the device; ``grad_norm`` is the norm before clipping).
    ``loss_fn(query_embeddings, doc_embeddings, [neg_doc_embeddings])`` is
    any loss of :mod:`colpali_tpu_torch.losses`. With a LoRA state pass its
    ``peft`` recipe: the step then draws the dropout masks."""

    def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        begin_step(state, peft, seed)
        loss, _, _ = compute_loss(state.model, batch, loss_fn, has_negatives)
        loss.backward()
        return {"loss": loss.detach(), "grad_norm": state.apply_gradients()}

    return train_step


def make_eval_step(loss_fn: Callable, has_negatives: bool = False) -> Callable:
    """Build ``eval_step(state, batch) -> (loss, q, d)``: no dropout, no
    gradient; the padded query and doc embeddings come back so that
    retrieval metrics need no second forward."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        if state.adapters is not None:
            state.adapters.clear_masks()
        state.model.eval()
        return compute_loss(state.model, batch, loss_fn, has_negatives)

    return eval_step
