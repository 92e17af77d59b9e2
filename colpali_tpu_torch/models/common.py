"""Retrieval heads, the image-feature merge and weight initialization shared
by the model families (counterpart of :mod:`colpali_tpu.models.common`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from colpali_tpu_torch.models.configs import DenseHeadConfig
from colpali_tpu_torch.models.layers import Device, LayerNorm, QDense, RMSNorm, l2_normalize


def merge_image_embeddings(
    inputs_embeds: torch.Tensor,
    image_token_mask: torch.Tensor,
    image_features: torch.Tensor,
) -> torch.Tensor:
    """Splice ``image_features (B, n_img, D)`` into ``inputs_embeds (B, S, D)``
    at the image-token slots of ``image_token_mask (B, S)``: the k-th True
    position of row b takes ``image_features[b, k]`` (indices clipped to
    ``n_img - 1``, as in the JAX package)."""
    n_img = image_features.shape[1]
    idx = (torch.cumsum(image_token_mask.long(), dim=1) - 1).clamp(0, n_img - 1)
    scattered = torch.gather(image_features, 1, idx[..., None].expand(-1, -1, image_features.shape[2]))
    return torch.where(image_token_mask[..., None], scattered.to(inputs_embeds.dtype), inputs_embeds)


class MultiVectorHead(nn.Module):
    """Late-interaction head: linear -> L2 normalize (the norm clamped at
    ``norm_eps``: 1e-12 for ColModernVBert, 0 for the others) -> zero the
    padding (and, given ``image_token_mask``, every non-image token). The
    linear is named ``proj_name`` (ColIdefics3 names it ``linear``)."""

    def __init__(self, hidden_size: int, dim: int = 128, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32, proj_name: str = "custom_text_proj", norm_eps: float = 0.0):
        super().__init__()
        self.proj_name = proj_name
        self.norm_eps = norm_eps
        setattr(self, proj_name, QDense(hidden_size, dim, bias=True, device=device, dtype=dtype))

    def forward(self, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                image_token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        proj = l2_normalize(getattr(self, self.proj_name)(hidden_states), eps=self.norm_eps)
        proj = proj * attention_mask[..., None].to(proj.dtype)
        if image_token_mask is not None:
            proj = proj * image_token_mask[..., None].to(proj.dtype)
        return proj


class DenseHead(nn.Module):
    """Bi-encoder head: pool (``mean`` over the mask, ``cls`` = position 0,
    ``last`` = the literal last position) -> the optional ``proj`` -> the
    optional Matryoshka cut to ``embedding_dim`` -> L2 normalize.

    ``last`` takes ``hidden[:, -1]`` whatever the mask says, as the JAX
    package and the reference do (they assume left padding): on a
    right-padded batch that is a pad position for every row shorter than the
    longest. Mean pooling sums in fp32 and returns fp32, as JAX promotes it;
    ``cls`` and ``last`` keep the hidden states' dtype."""

    def __init__(self, config: DenseHeadConfig, hidden_size: int, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.pooling_strategy not in ("mean", "cls", "last"):
            raise ValueError(f"Unknown pooling strategy: {config.pooling_strategy}")
        self.config = config
        self.dtype = dtype
        if config.projection_dim is not None:
            self.proj = QDense(hidden_size, config.projection_dim, bias=True, device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.pooling_strategy == "mean":
            mask = attention_mask.float()
            pooled = (hidden_states.float() * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp_min(1.0)
        elif cfg.pooling_strategy == "cls":
            pooled = hidden_states[:, 0]
        else:
            pooled = hidden_states[:, -1]
        if cfg.projection_dim is not None:
            pooled = self.proj(pooled.to(self.dtype))
        if cfg.embedding_dim is not None:
            pooled = pooled[..., : cfg.embedding_dim]
        return l2_normalize(pooled)


@torch.no_grad()
def hf_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in the HF convention, in place on the weights' own
    device: linear and embedding weights from normal(0, 0.02), biases zero,
    RMSNorm weights zero where the norm adds a unit offset (Gemma) and one
    where it does not (Qwen), LayerNorm weights one and biases zero. ``generator`` must be on that device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            if m.weight.is_floating_point():  # stored-int8 weights and their scales stay as they are
                m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.weight.fill_(0.0 if m.add_unit_offset else 1.0)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
    return module
