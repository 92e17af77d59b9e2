"""Retrieval heads and weight initialization shared by the model families
(counterpart of :mod:`colpali_tpu.models.common`)."""

from __future__ import annotations

import torch
from torch import nn

from colpali_tpu_torch.models.layers import Device, RMSNorm, l2_normalize


class MultiVectorHead(nn.Module):
    """Late-interaction head: linear -> L2 normalize -> zero the padding."""

    def __init__(self, hidden_size: int, dim: int = 128, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.custom_text_proj = nn.Linear(hidden_size, dim, bias=True, device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        proj = l2_normalize(self.custom_text_proj(hidden_states))
        return proj * attention_mask[..., None].to(proj.dtype)


@torch.no_grad()
def hf_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in the HF convention, in place on the weights' own
    device: linear and embedding weights from normal(0, 0.02), biases zero,
    RMSNorm weights zero (the norm adds a unit offset). ``generator`` must
    be on that device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.weight.zero_()
    return module
