"""PaliGemma text path and the ColPali retriever in PyTorch (counterpart of
:mod:`colpali_tpu.models.paligemma`).

This slice ports the query forward: token ids (image token id -> 0 before
the embedding) -> Gemma with full attention over valid tokens and
1-indexed positions -> 128-d L2-normalized, mask-zeroed token embeddings.
The SigLIP tower and the projector that embed document pages belong to
the document-embedding slice, which is not ported yet: passing
``pixel_values`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from colpali_tpu_torch.models.common import MultiVectorHead
from colpali_tpu_torch.models.configs import PaliGemmaConfig
from colpali_tpu_torch.models.gemma import GemmaDecoder
from colpali_tpu_torch.models.layers import Device


def _no_pixels(pixel_values) -> None:
    if pixel_values is not None:
        raise NotImplementedError(
            "pixel_values: the SigLIP vision tower and projector (the document-embedding "
            "slice) are not ported yet; only text (query) inputs run")


class PaliGemmaBackbone(nn.Module):
    """Gemma over PaliGemma's token stream; returns last hidden states."""

    def __init__(self, config: PaliGemmaConfig, device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.language_model = GemmaDecoder(config.text, device=device, dtype=dtype)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``(B, S)`` ids and mask (1 = real token) -> ``(B, S, hidden)``."""
        _no_pixels(pixel_values)
        # image tokens may lie past the vocab; they embed as id 0
        safe_ids = torch.where(input_ids == self.config.image_token_index, 0, input_ids)
        inputs_embeds = self.language_model.embed(safe_ids)
        b, s = input_ids.shape
        position_ids = torch.arange(1, s + 1, device=input_ids.device).expand(b, s)  # 1-indexed
        return self.language_model(inputs_embeds, attention_mask, position_ids)


class ColPali(nn.Module):
    """Late-interaction multi-vector retriever over PaliGemma: ``(B, S, dim)``
    L2-normalized, mask-zeroed per-token embeddings."""

    def __init__(self, config: PaliGemmaConfig, dim: int = 128,
                 device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.model = PaliGemmaBackbone(config, device=device, dtype=dtype)
        self.head = MultiVectorHead(config.text.hidden_size, dim=dim, device=device, dtype=dtype)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask, pixel_values)
        return self.head(hidden, attention_mask)
