"""PaliGemma backbone and the ColPali retriever in PyTorch (counterpart of
:mod:`colpali_tpu.models.paligemma`).

Pages: SigLIP over the pixels -> the linear projector -> divided by
``sqrt(text hidden)`` as a constant in the compute dtype (45.25 in bf16) ->
spliced into the ``<image>`` token slots. Queries skip the vision tower.
Both then run Gemma with full attention over valid tokens and 1-indexed
positions, and ColPali's head gives 128-d L2-normalized, mask-zeroed token
embeddings.

For training, ``remat`` checkpoints every transformer layer, and the vision
tower and the projector run without recording a gradient whenever none of
their parameters takes one (LoRA never targets them), so their activations
are not kept.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from colpali_tpu_torch.models.common import DenseHead, MultiVectorHead, merge_image_embeddings
from colpali_tpu_torch.models.configs import DenseHeadConfig, PaliGemmaConfig
from colpali_tpu_torch.models.gemma import GemmaDecoder
from colpali_tpu_torch.models.layers import Device, QDense, frozen
from colpali_tpu_torch.models.siglip import SiglipVisionTower


class PaliGemmaBackbone(nn.Module):
    """SigLIP + projector + Gemma; returns last hidden states."""

    def __init__(self, config: PaliGemmaConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        self.vision_tower = SiglipVisionTower(config.vision, remat=remat, **kw)
        self.multi_modal_projector = QDense(config.vision.hidden_size, config.projection_dim, **kw)
        self.language_model = GemmaDecoder(config.text, remat=remat, **kw)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Projected, scaled image features; no gradient is recorded when the
        tower and the projector are frozen."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not (frozen(self.vision_tower) and frozen(self.multi_modal_projector))):
            features = self.multi_modal_projector(self.vision_tower(pixel_values))
            scale = torch.tensor(self.config.text.hidden_size**0.5, dtype=self.dtype, device=features.device)
            return features / scale

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``(B, S)`` ids and mask (1 = real token), optional ``(B, H, W, 3)``
        normalized pixels -> ``(B, S, hidden)``."""
        cfg = self.config
        image_mask = input_ids == cfg.image_token_index
        # image tokens may lie past the vocab; they embed as id 0
        inputs_embeds = self.language_model.embed(torch.where(image_mask, 0, input_ids))
        if pixel_values is not None:
            inputs_embeds = merge_image_embeddings(inputs_embeds, image_mask, self.image_features(pixel_values))
        b, s = input_ids.shape
        position_ids = torch.arange(1, s + 1, device=input_ids.device).expand(b, s)  # 1-indexed
        return self.language_model(inputs_embeds, attention_mask, position_ids)


class ColPali(nn.Module):
    """Late-interaction multi-vector retriever over PaliGemma: ``(B, S, dim)``
    L2-normalized, mask-zeroed per-token embeddings. With
    ``mask_non_image_embeddings``, page inputs also zero every non-image
    token."""

    def __init__(self, config: PaliGemmaConfig, dim: int = 128, mask_non_image_embeddings: bool = False,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.mask_non_image_embeddings = mask_non_image_embeddings
        self.model = PaliGemmaBackbone(config, device=device, dtype=dtype, remat=remat)
        self.head = MultiVectorHead(config.text.hidden_size, dim=dim, device=device, dtype=dtype)

    def set_remat(self, remat: bool) -> None:
        """Turn the per-layer checkpointing of both towers on or off."""
        self.model.vision_tower.remat = remat
        self.model.language_model.remat = remat

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask, pixel_values)
        image_mask = None
        if pixel_values is not None and self.mask_non_image_embeddings:
            image_mask = input_ids == self.config.image_token_index
        return self.head(hidden, attention_mask, image_mask)


class BiPali(nn.Module):
    """Single-vector (bi-encoder) retriever over PaliGemma: the backbone's
    hidden states pooled by :class:`DenseHead` (mean by default) into one
    L2-normalized vector a row. ``projection_dim=1024`` is BiPaliProj."""

    def __init__(self, config: PaliGemmaConfig, pooling_strategy: str = "mean", projection_dim: Optional[int] = None,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = PaliGemmaBackbone(config, device=device, dtype=dtype, remat=remat)
        self.head = DenseHead(DenseHeadConfig(pooling_strategy=pooling_strategy, projection_dim=projection_dim),
                              config.text.hidden_size, device=device, dtype=dtype)

    def set_remat(self, remat: bool) -> None:
        """Turn the per-layer checkpointing of both towers on or off."""
        self.model.vision_tower.remat = remat
        self.model.language_model.remat = remat

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(self.model(input_ids, attention_mask, pixel_values), attention_mask)


class BiPaliProj(BiPali):
    """BiPali with the trained 1024-d projection head (the reference's
    separate class; here BiPali with the projection on by default)."""

    def __init__(self, config: PaliGemmaConfig, pooling_strategy: str = "mean", projection_dim: Optional[int] = 1024,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(config, pooling_strategy, projection_dim, device=device, dtype=dtype, remat=remat)
