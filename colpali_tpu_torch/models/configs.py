"""Model configuration dataclasses, the same as :mod:`colpali_tpu.models.configs`.

Field names follow the HF checkpoint configs so ``from_hf_config`` is
mechanical. The defaults are ColPali-3B (PaliGemma-3B at 448 px).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP vision tower (reference backbone of PaliGemma).

    Defaults = SigLIP-So400m/14-448 as used by PaliGemma-3B
    (google/paligemma-3b-pt-448).
    """

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "SiglipVisionConfig":
        return cls(
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            image_size=cfg.get("image_size", 448),
            patch_size=cfg.get("patch_size", 14),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-6),
        )


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    """Gemma decoder LM. Defaults = Gemma-2B (PaliGemma-3B text tower)."""

    vocab_size: int = 257216
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "GemmaConfig":
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim", cfg["hidden_size"] // cfg["num_attention_heads"]),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        )


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    """PaliGemma VLM: SigLIP tower + linear projector + Gemma decoder.

    ColPali wraps it with a 128-dim projection head.
    """

    vision: SiglipVisionConfig = dataclasses.field(default_factory=SiglipVisionConfig)
    text: GemmaConfig = dataclasses.field(default_factory=GemmaConfig)
    projection_dim: int = 2048
    image_token_index: int = 257152

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "PaliGemmaConfig":
        return cls(
            vision=SiglipVisionConfig.from_hf_config(cfg["vision_config"]),
            text=GemmaConfig.from_hf_config(cfg["text_config"]),
            projection_dim=cfg["vision_config"].get("projection_dim", cfg["text_config"]["hidden_size"]),
            image_token_index=cfg.get("image_token_index", cfg.get("image_token_id", 257152)),
        )


@dataclasses.dataclass(frozen=True)
class MultiVectorHeadConfig:
    """Late-interaction projection head shared by every Col* model."""

    dim: int = 128
    mask_non_image_embeddings: bool = False


@dataclasses.dataclass(frozen=True)
class DenseHeadConfig:
    """Bi-encoder pooling head shared by every Bi* model."""

    pooling_strategy: str = "mean"  # cls | last | mean
    projection_dim: Optional[int] = None  # BiPaliProj: 1024
    embedding_dim: Optional[int] = None  # Matryoshka truncation (BiGemma3)
