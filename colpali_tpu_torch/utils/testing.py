"""Helpers for tests and smoke runs that need no downloads (counterpart of
:mod:`colpali_tpu.utils.testing` and of ``load_dummy_dataset`` in
:mod:`colpali_tpu.utils.dataset_loading`): a tiny ColPali config, a
hash-based processor and a synthetic dataset."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from colpali_tpu_torch.data.dataset import ColPaliEngineDataset
from colpali_tpu_torch.models.configs import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch

DUMMY_IMAGE_TOKEN_ID = 2


def tiny_colpali_config(image_size: int = 28) -> PaliGemmaConfig:
    """Full ColPali architecture at toy width and depth."""
    return PaliGemmaConfig(
        vision=SiglipVisionConfig(
            hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
            image_size=image_size, patch_size=14,
        ),
        text=GemmaConfig(
            vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
            num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        ),
        projection_dim=16,
        image_token_index=DUMMY_IMAGE_TOKEN_ID,
    )


class DummyProcessor(BaseVisualRetrieverProcessor):
    """Hash-based word tokenizer and raw-resize images. Word ids come from
    Python's ``hash``, which is stable within one process only."""

    query_prefix = ""
    query_augmentation_token = "<pad>"

    def __init__(self, image_size: int = 28, n_image_tokens: int = 4, vocab_size: int = 64):
        self.image_size = image_size
        self.n_image_tokens = n_image_tokens
        self.vocab_size = vocab_size

    def _encode(self, text: str):
        return [3 + (hash(w) % (self.vocab_size - 3)) for w in text.replace("<pad>", " ").split()] or [3]

    def process_texts(self, texts: Sequence[str]) -> Batch:
        encoded = [self._encode(t) for t in texts]
        m = max(len(e) for e in encoded)
        ids = np.zeros((len(encoded), m), np.int32)
        mask = np.zeros((len(encoded), m), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def process_images(self, images: Sequence) -> Batch:
        n = len(images)
        ids = np.concatenate(
            [np.full((n, self.n_image_tokens), DUMMY_IMAGE_TOKEN_ID, np.int32), np.full((n, 2), 3, np.int32)],
            axis=1,
        )
        pixels = []
        for im in images:
            arr = np.asarray(im, np.float32)
            if arr.shape[:2] != (self.image_size, self.image_size):
                # antialiased bilinear (triangle filter), as jax.image.resize "bilinear"
                x = torch.from_numpy(arr).permute(2, 0, 1)[None]
                x = F.interpolate(x, size=(self.image_size, self.image_size), mode="bilinear", antialias=True,
                                  align_corners=False)
                arr = x[0].permute(1, 2, 0).numpy()
            pixels.append(arr / 127.5 - 1.0)
        return {
            "input_ids": ids,
            "attention_mask": np.ones_like(ids),
            "pixel_values": np.stack(pixels).astype(np.float32),
        }

    def get_n_patches(self, image_size, *args, **kwargs):
        return (2, 2)

    def get_n_patches(self, image_size, *args, **kwargs):
        return (2, 2)


def load_dummy_dataset(n: int = 16, image_size: int = 64) -> ColPaliEngineDataset:
    """Synthetic offline dataset: ``n`` queries ``"synthetic query i"``, each
    with a seeded uint8 noise image."""
    rng = np.random.default_rng(0)
    data = [
        {
            "query": f"synthetic query {i}",
            "pos_target": rng.integers(0, 255, size=(image_size, image_size, 3), dtype=np.uint8),
        }
        for i in range(n)
    ]
    return ColPaliEngineDataset(data)
