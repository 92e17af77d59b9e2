"""Helpers for tests and smoke runs that need no downloads (counterpart of
:mod:`colpali_tpu.utils.testing` and of ``load_dummy_dataset`` in
:mod:`colpali_tpu.utils.dataset_loading`): a tiny ColPali config, a
hash-based processor, a synthetic dataset, and an HF-layout checkpoint of a
Qwen-family model with a word-level tokenizer whose special tokens sit at
Qwen2's ids (:func:`write_qwen_checkpoint`), of a ColIdefics3 with
Idefics3's specials (:func:`write_idefics3_checkpoint`), of a seeded
ColQwen3 at any ``Qwen3VLConfig`` with Qwen2's (:func:`write_qwen3_checkpoint`)
of a seeded ColGemma3 at any ``Gemma3Config`` with Gemma3's
(:func:`write_gemma3_checkpoint`) or of a seeded ColModernVBert at any
``ModernVBertConfig`` with its tile tokens in the additional vocabulary
(:func:`write_modernvbert_checkpoint`), which ``load_retriever`` reads
through ``transformers``."""

from __future__ import annotations

import dataclasses
import json
import os
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


# Qwen2's special tokens at their ids in the released tokenizers
QWEN2_SPECIAL_TOKENS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
                        "<|vision_start|>": 151652, "<|vision_end|>": 151653, "<|image_pad|>": 151655,
                        "<|video_pad|>": 151656}


def _word_tokenizer(words: Sequence[str], specials: dict, pad_token: str, **named):
    """A ``transformers`` fast tokenizer over ``words``: a whitespace-split
    WordLevel model with ``specials`` pinned to their ids as special tokens
    (``<unk>`` at 0 unless ``specials`` places it), the words at the lowest
    free ids, reserved tokens filling the rest up to the last id (so the
    vocabulary has no holes), ``pad_token`` (one of ``specials``) as its pad
    token and ``named`` (``bos_token=``, ...) naming others."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0} if "<unk>" not in specials else {}
    vocab.update(specials)
    taken = set(vocab.values())
    free = (i for i in range(len(vocab) + len(words) + len(taken)) if i not in taken)
    for w in words:
        if w not in vocab:
            vocab[w] = next(free)
    used = set(vocab.values())
    vocab.update({f"<|reserved_{i}|>": i for i in range(max(used) + 1) if i not in used})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", pad_token=pad_token, **named,
                                   additional_special_tokens=[t for t in specials
                                                              if t not in (pad_token, "<unk>", *named.values())])


def qwen_word_tokenizer(words: Sequence[str]):
    """:func:`_word_tokenizer` with :data:`QWEN2_SPECIAL_TOKENS` at their
    ids and ``<|endoftext|>`` as its pad token."""
    return _word_tokenizer(words, QWEN2_SPECIAL_TOKENS, "<|endoftext|>")


# PaliGemma's special tokens at their ids in the released tokenizer (<image> at the config's image_token_index)
PALIGEMMA_SPECIAL_TOKENS = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3}


def paligemma_word_tokenizer(words: Sequence[str], image_token_id: int = 257152):
    """:func:`_word_tokenizer` with :data:`PALIGEMMA_SPECIAL_TOKENS` and
    ``<image>`` at ``image_token_id``, ``<pad>``, ``<bos>`` and ``<eos>``
    named: what ``ColPaliProcessor.from_pretrained`` loads from a
    checkpoint directory."""
    return _word_tokenizer(words, {**PALIGEMMA_SPECIAL_TOKENS, "<image>": image_token_id}, "<pad>",
                           bos_token="<bos>", eos_token="<eos>")


# Idefics3's special tokens at the ids of scripts/validate_checkpoint.py's colSmol tokenizer (the <row_r_col_c>
# markers of grids up to 6 x 6 at 49,153-49,188), and a pad token of its own
IDEFICS3_SPECIAL_TOKENS = {"<global-img>": 49152,
                           **{f"<row_{r}_col_{c}>": 49153 + (r - 1) * 6 + (c - 1)
                              for r in range(1, 7) for c in range(1, 7)},
                           "<fake_token_around_image>": 49189, "<image>": 49190, "<end_of_utterance>": 49191,
                           "<|im_start|>": 49192, "<pad>": 49193}


def idefics3_word_tokenizer(words: Sequence[str]):
    """:func:`_word_tokenizer` with :data:`IDEFICS3_SPECIAL_TOKENS` at their
    ids and ``<pad>`` as its pad token."""
    return _word_tokenizer(words, IDEFICS3_SPECIAL_TOKENS, "<pad>")


def _hf_number(v):
    """An integral float as an int, as HF's configs write their integer
    fields (a recent ``transformers`` checks the fields' types)."""
    return int(v) if isinstance(v, float) and v.is_integer() else v


def qwen_hf_config(config) -> dict:
    """The HF ``config.json`` of a ``Qwen2VLConfig`` or ``Qwen25VLConfig``:
    the vision fields under ``vision_config``, the text fields at the top
    (``head_dim`` implied by the heads), M-RoPE under ``rope_scaling``."""
    qwen25 = type(config).__name__ == "Qwen25VLConfig"
    text = {k: v for k, v in dataclasses.asdict(config.text).items() if k not in ("mrope_section", "head_dim")}
    if config.text.head_dim * config.text.num_attention_heads != config.text.hidden_size:
        raise ValueError("an HF Qwen2 config implies head_dim = hidden_size / num_attention_heads")
    vision = {k: list(v) if isinstance(v, tuple) else _hf_number(v)
              for k, v in dataclasses.asdict(config.vision).items()}  # "mlp_ratio": 4, as HF writes it
    return {"model_type": "qwen2_5_vl" if qwen25 else "qwen2_vl",
            "architectures": ["ColQwen2_5" if qwen25 else "ColQwen2"], "vision_config": vision, **text,
            "rope_scaling": {"type": "mrope", "mrope_section": list(config.text.mrope_section)},
            "image_token_id": config.image_token_id, "vision_start_token_id": config.vision_start_token_id,
            "video_token_id": config.video_token_id}


def write_qwen_checkpoint(directory: str, model, tokenizer, max_num_visual_tokens: int = 768) -> None:
    """``model`` (a ``ColQwen2`` or ``ColQwen2_5``) as an HF-format checkpoint
    in ``directory``: ``model.safetensors`` by the port's exporter,
    ``config.json``, ``preprocessor_config.json`` (Qwen's CLIP mean and std,
    a pixel budget of ``max_num_visual_tokens`` merged tokens) and the
    tokenizer's files."""
    from colpali_tpu_torch.processors.qwen2_vl import CLIP_MEAN, CLIP_STD
    from colpali_tpu_torch.training.checkpointing import save_pretrained

    save_pretrained(directory, model.state_dict(), config=model.config)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(qwen_hf_config(model.config), f)
    v = model.config.vision
    factor = v.patch_size * v.spatial_merge_size
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"patch_size": v.patch_size, "merge_size": v.spatial_merge_size,
                   "temporal_patch_size": v.temporal_patch_size,
                   "size": {"shortest_edge": 56 * 56, "longest_edge": max_num_visual_tokens * factor**2},
                   "image_mean": list(CLIP_MEAN), "image_std": list(CLIP_STD)}, f)
    tokenizer.save_pretrained(directory)


def qwen3_hf_config(config) -> dict:
    """The HF ``config.json`` of a ``Qwen3VLConfig``, laid out as
    ``scripts/gate_families.py`` writes it: ``vision_config``,
    ``text_config`` with the interleaved M-RoPE under ``rope_scaling``, and
    the special token ids."""
    text = {k: _hf_number(v) for k, v in dataclasses.asdict(config.text).items() if k != "mrope_section"}
    vision = {k: list(v) if isinstance(v, tuple) else _hf_number(v)
              for k, v in dataclasses.asdict(config.vision).items()}
    return {"model_type": "qwen3_vl", "architectures": ["ColQwen3"], "vision_config": vision,
            "text_config": {**text, "rope_scaling": {"rope_type": "default", "mrope_interleaved": True,
                                                     "mrope_section": list(config.text.mrope_section)}},
            "image_token_id": config.image_token_id, "vision_start_token_id": config.vision_start_token_id,
            "video_token_id": config.video_token_id}


def write_qwen3_checkpoint(directory: str, config, seed: int = 0, words: Sequence[str] = (), device="cuda") -> None:
    """A ColQwen3 of ``config`` (320-wide head) with seeded random bf16
    weights (HF's convention, :func:`~colpali_tpu_torch.models.common.hf_init_`),
    built on ``device``, as an HF-format checkpoint in ``directory``:
    ``model.safetensors`` by the port's exporter, ``config.json``
    (:func:`qwen3_hf_config`), ``preprocessor_config.json`` (the config's
    patches, mean and std 0.5, Qwen3-VL's pixel bounds of 65,536 and
    16,777,216) and :func:`qwen_word_tokenizer`'s files over the page
    prompt's words and ``words``."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.qwen3_vl import ColQwen3
    from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor
    from colpali_tpu_torch.training.checkpointing import save_pretrained

    model = ColQwen3(config, device=device, dtype=torch.bfloat16)
    hf_init_(model, torch.Generator(device=device).manual_seed(seed))
    save_pretrained(directory, model.state_dict(), config=config)
    del model
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(qwen3_hf_config(config), f)
    v = config.vision
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"patch_size": v.patch_size, "merge_size": v.spatial_merge_size,
                   "temporal_patch_size": v.temporal_patch_size,
                   "size": {"shortest_edge": 65536, "longest_edge": 16777216},
                   "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}, f)
    prompt = ColQwen2Processor.visual_prompt_prefix.replace("\n", " ").split()
    qwen_word_tokenizer([w for w in (*prompt, *words) if "<|" not in w]).save_pretrained(directory)


def qwen35_hf_config(config) -> dict:
    """The HF ``config.json`` of a ``Qwen35VLConfig``, laid out as
    ``scripts/gate_families.py`` writes it: ``vision_config``,
    ``text_config`` (M-RoPE sections, when set, under ``rope_scaling``),
    ``dim`` and the special token ids."""
    text = {k: list(v) if isinstance(v, tuple) else _hf_number(v) for k, v in dataclasses.asdict(config.text).items()
            if k not in ("mrope_section", "moe_capacity_factor") and v is not None}
    if config.text.mrope_section:
        text["rope_scaling"] = {"rope_type": "default", "mrope_section": list(config.text.mrope_section)}
    vision = {k: list(v) if isinstance(v, tuple) else _hf_number(v)
              for k, v in dataclasses.asdict(config.vision).items()}
    return {"model_type": "qwen3_5", "architectures": ["ColQwen3_5"], "vision_config": vision, "text_config": text,
            "dim": config.dim, "image_token_id": config.image_token_id,
            "vision_start_token_id": config.vision_start_token_id}


@torch.no_grad()
def _qwen35_init(model, generator: torch.Generator):
    """:func:`~colpali_tpu_torch.models.common.hf_init_`, and HF Qwen3-Next's
    draws for the parameters outside linears and norms: each GatedDeltaNet's
    conv kernel from uniform(+-K^-0.5) (a Conv1d's default), ``A_log`` =
    log(uniform(0, 16)), ``dt_bias`` and ``norm_weight`` one; stacked
    experts from normal(0, 0.02)."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.qwen3_5 import GatedDeltaNet, StackedExperts

    hf_init_(model, generator)
    for m in model.modules():
        if isinstance(m, GatedDeltaNet):
            k = m.conv1d_kernel.shape[0]
            m.conv1d_kernel.uniform_(-k**-0.5, k**-0.5, generator=generator)
            m.A_log.copy_(torch.empty_like(m.A_log).uniform_(0.0, 16.0, generator=generator).log())
            m.dt_bias.fill_(1.0)
            m.norm_weight.fill_(1.0)
        elif isinstance(m, StackedExperts):
            for p in (m.gate_proj, m.up_proj, m.down_proj):
                p.normal_(0.0, 0.02, generator=generator)
    return model


def write_qwen35_checkpoint(directory: str, config, seed: int = 0, words: Sequence[str] = (),
                            device="cuda") -> None:
    """A ColQwen3_5 of ``config`` with seeded random bf16 weights
    (HF Qwen3-Next's draws, :func:`_qwen35_init`), built on ``device``, as an HF-format checkpoint
    in ``directory``: ``model.safetensors`` by the port's exporter,
    ``config.json`` (:func:`qwen35_hf_config`), ``preprocessor_config.json``
    (as :func:`write_qwen3_checkpoint` writes it) and
    :func:`qwen_word_tokenizer`'s files over the page prompt's words and
    ``words``."""
    from colpali_tpu_torch.models.qwen3_5 import ColQwen3_5
    from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor
    from colpali_tpu_torch.training.checkpointing import save_pretrained

    model = ColQwen3_5(config, device=device, dtype=torch.bfloat16)
    _qwen35_init(model, torch.Generator(device=device).manual_seed(seed))
    save_pretrained(directory, model.state_dict(), config=config)
    del model
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(qwen35_hf_config(config), f)
    v = config.vision
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"patch_size": v.patch_size, "merge_size": v.spatial_merge_size,
                   "temporal_patch_size": v.temporal_patch_size,
                   "size": {"shortest_edge": 65536, "longest_edge": 16777216},
                   "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}, f)
    prompt = ColQwen2Processor.visual_prompt_prefix.replace("\n", " ").split()
    qwen_word_tokenizer([w for w in (*prompt, *words) if "<|" not in w]).save_pretrained(directory)


def idefics3_hf_config(config) -> dict:
    """The HF ``config.json`` of an ``Idefics3Config``: ``vision_config``,
    ``text_config`` (``head_dim`` implied by the heads, no q/k/v bias),
    ``scale_factor`` and ``image_token_id``."""
    text = {k: v for k, v in dataclasses.asdict(config.text).items()
            if k not in ("mrope_section", "head_dim", "attention_bias")}
    if config.text.head_dim * config.text.num_attention_heads != config.text.hidden_size:
        raise ValueError("an HF Idefics3 text config implies head_dim = hidden_size / num_attention_heads")
    return {"model_type": "idefics3", "architectures": ["ColIdefics3"],
            "vision_config": {**dataclasses.asdict(config.vision), "model_type": "idefics3_vision"},
            "text_config": {**text, "model_type": "llama"}, "scale_factor": config.scale_factor,
            "image_token_id": config.image_token_id}


def write_idefics3_checkpoint(directory: str, model, tokenizer, longest_edge: int = None) -> None:
    """``model`` (a ``ColIdefics3``) as an HF-format checkpoint in
    ``directory``: ``model.safetensors`` by the port's exporter (through
    :mod:`colpali_tpu_torch.core.safetensors`), ``config.json``,
    ``preprocessor_config.json`` (the tile size, ``longest_edge``, four
    tiles a side by default, and SmolVLM's mean and std of 0.5),
    ``processor_config.json`` (``image_seq_len``) and the tokenizer's files."""
    from colpali_tpu_torch.training.checkpointing import save_pretrained

    save_pretrained(directory, model.state_dict(), config=model.config)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(idefics3_hf_config(model.config), f)
    tile = model.config.vision.image_size
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"max_image_size": {"longest_edge": tile}, "size": {"longest_edge": longest_edge or 4 * tile},
                   "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}, f)
    with open(os.path.join(directory, "processor_config.json"), "w") as f:
        json.dump({"image_seq_len": model.config.image_seq_len}, f)
    tokenizer.save_pretrained(directory)


# queries of unequal lengths: the Idefics3 processors pad on the right, so under ``last`` pooling the shorter rows
# read a pad position (whose gradient reaches the valid keys through K6's ``kv_segments``)
IDEFICS3_TRAIN_QUERIES = ("what is the total revenue of the company in the last quarter ?", "a", "find the chart",
                          "describe the quarterly report page")


def tiny_idefics3_config(head_dim: int = 64):
    """An Idefics3 at toy width and depth with colSmol's architecture: a
    2-layer vision tower (two heads of ``head_dim``) over 64 px tiles of 16 px
    patches, pixel shuffle 2 (four tokens a tile), a 2-layer Qwen2 (Llama)
    decoder with GQA 3/1 heads of ``head_dim``, colSmol's vocabulary and
    ``<image>`` id (so :data:`IDEFICS3_SPECIAL_TOKENS` fit)."""
    from colpali_tpu_torch.models.idefics3 import Idefics3Config, Idefics3VisionConfig
    from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig

    return Idefics3Config(
        vision=Idefics3VisionConfig(hidden_size=2 * head_dim, intermediate_size=4 * head_dim, num_hidden_layers=2,
                                    num_attention_heads=2, image_size=64, patch_size=16),
        text=Qwen2TextConfig(vocab_size=49280, hidden_size=3 * head_dim, intermediate_size=6 * head_dim,
                             num_hidden_layers=2, num_attention_heads=3, num_key_value_heads=1, head_dim=head_dim,
                             rope_theta=100000.0, rms_norm_eps=1e-5, mrope_section=(head_dim // 2,),
                             attention_bias=False),
        scale_factor=2, image_token_id=49190)


def idefics3_training_examples(n: int, tile: int = 64, negatives: int = 0, seed: int = 0) -> list:
    """``n`` training examples for an Idefics3 processor of ``tile`` px tiles
    and a longest edge of ``4 * tile``: seeded noise pages of unequal tile
    counts (4 x 3 and the global view, 3 x 2 and it, and a page within one
    tile), :data:`IDEFICS3_TRAIN_QUERIES` in turn, and ``negatives`` pages
    of negatives each."""
    rng = np.random.default_rng(seed)
    shapes = ((5 * tile, 3 * tile + tile // 8), (5 * tile // 2, 3 * tile // 2), (tile - 4, tile // 2 + 8))
    pages = [rng.integers(0, 256, size=(*shapes[i % len(shapes)], 3), dtype=np.uint8)
             for i in range(n * (1 + negatives))]
    return [{"query": IDEFICS3_TRAIN_QUERIES[i % len(IDEFICS3_TRAIN_QUERIES)], "pos_target": pages[i],
             **({"neg_target": pages[n + negatives * i: n + negatives * (i + 1)]} if negatives else {})}
            for i in range(n)]


# Gemma3's special tokens at the ids of scripts/gate_families.py's synthetic tokenizer; ``<image_soft_token>``
# moves to the model config's ``image_token_index`` (262,144 in Gemma3-4B)
GEMMA3_SPECIAL_TOKENS = {"<pad>": 0, "<unk>": 1, "<bos>": 2, "<eos>": 3, "<start_of_turn>": 4, "<end_of_turn>": 5,
                         "<start_of_image>": 6, "<image_soft_token>": 7, "<end_of_image>": 8}
GEMMA3_PROMPT_WORDS = ("user", "Describe", "this", "image", "Query:")


def gemma3_word_tokenizer(words: Sequence[str], image_token_id: int = 7):
    """:func:`_word_tokenizer` with :data:`GEMMA3_SPECIAL_TOKENS`
    (``<image_soft_token>`` at ``image_token_id``), ``<pad>``, ``<bos>``
    and ``<eos>`` named, over the chat template's words and ``words``."""
    specials = {**GEMMA3_SPECIAL_TOKENS, "<image_soft_token>": image_token_id}
    return _word_tokenizer([*GEMMA3_PROMPT_WORDS, *words], specials, "<pad>", bos_token="<bos>", eos_token="<eos>")


def gemma3_hf_config(config) -> dict:
    """The HF ``config.json`` of a ``Gemma3Config``, laid out as
    ``scripts/gate_families.py`` writes it: ``vision_config`` (no pooling
    head), ``text_config`` with the linear ``rope_scaling``,
    ``mm_tokens_per_image`` and ``image_token_index``."""
    text = {k: _hf_number(v) for k, v in dataclasses.asdict(config.text).items()
            if k != "rope_scaling_factor" and v is not None}
    if config.text.layer_types is not None:
        text["layer_types"] = list(config.text.layer_types)
    return {"model_type": "gemma3", "architectures": ["ColGemma3"],
            "vision_config": {**{k: _hf_number(v) for k, v in dataclasses.asdict(config.vision).items()},
                              "vision_use_head": False},
            "text_config": {**text, "rope_scaling": {"rope_type": "linear",
                                                     "factor": float(config.text.rope_scaling_factor)}},
            "mm_tokens_per_image": config.mm_tokens_per_image, "image_token_index": config.image_token_index}


def write_gemma3_checkpoint(directory: str, config, seed: int = 0, words: Sequence[str] = (),
                            device="cuda") -> None:
    """A ColGemma3 of ``config`` with seeded random bf16 weights (HF's
    convention, :func:`~colpali_tpu_torch.models.common.hf_init_`, and the
    raw ``mm_input_projection`` from normal(0, 0.02) too), built on
    ``device``, as an HF-format checkpoint in ``directory``:
    ``model.safetensors`` by the port's exporter, ``config.json``
    (:func:`gemma3_hf_config`), ``preprocessor_config.json`` (the tower's
    image size, mean and std 0.5), ``processor_config.json``
    (``image_seq_length``) and :func:`gemma3_word_tokenizer`'s files over
    ``words``."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.gemma3 import ColGemma3
    from colpali_tpu_torch.training.checkpointing import save_pretrained

    model = ColGemma3(config, device=device, dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    hf_init_(model, gen)
    with torch.no_grad():
        model.model.mm_input_projection.normal_(0.0, 0.02, generator=gen)
    save_pretrained(directory, model.state_dict(), config=config)
    del model
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(gemma3_hf_config(config), f)
    size = config.vision.image_size
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"size": {"height": size, "width": size}, "image_mean": [0.5, 0.5, 0.5],
                   "image_std": [0.5, 0.5, 0.5]}, f)
    with open(os.path.join(directory, "processor_config.json"), "w") as f:
        json.dump({"image_seq_length": config.mm_tokens_per_image}, f)
    gemma3_word_tokenizer(words, config.image_token_index).save_pretrained(directory)


MODERNVBERT_PROMPT_WORDS = ("User:", "Describe", "the", "image.", "Assistant:")


def modernvbert_word_tokenizer(config, words: Sequence[str] = (), grid: int = 4):
    """:func:`_word_tokenizer` for a ``ModernVBertConfig``: ``<pad>`` at 0,
    ``<unk>`` at 1 and the prompt's and ``words``' words below the base
    vocabulary; ``<image>`` at ``config.image_token_id`` and the other tile
    tokens (``<global-img>``, ``<fake_token_around_image>``, the
    ``<row_r_col_c>`` markers of grids up to ``grid`` x ``grid``),
    ``<end_of_utterance>`` and ``<|begin_of_text|>`` at the lowest free ids
    of the additional vocabulary, as the released checkpoint's image token
    50,407 lies past its base vocabulary of 50,368 (so that
    ``DecoupledEmbed``'s second table is read)."""
    base = config.text.vocab_size
    names = ["<global-img>", "<fake_token_around_image>", "<end_of_utterance>", "<|begin_of_text|>",
             *(f"<row_{r}_col_{c}>" for r in range(1, grid + 1) for c in range(1, grid + 1))]
    free = (i for i in range(base, base + config.additional_vocab_size) if i != config.image_token_id)
    specials = {"<pad>": 0, "<unk>": 1, "<image>": config.image_token_id, **dict(zip(names, free))}
    if len(specials) != len(names) + 3 or not base <= config.image_token_id < base + config.additional_vocab_size:
        raise ValueError(f"{len(names) + 1} tile and prompt tokens do not fit the {config.additional_vocab_size} "
                         f"additional ids past {base} (the image token at {config.image_token_id})")
    return _word_tokenizer([*MODERNVBERT_PROMPT_WORDS, *words], specials, "<pad>")


def modernvbert_hf_config(config) -> dict:
    """The reference's composite ``config.json`` of a ``ModernVBertConfig``,
    laid out as ``scripts/gate_families.py`` writes it: a summary of each
    backbone (``embed_dim`` for the vision width) with ``vision_model_name``
    / ``text_model_name`` pointing at the backbone config directories
    ``backbones/siglip`` and ``backbones/modernbert``, relative to the
    checkpoint."""
    v, t = config.vision, config.text
    return {"model_type": "modernvbert", "architectures": ["ColModernVBert"],
            "vision_config": {"vision_model_name": os.path.join("backbones", "siglip"), "embed_dim": v.hidden_size,
                              "image_size": v.image_size, "patch_size": v.patch_size,
                              "num_hidden_layers": v.num_hidden_layers, "intermediate_size": v.intermediate_size},
            "text_config": {"text_model_name": os.path.join("backbones", "modernbert"), "hidden_size": t.hidden_size,
                            "num_hidden_layers": t.num_hidden_layers, "intermediate_size": t.intermediate_size,
                            "vocab_size": t.vocab_size, "mlp_bias": t.mlp_bias},
            "hidden_size": t.hidden_size, "vocab_size": t.vocab_size, "image_token_id": config.image_token_id,
            "pixel_shuffle_factor": config.pixel_shuffle_factor,
            "additional_vocab_size": config.additional_vocab_size, "pad_token_id": 0}


def write_modernvbert_checkpoint(directory: str, config, seed: int = 0, words: Sequence[str] = (),
                                 device="cuda") -> None:
    """A ColModernVBert of ``config`` with seeded random bf16 weights (HF's
    convention, :func:`~colpali_tpu_torch.models.common.hf_init_`), built
    on ``device``, as an HF-format checkpoint in ``directory``:
    ``model.safetensors`` by the port's exporter, the composite
    ``config.json`` (:func:`modernvbert_hf_config`) and the two backbone
    configs it names, ``preprocessor_config.json`` (the tower's tiles, a
    longest edge of four tiles, mean and std 0.5), ``processor_config.json``
    (``image_seq_len``) and :func:`modernvbert_word_tokenizer`'s files over
    ``words``."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.modernvbert import ColModernVBert
    from colpali_tpu_torch.training.checkpointing import save_pretrained

    model = ColModernVBert(config, device=device, dtype=torch.bfloat16)
    hf_init_(model, torch.Generator(device=device).manual_seed(seed))
    save_pretrained(directory, model.state_dict(), config=config)
    del model
    v = config.vision
    backbones = {"siglip": {"model_type": "siglip_vision_model", **dataclasses.asdict(v), "vision_use_head": False},
                 "modernbert": {"model_type": "modernbert", **dataclasses.asdict(config.text), "pad_token_id": 0}}
    for name, backbone in backbones.items():
        os.makedirs(os.path.join(directory, "backbones", name), exist_ok=True)
        with open(os.path.join(directory, "backbones", name, "config.json"), "w") as f:
            json.dump(backbone, f)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(modernvbert_hf_config(config), f)
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"max_image_size": {"longest_edge": v.image_size}, "size": {"longest_edge": 4 * v.image_size},
                   "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}, f)
    with open(os.path.join(directory, "processor_config.json"), "w") as f:
        json.dump({"image_seq_len": config.image_seq_len}, f)
    modernvbert_word_tokenizer(config, words).save_pretrained(directory)
