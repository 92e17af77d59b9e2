"""HF checkpoint -> the port's ColPali state dict (counterpart of
:mod:`colpali_tpu.core.hf_loader`, PaliGemma family).

Checkpoint keys are first normalized across transformers-version layouts
and merged-LoRA exports (:data:`PALIGEMMA_KEY_REMAPS`, unmerged LoRA
factors dropped), then each key is translated by the first rule of
:data:`PALIGEMMA_RULES` whose regex matches it in full: ``(torch key regex,
port name template, transform)``. Templates use ``{i}`` and ``{j}`` for the
first and second captured group; an empty template drops the key on
purpose. The port keeps torch's layouts (``nn.Linear`` weights are ``(out,
in)`` as in the checkpoint), except SigLIP's patch convolution, which the
port runs as an im2col product: the conv weight ``(O, C, p, p)`` becomes
``(O, p * p * C)`` in ``(kh, kw, c)`` order.

Weights are read by the port's own safetensors reader
(:mod:`colpali_tpu_torch.core.safetensors`): no ``safetensors`` or
``transformers`` package is needed.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from colpali_tpu_torch.core import safetensors

PALIGEMMA_KEY_REMAPS: Tuple[Tuple[str, str], ...] = (
    (r"^base_model\.model\.", ""),  # merged-LoRA exports
    (r"^model\.language_model\.model\.", "model.language_model."),  # transformers<5 nesting
    (r"^model\.language_model\.lm_head\.", "lm_head."),
    (r"^language_model\.model\.", "model.language_model."),
    (r"^vision_tower\.", "model.vision_tower."),
    (r"^multi_modal_projector\.", "model.multi_modal_projector."),
    (r"\.lora_[AB]\.", ".__lora__."),  # marker: unmerged LoRA factors are skipped
)


def normalize_keys(state_dict: Mapping[str, Any], remaps: Tuple[Tuple[str, str], ...]) -> Dict[str, Any]:
    """Apply every regex remap in order to each key; drop unmerged-LoRA
    factor keys."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        for pattern, repl in remaps:
            key = re.sub(pattern, repl, key)
        if "__lora__" in key:
            continue
        out[key] = value
    return out


def t_id(w: torch.Tensor) -> torch.Tensor:
    return w


def t_conv2d(w: torch.Tensor) -> torch.Tensor:
    """torch Conv2d weight ``(O, C, kH, kW)`` -> the im2col weight ``(O, kH * kW * C)``."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


_RuleT = Tuple[str, str, Callable[[torch.Tensor], torch.Tensor]]

_VISION = r"model\.vision_tower\.vision_model\."
_LAYER = _VISION + r"encoder\.layers\.(\d+)\."
PALIGEMMA_RULES: Tuple[_RuleT, ...] = (
    # --- SigLIP vision tower ---
    (_VISION + r"embeddings\.patch_embedding\.weight", "model.vision_tower.patch_embedding.weight", t_conv2d),
    (_VISION + r"embeddings\.patch_embedding\.bias", "model.vision_tower.patch_embedding.bias", t_id),
    (_VISION + r"embeddings\.position_embedding\.weight", "model.vision_tower.position_embedding.weight", t_id),
    (_LAYER + r"layer_norm([12])\.weight", "model.vision_tower.layers.{i}.layer_norm{j}.weight", t_id),
    (_LAYER + r"layer_norm([12])\.bias", "model.vision_tower.layers.{i}.layer_norm{j}.bias", t_id),
    (_LAYER + r"self_attn\.(q|k|v)_proj\.weight", "model.vision_tower.layers.{i}.self_attn.{j}_proj.weight", t_id),
    (_LAYER + r"self_attn\.(q|k|v)_proj\.bias", "model.vision_tower.layers.{i}.self_attn.{j}_proj.bias", t_id),
    (_LAYER + r"self_attn\.out_proj\.weight", "model.vision_tower.layers.{i}.self_attn.o_proj.weight", t_id),
    (_LAYER + r"self_attn\.out_proj\.bias", "model.vision_tower.layers.{i}.self_attn.o_proj.bias", t_id),
    (_LAYER + r"mlp\.fc([12])\.weight", "model.vision_tower.layers.{i}.mlp.fc{j}.weight", t_id),
    (_LAYER + r"mlp\.fc([12])\.bias", "model.vision_tower.layers.{i}.mlp.fc{j}.bias", t_id),
    (_VISION + r"post_layernorm\.weight", "model.vision_tower.post_layernorm.weight", t_id),
    (_VISION + r"post_layernorm\.bias", "model.vision_tower.post_layernorm.bias", t_id),
    # --- projector ---
    (r"model\.multi_modal_projector\.linear\.weight", "model.multi_modal_projector.weight", t_id),
    (r"model\.multi_modal_projector\.linear\.bias", "model.multi_modal_projector.bias", t_id),
    # --- Gemma LM ---
    (r"model\.language_model\.embed_tokens\.weight", "model.language_model.embed_tokens.weight", t_id),
    (r"model\.language_model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)\.weight",
     "model.language_model.layers.{i}.{j}.weight", t_id),
    (r"model\.language_model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight",
     "model.language_model.layers.{i}.self_attn.{j}_proj.weight", t_id),
    (r"model\.language_model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight",
     "model.language_model.layers.{i}.mlp.{j}_proj.weight", t_id),
    (r"model\.language_model\.norm\.weight", "model.language_model.norm.weight", t_id),
    # --- retrieval head (ColPali checkpoints) ---
    (r"(?:model\.)?custom_text_proj\.weight", "head.custom_text_proj.weight", t_id),
    (r"(?:model\.)?custom_text_proj\.bias", "head.custom_text_proj.bias", t_id),
    # --- dropped ---
    (r"lm_head\.weight", "", t_id),
    (r".*rotary_emb\.inv_freq", "", t_id),
    # SigLIP's attention-pooling head: in some checkpoints, unused by PaliGemma
    (_VISION + r"head\..*", "", t_id),
)


def convert_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    rules: Tuple[_RuleT, ...],
    remaps: Tuple[Tuple[str, str], ...] = (),
    strict: bool = True,
) -> Dict[str, torch.Tensor]:
    """Translate a checkpoint state dict into the port's names and layouts;
    with ``strict``, a key that no rule matches raises."""
    params: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, value in normalize_keys(state_dict, remaps).items():
        for pattern, template, transform in rules:
            m = re.fullmatch(pattern, key)
            if m is None:
                continue
            if template == "":
                break  # dropped on purpose
            groups = m.groups()
            name = template
            if groups:
                name = name.replace("{i}", groups[0])
                if len(groups) > 1:
                    name = name.replace("{j}", groups[1])
            params[name] = transform(value)
            break
        else:
            unmatched.append(key)
    if unmatched and strict:
        raise ValueError(f"Unmatched checkpoint keys ({len(unmatched)}): {unmatched[:10]} ...")
    return params


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every ``*.safetensors`` shard in ``path`` (on the CPU)."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"No .safetensors files in {path}")
    state: Dict[str, torch.Tensor] = {}
    for fname in files:
        state.update(safetensors.load_file(os.path.join(path, fname)))
    return state


def load_hf_config(path: str) -> Dict[str, Any]:
    """``config.json`` of a checkpoint directory, with ``_checkpoint_dir``
    (its absolute path) added when absent."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg.setdefault("_checkpoint_dir", os.path.abspath(path))
    return cfg


def load_colpali_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)PaliGemma HF checkpoint directory -> the port's ``ColPali``
    state dict (in the checkpoint's dtypes, on the CPU)."""
    state = load_safetensors_dir(checkpoint_dir)
    return convert_state_dict(state, PALIGEMMA_RULES, PALIGEMMA_KEY_REMAPS, strict=strict)
