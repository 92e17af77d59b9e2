"""HF checkpoint -> the port's state dict (counterpart of
:mod:`colpali_tpu.core.hf_loader`: the PaliGemma, Qwen2-VL, Qwen3-VL,
Qwen3.5, Idefics3, Gemma3 and ModernVBert families).

Checkpoint keys are first normalized across transformers-version layouts
and merged-LoRA exports (:data:`PALIGEMMA_KEY_REMAPS`, unmerged LoRA
factors dropped), then each key is translated by the first rule of
:data:`PALIGEMMA_RULES` whose regex matches it in full: ``(torch key regex,
port name template, transform)``. Templates use ``{i}`` and ``{j}`` for the
first and second captured group; an empty template drops the key on
purpose. The port keeps torch's layouts (``nn.Linear`` weights are ``(out,
in)`` as in the checkpoint), except the patch convolutions, which the port
runs as products: SigLIP's conv weight ``(O, C, p, p)`` becomes ``(O, p * p
* C)`` in ``(kh, kw, c)`` order, Qwen's Conv3d ``(O, C, T, p, p)`` becomes
``(O, C * T * p * p)``, and Qwen3.5's depthwise Conv1d ``(C, 1, K)`` the
JAX package's ``(K, C)`` kernel; Qwen3.5's per-expert MoE weights are
stacked into ``(E, d_in, d_out)`` arrays. Qwen's fused vision ``qkv`` and ModernBERT's fused
``Wqkv`` are split first.

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


# --- the Qwen2-VL family ---------------------------------------------------

QWEN2_VL_KEY_REMAPS: Tuple[Tuple[str, str], ...] = (
    (r"^base_model\.model\.", ""),  # merged-LoRA exports
    (r"^model\.layers\.", "language_model.layers."),  # the reference's remap (modeling_colqwen2.py:21-24)
    (r"^model\.visual\.", "visual."),
    (r"^model\.language_model\.", "language_model."),
    (r"^model\.embed_tokens\.", "language_model.embed_tokens."),
    (r"^model\.norm\.", "language_model.norm."),
    (r"\.lora_[AB]\.", ".__lora__."),
)


def t_conv3d_patch(w: torch.Tensor) -> torch.Tensor:
    """torch Conv3d patch weight ``(O, C, T, pH, pW)`` -> the linear weight
    ``(O, C * T * pH * pW)``: stride equals kernel equals patch, so the conv is
    a product with the flattened patch, in ``(C, T, pH, pW)`` order (HF
    PatchEmbed, modeling_qwen2_vl.py:246-252)."""
    return w.reshape(w.shape[0], -1).contiguous()


def split_fused_qkv(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Split HF's fused vision ``attn.qkv`` ``(3E, E)`` (and its bias) into
    q/k/v projections."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        m = re.fullmatch(r"(.*\.attn)\.qkv\.(weight|bias)", key)
        if m is None:
            out[key] = value
            continue
        for name, part in zip("qkv", value.chunk(3, dim=0)):
            out[f"{m.group(1)}.{name}_proj.{m.group(2)}"] = part.contiguous()
    return out


_QBLOCK = r"visual\.blocks\.(\d+)\."
_QLAYER = r"language_model\.layers\.(\d+)\."
_QWEN2_TEXT_RULES: Tuple[_RuleT, ...] = (
    (r"language_model\.embed_tokens\.weight", "model.language_model.embed_tokens.weight", t_id),
    (_QLAYER + r"(input_layernorm|post_attention_layernorm)\.weight", "model.language_model.layers.{i}.{j}.weight",
     t_id),
    (_QLAYER + r"self_attn\.(q|k|v|o)_proj\.weight", "model.language_model.layers.{i}.self_attn.{j}_proj.weight",
     t_id),
    (_QLAYER + r"self_attn\.(q|k|v)_proj\.bias", "model.language_model.layers.{i}.self_attn.{j}_proj.bias", t_id),
    (_QLAYER + r"mlp\.(gate|up|down)_proj\.weight", "model.language_model.layers.{i}.mlp.{j}_proj.weight", t_id),
    (r"language_model\.norm\.weight", "model.language_model.norm.weight", t_id),
    # --- retrieval head ---
    (r"custom_text_proj\.weight", "head.custom_text_proj.weight", t_id),
    (r"custom_text_proj\.bias", "head.custom_text_proj.bias", t_id),
    # --- dropped ---
    (r"lm_head\.weight", "", t_id),
    (r".*rotary_emb\.inv_freq", "", t_id),
)
_QWEN_VISION_ATTN_RULES: Tuple[_RuleT, ...] = (
    (r"visual\.patch_embed\.proj\.weight", "model.visual.patch_embed.weight", t_conv3d_patch),
    # a fused qkv is split by split_fused_qkv before the rules
    (_QBLOCK + r"attn\.(q|k|v)_proj\.weight", "model.visual.blocks.{i}.attn.{j}_proj.weight", t_id),
    (_QBLOCK + r"attn\.(q|k|v)_proj\.bias", "model.visual.blocks.{i}.attn.{j}_proj.bias", t_id),
    (_QBLOCK + r"attn\.proj\.weight", "model.visual.blocks.{i}.attn.o_proj.weight", t_id),
    (_QBLOCK + r"attn\.proj\.bias", "model.visual.blocks.{i}.attn.o_proj.bias", t_id),
    (r"visual\.merger\.mlp\.0\.weight", "model.visual.merger_fc1.weight", t_id),
    (r"visual\.merger\.mlp\.0\.bias", "model.visual.merger_fc1.bias", t_id),
    (r"visual\.merger\.mlp\.2\.weight", "model.visual.merger_fc2.weight", t_id),
    (r"visual\.merger\.mlp\.2\.bias", "model.visual.merger_fc2.bias", t_id),
)
QWEN2_VL_RULES: Tuple[_RuleT, ...] = _QWEN_VISION_ATTN_RULES + (
    (_QBLOCK + r"norm([12])\.weight", "model.visual.blocks.{i}.norm{j}.weight", t_id),
    (_QBLOCK + r"norm([12])\.bias", "model.visual.blocks.{i}.norm{j}.bias", t_id),
    (_QBLOCK + r"mlp\.fc([12])\.weight", "model.visual.blocks.{i}.fc{j}.weight", t_id),
    (_QBLOCK + r"mlp\.fc([12])\.bias", "model.visual.blocks.{i}.fc{j}.bias", t_id),
    (r"visual\.merger\.ln_q\.weight", "model.visual.ln_q.weight", t_id),
    (r"visual\.merger\.ln_q\.bias", "model.visual.ln_q.bias", t_id),
) + _QWEN2_TEXT_RULES
QWEN25_VL_RULES: Tuple[_RuleT, ...] = _QWEN_VISION_ATTN_RULES + (
    # RMSNorm blocks, a biased SwiGLU MLP, an RMSNorm ln_q
    (_QBLOCK + r"norm([12])\.weight", "model.visual.blocks.{i}.norm{j}.weight", t_id),
    (_QBLOCK + r"mlp\.(gate|up|down)_proj\.weight", "model.visual.blocks.{i}.mlp.{j}_proj.weight", t_id),
    (_QBLOCK + r"mlp\.(gate|up|down)_proj\.bias", "model.visual.blocks.{i}.mlp.{j}_proj.bias", t_id),
    (r"visual\.merger\.ln_q\.weight", "model.visual.ln_q.weight", t_id),
) + _QWEN2_TEXT_RULES


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


def _load_qwen(checkpoint_dir: str, rules: Tuple[_RuleT, ...], strict: bool) -> Dict[str, torch.Tensor]:
    state = split_fused_qkv(normalize_keys(load_safetensors_dir(checkpoint_dir), QWEN2_VL_KEY_REMAPS))
    return convert_state_dict(state, rules, (), strict=strict)


def load_colqwen2_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)Qwen2-VL HF checkpoint directory -> the port's ``ColQwen2``
    state dict (in the checkpoint's dtypes, on the CPU)."""
    return _load_qwen(checkpoint_dir, QWEN2_VL_RULES, strict)


def load_colqwen25_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)Qwen2.5-VL HF checkpoint directory -> the port's ``ColQwen2_5``
    state dict."""
    return _load_qwen(checkpoint_dir, QWEN25_VL_RULES, strict)


# --- the Qwen3-VL family -------------------------------------------------------

_DEEPSTACK = r"visual\.deepstack_merger_list\.(\d+)\."
QWEN3_VL_RULES: Tuple[_RuleT, ...] = (
    # --- vision tower: a biased patch embedding, the learned position table, LayerNorm blocks, deepstack ---
    (r"visual\.patch_embed\.proj\.weight", "model.visual.patch_embed.weight", t_conv3d_patch),
    (r"visual\.patch_embed\.proj\.bias", "model.visual.patch_embed.bias", t_id),
    (r"visual\.pos_embed\.weight", "model.visual.pos_embed.weight", t_id),
    (_QBLOCK + r"norm([12])\.weight", "model.visual.blocks.{i}.norm{j}.weight", t_id),
    (_QBLOCK + r"norm([12])\.bias", "model.visual.blocks.{i}.norm{j}.bias", t_id),
    # a fused qkv is split by split_fused_qkv before the rules
    (_QBLOCK + r"attn\.(q|k|v)_proj\.weight", "model.visual.blocks.{i}.attn.{j}_proj.weight", t_id),
    (_QBLOCK + r"attn\.(q|k|v)_proj\.bias", "model.visual.blocks.{i}.attn.{j}_proj.bias", t_id),
    (_QBLOCK + r"attn\.proj\.weight", "model.visual.blocks.{i}.attn.o_proj.weight", t_id),
    (_QBLOCK + r"attn\.proj\.bias", "model.visual.blocks.{i}.attn.o_proj.bias", t_id),
    (_QBLOCK + r"mlp\.linear_fc([12])\.weight", "model.visual.blocks.{i}.linear_fc{j}.weight", t_id),
    (_QBLOCK + r"mlp\.linear_fc([12])\.bias", "model.visual.blocks.{i}.linear_fc{j}.bias", t_id),
    (r"visual\.merger\.norm\.weight", "model.visual.merger.norm.weight", t_id),
    (r"visual\.merger\.norm\.bias", "model.visual.merger.norm.bias", t_id),
    (r"visual\.merger\.linear_fc([12])\.weight", "model.visual.merger.linear_fc{i}.weight", t_id),
    (r"visual\.merger\.linear_fc([12])\.bias", "model.visual.merger.linear_fc{i}.bias", t_id),
    (_DEEPSTACK + r"norm\.weight", "model.visual.deepstack_merger_{i}.norm.weight", t_id),
    (_DEEPSTACK + r"norm\.bias", "model.visual.deepstack_merger_{i}.norm.bias", t_id),
    (_DEEPSTACK + r"linear_fc([12])\.weight", "model.visual.deepstack_merger_{i}.linear_fc{j}.weight", t_id),
    (_DEEPSTACK + r"linear_fc([12])\.bias", "model.visual.deepstack_merger_{i}.linear_fc{j}.bias", t_id),
    # --- Qwen3 text decoder: q/k norms, no projection biases ---
    (_QLAYER + r"self_attn\.(q|k)_norm\.weight", "model.language_model.layers.{i}.self_attn.{j}_norm.weight", t_id),
) + tuple(rule for rule in _QWEN2_TEXT_RULES if not rule[0].endswith(r"self_attn\.(q|k|v)_proj\.bias"))


def load_colqwen3_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)Qwen3-VL HF checkpoint directory -> the port's ``ColQwen3``
    state dict (in the checkpoint's dtypes, on the CPU)."""
    return _load_qwen(checkpoint_dir, QWEN3_VL_RULES, strict)


# --- the Qwen3.5 family --------------------------------------------------------

def t_conv1d_depthwise(w: torch.Tensor) -> torch.Tensor:
    """torch depthwise Conv1d weight ``(C, 1, K)`` -> the JAX package's kernel ``(K, C)``."""
    return w[:, 0, :].T.contiguous()


QWEN35_RULES: Tuple[_RuleT, ...] = (
    (r"language_model\.embed_tokens\.weight", "model.language_model.embed_tokens.weight", t_id),
    (_QLAYER + r"(input_layernorm|post_attention_layernorm)\.weight", "model.language_model.layers.{i}.{j}.weight",
     t_id),
    # --- gated full attention ---
    (_QLAYER + r"self_attn\.(q|k|v|o)_proj\.weight", "model.language_model.layers.{i}.self_attn.{j}_proj.weight",
     t_id),
    (_QLAYER + r"self_attn\.(q|k)_norm\.weight", "model.language_model.layers.{i}.self_attn.{j}_norm.weight", t_id),
    # --- GatedDeltaNet ---
    (_QLAYER + r"linear_attn\.in_proj_(qkvz|ba)\.weight",
     "model.language_model.layers.{i}.linear_attn.in_proj_{j}.weight", t_id),
    (_QLAYER + r"linear_attn\.conv1d\.weight", "model.language_model.layers.{i}.linear_attn.conv1d_kernel",
     t_conv1d_depthwise),
    (_QLAYER + r"linear_attn\.A_log", "model.language_model.layers.{i}.linear_attn.A_log", t_id),
    (_QLAYER + r"linear_attn\.dt_bias", "model.language_model.layers.{i}.linear_attn.dt_bias", t_id),
    (_QLAYER + r"linear_attn\.norm\.weight", "model.language_model.layers.{i}.linear_attn.norm_weight", t_id),
    (_QLAYER + r"linear_attn\.out_proj\.weight", "model.language_model.layers.{i}.linear_attn.out_proj.weight", t_id),
    # --- dense MLPs, and MoE: the router, the shared expert and its gate, the experts stacked by
    # stack_expert_weights before the rules (per-expert keys never reach them) ---
    (_QLAYER + r"mlp\.(gate|up|down)_proj\.weight", "model.language_model.layers.{i}.mlp.{j}_proj.weight", t_id),
    (_QLAYER + r"mlp\.gate\.weight", "model.language_model.layers.{i}.mlp.gate.weight", t_id),
    (_QLAYER + r"mlp\.shared_expert_gate\.weight", "model.language_model.layers.{i}.mlp.shared_expert_gate.weight",
     t_id),
    (_QLAYER + r"mlp\.shared_expert\.(gate|up|down)_proj\.weight",
     "model.language_model.layers.{i}.mlp.shared_expert.{j}_proj.weight", t_id),
    (_QLAYER + r"mlp\.experts\.(gate|up|down)_proj", "model.language_model.layers.{i}.mlp.experts.{j}_proj", t_id),
    (r"language_model\.norm\.weight", "model.language_model.norm.weight", t_id),
    # --- retrieval head ---
    (r"custom_text_proj\.weight", "head.custom_text_proj.weight", t_id),
    (r"custom_text_proj\.bias", "head.custom_text_proj.bias", t_id),
    # --- dropped ---
    (r"lm_head\.weight", "", t_id),
    (r".*rotary_emb\.inv_freq", "", t_id),
) + tuple(rule for rule in QWEN3_VL_RULES if rule[0].startswith(r"visual\."))  # Qwen3-VL's tower, deepstack included


def stack_expert_weights(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Replace HF's per-expert ``language_model.layers.{i}.mlp.experts.{e}.
    {gate,up,down}_proj.weight`` ``(d_out, d_in)`` by one stacked
    ``language_model.layers.{i}.mlp.experts.{gate,up,down}_proj`` ``(E,
    d_in, d_out)`` each, the layout of ``StackedExperts``."""
    pat = re.compile(r"(language_model\.layers\.\d+\.mlp\.experts)\.(\d+)\.(gate|up|down)_proj\.weight")
    groups: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        m = pat.fullmatch(key)
        if m is None:
            out[key] = value
        else:
            groups.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = value
    for (base, proj), by_expert in groups.items():
        if sorted(by_expert) != list(range(len(by_expert))):
            raise ValueError(f"{base}: experts {sorted(by_expert)} are not 0..{len(by_expert) - 1}")
        out[f"{base}.{proj}_proj"] = torch.stack([by_expert[e].T for e in range(len(by_expert))]).contiguous()
    return out


def load_colqwen35_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)Qwen3.5 HF checkpoint directory -> the port's ``ColQwen3_5``
    (or ``BiQwen3_5``) state dict (in the checkpoint's dtypes, on the CPU),
    MoE experts stacked."""
    state = split_fused_qkv(normalize_keys(load_safetensors_dir(checkpoint_dir), QWEN2_VL_KEY_REMAPS))
    return convert_state_dict(stack_expert_weights(state), QWEN35_RULES, (), strict=strict)


# --- the Idefics3/SmolVLM family ---------------------------------------------

IDEFICS3_KEY_REMAPS: Tuple[Tuple[str, str], ...] = (
    (r"^base_model\.model\.", ""),
    (r"^model\.", ""),
    (r"\.lora_[AB]\.", ".__lora__."),
)

_I3_VT = r"vision_model\."
_I3_LAYER = _I3_VT + r"encoder\.layers\.(\d+)\."
_I3_TEXT = r"text_model\.layers\.(\d+)\."
IDEFICS3_RULES: Tuple[_RuleT, ...] = (
    # --- SigLIP-style vision tower ---
    (_I3_VT + r"embeddings\.patch_embedding\.weight", "model.vision_model.patch_embedding.weight", t_conv2d),
    (_I3_VT + r"embeddings\.patch_embedding\.bias", "model.vision_model.patch_embedding.bias", t_id),
    (_I3_VT + r"embeddings\.position_embedding\.weight", "model.vision_model.position_embedding.weight", t_id),
    (_I3_LAYER + r"layer_norm([12])\.weight", "model.vision_model.layers.{i}.layer_norm{j}.weight", t_id),
    (_I3_LAYER + r"layer_norm([12])\.bias", "model.vision_model.layers.{i}.layer_norm{j}.bias", t_id),
    (_I3_LAYER + r"self_attn\.(q|k|v)_proj\.weight", "model.vision_model.layers.{i}.self_attn.{j}_proj.weight", t_id),
    (_I3_LAYER + r"self_attn\.(q|k|v)_proj\.bias", "model.vision_model.layers.{i}.self_attn.{j}_proj.bias", t_id),
    (_I3_LAYER + r"self_attn\.out_proj\.weight", "model.vision_model.layers.{i}.self_attn.o_proj.weight", t_id),
    (_I3_LAYER + r"self_attn\.out_proj\.bias", "model.vision_model.layers.{i}.self_attn.o_proj.bias", t_id),
    (_I3_LAYER + r"mlp\.fc([12])\.weight", "model.vision_model.layers.{i}.mlp.fc{j}.weight", t_id),
    (_I3_LAYER + r"mlp\.fc([12])\.bias", "model.vision_model.layers.{i}.mlp.fc{j}.bias", t_id),
    (_I3_VT + r"post_layernorm\.weight", "model.vision_model.post_layernorm.weight", t_id),
    (_I3_VT + r"post_layernorm\.bias", "model.vision_model.post_layernorm.bias", t_id),
    # --- connector ---
    (r"connector\.modality_projection\.proj\.weight", "model.modality_projection.weight", t_id),
    # --- Llama/SmolLM text decoder ---
    (r"text_model\.embed_tokens\.weight", "model.text_model.embed_tokens.weight", t_id),
    (_I3_TEXT + r"(input_layernorm|post_attention_layernorm)\.weight", "model.text_model.layers.{i}.{j}.weight", t_id),
    (_I3_TEXT + r"self_attn\.(q|k|v|o)_proj\.weight", "model.text_model.layers.{i}.self_attn.{j}_proj.weight", t_id),
    (_I3_TEXT + r"mlp\.(gate|up|down)_proj\.weight", "model.text_model.layers.{i}.mlp.{j}_proj.weight", t_id),
    (r"text_model\.norm\.weight", "model.text_model.norm.weight", t_id),
    # --- retrieval head (named `linear` in ColIdefics3) ---
    (r"linear\.weight", "head.linear.weight", t_id),
    (r"linear\.bias", "head.linear.bias", t_id),
    # --- dropped ---
    (r"lm_head\.weight", "", t_id),
    (r".*rotary_emb\.inv_freq", "", t_id),
)


def load_colidefics3_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)Idefics3/SmolVLM HF checkpoint directory -> the port's
    ``ColIdefics3`` state dict (in the checkpoint's dtypes, on the CPU)."""
    state = load_safetensors_dir(checkpoint_dir)
    return convert_state_dict(state, IDEFICS3_RULES, IDEFICS3_KEY_REMAPS, strict=strict)


# --- the Gemma3 family ---------------------------------------------------------

GEMMA3_KEY_REMAPS: Tuple[Tuple[str, str], ...] = (
    (r"^base_model\.model\.", ""),
    (r"^model\.", ""),  # ColGemma3 nests Gemma3Model under .model in some exports
    (r"^language_model\.model\.", "language_model."),  # HF's _checkpoint_conversion_mapping
    (r"\.lora_[AB]\.", ".__lora__."),
)

_G3_VT = r"vision_tower\.vision_model\."
_G3_LAYER = _G3_VT + r"encoder\.layers\.(\d+)\."
_G3_TEXT = r"language_model\.layers\.(\d+)\."
GEMMA3_RULES: Tuple[_RuleT, ...] = (
    # --- SigLIP vision tower (PaliGemma's layout) ---
    (_G3_VT + r"embeddings\.patch_embedding\.weight", "model.vision_tower.patch_embedding.weight", t_conv2d),
    (_G3_VT + r"embeddings\.patch_embedding\.bias", "model.vision_tower.patch_embedding.bias", t_id),
    (_G3_VT + r"embeddings\.position_embedding\.weight", "model.vision_tower.position_embedding.weight", t_id),
    (_G3_LAYER + r"layer_norm([12])\.weight", "model.vision_tower.layers.{i}.layer_norm{j}.weight", t_id),
    (_G3_LAYER + r"layer_norm([12])\.bias", "model.vision_tower.layers.{i}.layer_norm{j}.bias", t_id),
    (_G3_LAYER + r"self_attn\.(q|k|v)_proj\.weight", "model.vision_tower.layers.{i}.self_attn.{j}_proj.weight", t_id),
    (_G3_LAYER + r"self_attn\.(q|k|v)_proj\.bias", "model.vision_tower.layers.{i}.self_attn.{j}_proj.bias", t_id),
    (_G3_LAYER + r"self_attn\.out_proj\.weight", "model.vision_tower.layers.{i}.self_attn.o_proj.weight", t_id),
    (_G3_LAYER + r"self_attn\.out_proj\.bias", "model.vision_tower.layers.{i}.self_attn.o_proj.bias", t_id),
    (_G3_LAYER + r"mlp\.fc([12])\.weight", "model.vision_tower.layers.{i}.mlp.fc{j}.weight", t_id),
    (_G3_LAYER + r"mlp\.fc([12])\.bias", "model.vision_tower.layers.{i}.mlp.fc{j}.bias", t_id),
    (_G3_VT + r"post_layernorm\.weight", "model.vision_tower.post_layernorm.weight", t_id),
    (_G3_VT + r"post_layernorm\.bias", "model.vision_tower.post_layernorm.bias", t_id),
    (_G3_VT + r"head\..*", "", t_id),
    # --- projector: the raw (V, T) matrix, as HF holds it ---
    (r"multi_modal_projector\.mm_input_projection_weight", "model.mm_input_projection", t_id),
    (r"multi_modal_projector\.mm_soft_emb_norm\.weight", "model.mm_soft_emb_norm.weight", t_id),
    # --- Gemma3 text decoder ---
    (r"language_model\.embed_tokens\.weight", "model.language_model.embed_tokens.weight", t_id),
    (_G3_TEXT + r"(input_layernorm|post_attention_layernorm|pre_feedforward_layernorm|post_feedforward_layernorm)"
     r"\.weight", "model.language_model.layers.{i}.{j}.weight", t_id),
    (_G3_TEXT + r"self_attn\.(q|k|v|o)_proj\.weight", "model.language_model.layers.{i}.self_attn.{j}_proj.weight",
     t_id),
    (_G3_TEXT + r"self_attn\.(q|k)_norm\.weight", "model.language_model.layers.{i}.self_attn.{j}_norm.weight", t_id),
    (_G3_TEXT + r"mlp\.(gate|up|down)_proj\.weight", "model.language_model.layers.{i}.mlp.{j}_proj.weight", t_id),
    (r"language_model\.norm\.weight", "model.language_model.norm.weight", t_id),
    # --- retrieval head ---
    (r"custom_text_proj\.weight", "head.custom_text_proj.weight", t_id),
    (r"custom_text_proj\.bias", "head.custom_text_proj.bias", t_id),
    # --- dropped ---
    (r"lm_head\.weight", "", t_id),
    (r".*rotary_emb\.inv_freq", "", t_id),
)


def load_colgemma3_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)Gemma3 HF checkpoint directory -> the port's ``ColGemma3``
    state dict (in the checkpoint's dtypes, on the CPU)."""
    state = load_safetensors_dir(checkpoint_dir)
    return convert_state_dict(state, GEMMA3_RULES, GEMMA3_KEY_REMAPS, strict=strict)


# --- the ModernVBert family ------------------------------------------------------

def split_fused_wqkv(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Split ModernBERT's fused ``attn.Wqkv`` ``(3E, E)`` (and a bias) into
    q/k/v projections."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        m = re.fullmatch(r"(.*\.attn)\.Wqkv\.(weight|bias)", key)
        if m is None:
            out[key] = value
            continue
        for name, part in zip("qkv", value.chunk(3, dim=0)):
            out[f"{m.group(1)}.{name}_proj.{m.group(2)}"] = part.contiguous()
    return out


_MVB_VT = r"model\.vision_model\."
_MVB_LAYER = _MVB_VT + r"encoder\.layers\.(\d+)\."
_MVB_TEXT = r"model\.text_model\.layers\.(\d+)\."
MODERNVBERT_RULES: Tuple[_RuleT, ...] = (
    # --- SigLIP vision tower (the reference strips the SiglipModel wrapper: keys start at model.vision_model) ---
    (_MVB_VT + r"embeddings\.patch_embedding\.weight", "model.vision_model.patch_embedding.weight", t_conv2d),
    (_MVB_VT + r"embeddings\.patch_embedding\.bias", "model.vision_model.patch_embedding.bias", t_id),
    (_MVB_VT + r"embeddings\.position_embedding\.weight", "model.vision_model.position_embedding.weight", t_id),
    (_MVB_LAYER + r"layer_norm([12])\.weight", "model.vision_model.layers.{i}.layer_norm{j}.weight", t_id),
    (_MVB_LAYER + r"layer_norm([12])\.bias", "model.vision_model.layers.{i}.layer_norm{j}.bias", t_id),
    (_MVB_LAYER + r"self_attn\.(q|k|v)_proj\.weight", "model.vision_model.layers.{i}.self_attn.{j}_proj.weight", t_id),
    (_MVB_LAYER + r"self_attn\.(q|k|v)_proj\.bias", "model.vision_model.layers.{i}.self_attn.{j}_proj.bias", t_id),
    (_MVB_LAYER + r"self_attn\.out_proj\.weight", "model.vision_model.layers.{i}.self_attn.o_proj.weight", t_id),
    (_MVB_LAYER + r"self_attn\.out_proj\.bias", "model.vision_model.layers.{i}.self_attn.o_proj.bias", t_id),
    (_MVB_LAYER + r"mlp\.fc([12])\.weight", "model.vision_model.layers.{i}.mlp.fc{j}.weight", t_id),
    (_MVB_LAYER + r"mlp\.fc([12])\.bias", "model.vision_model.layers.{i}.mlp.fc{j}.bias", t_id),
    (_MVB_VT + r"post_layernorm\.weight", "model.vision_model.post_layernorm.weight", t_id),
    (_MVB_VT + r"post_layernorm\.bias", "model.vision_model.post_layernorm.bias", t_id),
    (_MVB_VT + r"head\..*", "", t_id),  # SigLIP's pooling head, unused
    # --- connector (pixel shuffle + a bias-free projection) ---
    (r"model\.connector\.modality_projection\.proj\.weight", "model.modality_projection.weight", t_id),
    # --- decoupled embeddings, attached at the text model's embeddings ---
    (r"model\.text_model\.embeddings\.tok_embeddings\.weight", "model.embeddings.tok_embeddings.weight", t_id),
    (r"model\.text_model\.embeddings\.tok_embeddings\.additional_embedding\.weight",
     "model.embeddings.additional_embedding.weight", t_id),
    (r"model\.text_model\.embeddings\.norm\.weight", "model.text_model.emb_norm.weight", t_id),
    # --- ModernBERT encoder (Wqkv split by split_fused_wqkv before the rules) ---
    (_MVB_TEXT + r"attn\.(q|k|v)_proj\.weight", "model.text_model.layers.{i}.attn.{j}_proj.weight", t_id),
    (_MVB_TEXT + r"attn\.Wo\.weight", "model.text_model.layers.{i}.attn.o_proj.weight", t_id),
    (_MVB_TEXT + r"attn_norm\.weight", "model.text_model.layers.{i}.attn_norm.weight", t_id),
    (_MVB_TEXT + r"mlp_norm\.weight", "model.text_model.layers.{i}.mlp_norm.weight", t_id),
    (_MVB_TEXT + r"mlp\.W([io])\.weight", "model.text_model.layers.{i}.W{j}.weight", t_id),
    (r"model\.text_model\.final_norm\.weight", "model.text_model.final_norm.weight", t_id),
    # --- retrieval head ---
    (r"(?:model\.)?custom_text_proj\.weight", "head.custom_text_proj.weight", t_id),
    (r"(?:model\.)?custom_text_proj\.bias", "head.custom_text_proj.bias", t_id),
)
# layer 0's attn_norm is the identity in HF (no weight); the port's uniform layers keep the parameter
MODERNVBERT_LAYER0_NORM = "model.text_model.layers.0.attn_norm.weight"


def load_colmodernvbert_params(checkpoint_dir: str, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A (Col)ModernVBert HF checkpoint directory -> the port's
    ``ColModernVBert`` (or ``BiModernVBert``) state dict (in the
    checkpoint's dtypes, on the CPU); layer 0's ``attn_norm`` is synthesized
    as ones, as JAX's loader does (its output is not used)."""
    state = split_fused_wqkv(normalize_keys(load_safetensors_dir(checkpoint_dir), PALIGEMMA_KEY_REMAPS))
    params = convert_state_dict(state, MODERNVBERT_RULES, (), strict=strict)
    norm = params.get("model.text_model.layers.0.mlp_norm.weight")
    if norm is not None:
        params.setdefault(MODERNVBERT_LAYER0_NORM, torch.ones_like(norm))
    return params
