"""The port's state dicts -> the HF torch layout (counterpart of
:mod:`colpali_tpu.core.hf_export`): the inverse of
:mod:`colpali_tpu_torch.core.hf_loader`, made from the same rule tables.

Each port name is matched against a rule's template (``{i}``, ``{j}`` as
capture groups); the rule's torch-key regex is rendered into a concrete key
with those groups (optional non-capturing groups dropped: the canonical HF
layout omits them) and checked by matching the regex again, so the export
cannot drift from the loader; the transform is inverted (the im2col patch
weight folds back into ``(O, C, p, p)``, Qwen's patch weight into ``(O, C,
T, p, p)`` with the geometry passed as ``ctx``). The Qwen exporters then
fuse the vision q/k/v back into ``attn.qkv`` and nest the keys under
``model.`` as modern transformers does; the ModernVBert exporter fuses the
text q/k/v into ``attn.Wqkv``. The keys are the ones the JAX
package's exporter writes for the same parameters.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from colpali_tpu_torch.core.hf_loader import (
    GEMMA3_RULES,
    IDEFICS3_RULES,
    MODERNVBERT_LAYER0_NORM,
    MODERNVBERT_RULES,
    PALIGEMMA_RULES,
    QWEN2_VL_RULES,
    QWEN25_VL_RULES,
    QWEN3_VL_RULES,
    QWEN35_RULES,
    _RuleT,
    t_conv1d_depthwise,
    t_conv2d,
    t_conv3d_patch,
    t_id,
)


def _inv_conv2d(w: torch.Tensor, ctx: Mapping[str, Any], channels: int = 3) -> torch.Tensor:
    """``(O, p * p * C)`` in ``(kh, kw, c)`` order -> torch Conv2d ``(O, C, p, p)``."""
    p = int(round((w.shape[1] // channels) ** 0.5))
    if p * p * channels != w.shape[1]:
        raise ValueError(f"patch weight {tuple(w.shape)} is not (O, p * p * {channels})")
    return w.reshape(w.shape[0], p, p, channels).permute(0, 3, 1, 2).contiguous()


def _inv_conv3d_patch(w: torch.Tensor, ctx: Mapping[str, Any]) -> torch.Tensor:
    """``(O, C * T * pH * pW)`` -> torch Conv3d ``(O, C, T, pH, pW)``; the
    geometry comes in ``ctx["conv3d_patch_shape"]``."""
    c, t, ph, pw = ctx["conv3d_patch_shape"]
    return w.reshape(w.shape[0], c, t, ph, pw).contiguous()


_INVERSES: Dict[Callable, Callable[[torch.Tensor, Mapping[str, Any]], torch.Tensor]] = {
    t_id: lambda w, ctx: w, t_conv2d: _inv_conv2d, t_conv3d_patch: _inv_conv3d_patch,
    t_conv1d_depthwise: lambda w, ctx: w.T[:, None, :].contiguous()}  # (K, C) -> torch Conv1d (C, 1, K)


def _matching_paren(s: str, start: int) -> int:
    depth = 0
    i = start
    while i < len(s):
        if s[i] == "\\":
            i += 2
            continue
        if s[i] == "(":
            depth += 1
        elif s[i] == ")":
            depth -= 1
            if depth == 0:
                return i
        i += 1
    raise ValueError(f"Unbalanced parens in {s!r}")


def render_torch_key(pattern: str, groups: Sequence[str]) -> Optional[str]:
    """Render a rule's torch-key regex into a concrete key, substituting the
    capture groups in order and dropping optional non-capturing groups;
    None when the pattern holds constructs that cannot be rendered."""
    out = []
    gi = 0
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            out.append(pattern[i + 1])
            i += 2
        elif c == "(":
            j = _matching_paren(pattern, i)
            body = pattern[i + 1 : j]
            optional = j + 1 < n and pattern[j + 1] == "?"
            if body.startswith("?:"):
                if not optional:
                    inner = render_torch_key(body[2:], [])
                    if inner is None:
                        return None
                    out.append(inner)
                i = j + (2 if optional else 1)
            else:
                if gi >= len(groups):
                    return None
                out.append(str(groups[gi]))
                gi += 1
                i = j + 1
        elif c in ".*+?[]|^$":
            return None  # an unescaped metacharacter: not renderable
        else:
            out.append(c)
            i += 1
    if gi != len(groups):
        return None
    return "".join(out)


def _template_regex(template: str) -> re.Pattern:
    esc = re.escape(template)
    esc = esc.replace(re.escape("{i}"), r"(\d+)")
    esc = esc.replace(re.escape("{j}"), r"([A-Za-z0-9_]+)")
    return re.compile(esc)


def export_state_dict(
    state_dict: Mapping[str, torch.Tensor], rules: Tuple[_RuleT, ...], strict: bool = True,
    ctx: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Translate a port state dict into HF torch-layout keys (tensors on the
    CPU, dtypes kept) by the loader's rules, inverted; with ``strict`` a
    parameter that no rule covers raises. ``ctx``: what an inverse needs
    beside the tensor (the Conv3d patch geometry)."""
    quantized = [name for name, value in state_dict.items()
                 if name.endswith(".weight_scale") or value.dtype == torch.int8]
    if quantized:
        raise ValueError(f"{len(quantized)} stored-int8 tensors ({quantized[0]}, ...): the HF layout holds float "
                         "weights; call ops.quant_dense.dequantize_params(model) and export its state dict")
    inv_rules = [(_template_regex(template), pattern, transform) for pattern, template, transform in rules if template]
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for name, value in state_dict.items():
        for treg, pattern, transform in inv_rules:
            m = treg.fullmatch(name)
            if m is None:
                continue
            key = render_torch_key(pattern, m.groups())
            if key is None or re.fullmatch(pattern, key) is None:
                continue  # the template matched but the torch side disagrees: next rule
            out[key] = _INVERSES[transform](value.detach().cpu(), ctx or {})
            break
        else:
            unmatched.append(name)
    if unmatched and strict:
        raise ValueError(f"Unexported parameters ({len(unmatched)}): {unmatched[:10]} ...")
    return out


def export_colpali_state_dict(state_dict: Mapping[str, torch.Tensor], strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColPali`` state dict -> HF torch-layout state dict."""
    return export_state_dict(state_dict, PALIGEMMA_RULES, strict=strict)


def fuse_qkv(state: Dict[str, torch.Tensor], scope: str = r"visual\.blocks\.\d+\.attn",
             fused_name: str = "qkv") -> Dict[str, torch.Tensor]:
    """Fuse split ``{q,k,v}_proj`` under ``scope`` back into HF's fused
    projection ``fused_name`` (the inverse of ``hf_loader.split_fused_qkv``,
    and with ``"Wqkv"`` of ``split_fused_wqkv``)."""
    pat = re.compile(rf"({scope})\.q_proj\.(weight|bias)")
    out = dict(state)
    for key in list(out):
        m = pat.fullmatch(key)
        if m is None:
            continue
        base, kind = m.group(1), m.group(2)
        out[f"{base}.{fused_name}.{kind}"] = torch.cat([out.pop(f"{base}.{p}_proj.{kind}") for p in "qkv"], dim=0)
    return out


def dress_keys_modern(state: Dict[str, torch.Tensor], scopes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """Prefix the loader's canonical keys of ``scopes`` with ``model.``, the
    nesting modern transformers reports for Qwen2-VL (``model.visual.*``,
    ``model.language_model.*``); the loader's remaps strip it again."""
    pat = re.compile(rf"^({'|'.join(map(re.escape, scopes))})\.")
    return {pat.sub(r"model.\1.", k): v for k, v in state.items()}


def _conv3d_ctx(channels: int, temporal_patch_size: int, patch_size: int) -> Dict[str, Any]:
    return {"conv3d_patch_shape": (channels, temporal_patch_size, patch_size, patch_size)}


def _export_qwen(state_dict, rules, channels, temporal_patch_size, patch_size, strict) -> Dict[str, torch.Tensor]:
    state = export_state_dict(state_dict, rules, strict=strict,
                              ctx=_conv3d_ctx(channels, temporal_patch_size, patch_size))
    return dress_keys_modern(fuse_qkv(state), ("visual", "language_model"))


def export_colqwen2_state_dict(state_dict: Mapping[str, torch.Tensor], channels: int = 3, temporal_patch_size: int = 2,
                               patch_size: int = 14, strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColQwen2`` state dict -> HF torch-layout state dict (the
    vision qkv fused, the patch weight folded to ``(O, C, T, p, p)``)."""
    return _export_qwen(state_dict, QWEN2_VL_RULES, channels, temporal_patch_size, patch_size, strict)


def export_colqwen25_state_dict(state_dict: Mapping[str, torch.Tensor], channels: int = 3,
                                temporal_patch_size: int = 2, patch_size: int = 14,
                                strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColQwen2_5`` state dict -> HF torch-layout state dict."""
    return _export_qwen(state_dict, QWEN25_VL_RULES, channels, temporal_patch_size, patch_size, strict)


def export_colqwen3_state_dict(state_dict: Mapping[str, torch.Tensor], channels: int = 3, temporal_patch_size: int = 2,
                               patch_size: int = 16, strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColQwen3`` (or ``BiQwen3``) state dict -> HF
    torch-layout state dict (the vision qkv fused, as HF Qwen3-VL ships it;
    the deepstack mergers as ``deepstack_merger_list.{k}``)."""
    return _export_qwen(state_dict, QWEN3_VL_RULES, channels, temporal_patch_size, patch_size, strict)


def unstack_expert_weights(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of ``hf_loader.stack_expert_weights`` on an exported state
    dict: a stacked ``...mlp.experts.{gate,up,down}_proj`` ``(E, d_in,
    d_out)`` becomes E per-expert ``...mlp.experts.{e}.*_proj.weight``
    ``(d_out, d_in)``."""
    pat = re.compile(r"(language_model\.layers\.\d+\.mlp\.experts)\.(gate|up|down)_proj")
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        m = pat.fullmatch(key)
        if m is None:
            out[key] = value
            continue
        for e in range(value.shape[0]):
            out[f"{m.group(1)}.{e}.{m.group(2)}_proj.weight"] = value[e].T.contiguous()
    return out


def export_colqwen35_state_dict(state_dict: Mapping[str, torch.Tensor], channels: int = 3,
                                temporal_patch_size: int = 2, patch_size: int = 16,
                                strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColQwen3_5`` (or ``BiQwen3_5``) state dict -> HF
    torch-layout state dict: the conv kernels back to ``(C, 1, K)``, the
    stacked experts split per expert, the vision qkv fused."""
    state = export_state_dict(state_dict, QWEN35_RULES, strict=strict,
                              ctx=_conv3d_ctx(channels, temporal_patch_size, patch_size))
    return dress_keys_modern(fuse_qkv(unstack_expert_weights(state)), ("visual", "language_model"))


def export_colidefics3_state_dict(state_dict: Mapping[str, torch.Tensor],
                                  strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColIdefics3`` state dict -> HF torch-layout state dict,
    the vision model, connector and text model nested under ``model.``."""
    state = export_state_dict(state_dict, IDEFICS3_RULES, strict=strict)
    return dress_keys_modern(state, ("vision_model", "text_model", "connector"))


def export_colgemma3_state_dict(state_dict: Mapping[str, torch.Tensor],
                                strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColGemma3`` (or ``BiGemma3``) state dict -> HF
    torch-layout state dict, the vision tower, projector and text model
    nested under ``model.``."""
    state = export_state_dict(state_dict, GEMMA3_RULES, strict=strict)
    return dress_keys_modern(state, ("vision_tower", "multi_modal_projector", "language_model"))


def export_colmodernvbert_state_dict(state_dict: Mapping[str, torch.Tensor],
                                     strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColModernVBert`` (or ``BiModernVBert``) state dict -> HF
    torch-layout state dict: layer 0's ``attn_norm`` (the identity in HF)
    dropped, the text q/k/v fused into ``attn.Wqkv``."""
    state = export_state_dict({k: v for k, v in state_dict.items() if k != MODERNVBERT_LAYER0_NORM},
                              MODERNVBERT_RULES, strict=strict)
    return fuse_qkv(state, scope=r"model\.text_model\.layers\.\d+\.attn", fused_name="Wqkv")


def export_for_config(state_dict: Mapping[str, torch.Tensor], config: Any = None) -> Dict[str, torch.Tensor]:
    """Export ``state_dict`` with the exporter that
    :func:`colpali_tpu_torch.auto.exporter_for` names for ``config``'s
    family (``None``: ColPali). The Qwen families take the patch geometry
    from ``config.vision``."""
    from colpali_tpu_torch.auto import exporter_for

    if config is None:
        return export_colpali_state_dict(state_dict)
    export = globals()[exporter_for(config)]
    if export in (export_colpali_state_dict, export_colidefics3_state_dict, export_colgemma3_state_dict,
                  export_colmodernvbert_state_dict):
        return export(state_dict)
    v = config.vision
    return export(state_dict, channels=v.in_channels, temporal_patch_size=v.temporal_patch_size,
                  patch_size=v.patch_size)
