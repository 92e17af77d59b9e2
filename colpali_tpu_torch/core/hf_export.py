"""The port's ColPali state dict -> the HF torch layout (counterpart of
:mod:`colpali_tpu.core.hf_export`): the inverse of
:mod:`colpali_tpu_torch.core.hf_loader`, made from the same rule table.

Each port name is matched against a rule's template (``{i}``, ``{j}`` as
capture groups); the rule's torch-key regex is rendered into a concrete key
with those groups (optional non-capturing groups dropped: the canonical HF
layout omits them) and checked by matching the regex again, so the export
cannot drift from the loader; the transform is inverted (the im2col patch
weight folds back into ``(O, C, p, p)``). The keys are the ones the JAX
package's exporter writes for the same parameters.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from colpali_tpu_torch.core.hf_loader import PALIGEMMA_RULES, _RuleT, t_conv2d, t_id


def _inv_conv2d(w: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """``(O, p * p * C)`` in ``(kh, kw, c)`` order -> torch Conv2d ``(O, C, p, p)``."""
    p = int(round((w.shape[1] // channels) ** 0.5))
    if p * p * channels != w.shape[1]:
        raise ValueError(f"patch weight {tuple(w.shape)} is not (O, p * p * {channels})")
    return w.reshape(w.shape[0], p, p, channels).permute(0, 3, 1, 2).contiguous()


_INVERSES: Dict[Callable, Callable[[torch.Tensor], torch.Tensor]] = {t_id: lambda w: w, t_conv2d: _inv_conv2d}


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
    state_dict: Mapping[str, torch.Tensor], rules: Tuple[_RuleT, ...], strict: bool = True
) -> Dict[str, torch.Tensor]:
    """Translate a port state dict into HF torch-layout keys (tensors on the
    CPU, dtypes kept) by the loader's rules, inverted; with ``strict`` a
    parameter that no rule covers raises."""
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
            out[key] = _INVERSES[transform](value.detach().cpu())
            break
        else:
            unmatched.append(name)
    if unmatched and strict:
        raise ValueError(f"Unexported parameters ({len(unmatched)}): {unmatched[:10]} ...")
    return out


def export_colpali_state_dict(state_dict: Mapping[str, torch.Tensor], strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's ``ColPali`` state dict -> HF torch-layout state dict."""
    return export_state_dict(state_dict, PALIGEMMA_RULES, strict=strict)
