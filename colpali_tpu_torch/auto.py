"""One-call checkpoint loading (counterpart of :mod:`colpali_tpu.auto`).

:func:`load_retriever` reads a local HF-format checkpoint directory
(``config.json``, ``*.safetensors``, the tokenizer and
``preprocessor_config.json``), detects the family from ``model_type`` /
``architectures``, builds the port's model from the HF config, loads the
weights through :mod:`colpali_tpu_torch.core.hf_loader` and makes the
processor with the family's ``from_pretrained``::

    model, processor = load_retriever("/ckpts/colpali-v1.2", device="cuda", quantize=True)

The port holds the weights in the module, so it returns ``(model,
processor)`` where JAX returns ``(model, variables, processor)``. Only the
``colpali`` family is ported; the other families are detected and raise.
No hub download is made.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

# family -> (matching config.json model_type values, matching architecture substrings), as in JAX
_FAMILIES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "colpali": (("paligemma",), ("colpali", "paligemma")),
    "colqwen2": (("qwen2_vl",), ("colqwen2", "qwen2vl")),
    "colqwen2_5": (("qwen2_5_vl",), ("colqwen2_5", "qwen2_5vl")),
    "colqwen3": (("qwen3_vl", "qwen3_vl_moe"), ("colqwen3",)),
    "colqwen3_5": (("qwen3_5", "qwen3_5_vl"), ("colqwen3_5",)),
    "colqwen_omni": (("qwen2_5_omni", "qwen2_5_omni_thinker"), ("colqwen2_5omni", "omni")),
    "colgemma3": (("gemma3",), ("colgemma",)),
    "colidefics3": (("idefics3",), ("colidefics3", "colsmol")),
    "colmodernvbert": (("modernvbert",), ("modernvbert",)),
}
# where each family that is not ported yet waits in ROADMAP.md
_NOT_PORTED = {
    "colqwen2": "Queue 1 item 6",
    "colqwen2_5": "Queue 1 item 6",
    **{f: "Queue 1 item 8" for f in ("colidefics3", "colgemma3", "colqwen3", "colmodernvbert", "colqwen3_5",
                                     "colqwen_omni")},
}


def detect_family(hf_config: Dict[str, Any]) -> str:
    """Map a checkpoint's config.json onto a family: its ``model_type``
    first, else the longest matching architecture substring."""
    model_type = str(hf_config.get("model_type", "")).lower()
    archs = " ".join(hf_config.get("architectures", []) or []).lower()
    for family, (types, _) in _FAMILIES.items():
        if model_type in types:
            return family
    best = max(((family, s) for family, (_, subs) in _FAMILIES.items() for s in subs if s in archs),
               key=lambda fs: len(fs[1]), default=None)
    if best is not None:
        return best[0]
    raise ValueError(f"cannot detect a family from model_type={model_type!r} architectures={archs!r}; "
                     f"pass family= explicitly (one of {sorted(_FAMILIES)})")


def load_retriever(
    checkpoint_dir: str,
    family: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    param_dtype: Optional[torch.dtype] = None,
    dim: Optional[int] = None,
    strict: bool = True,
    processor_kwargs: Optional[Dict[str, Any]] = None,
    quantize: bool = False,
    device: Any = "cuda",
    **model_kwargs,
):
    """Load ``(model, processor)`` from a local HF-format checkpoint.

    ``dtype`` is the model's parameter and compute type (the port has one
    type for both: ``param_dtype`` may only repeat it). ``dim``: the head's
    width (else the config's ``embedding_dim``, else 128). ``strict``: an
    unmatched checkpoint key raises. ``processor_kwargs`` go to
    ``from_pretrained`` over ``device=device`` (pass ``tokenizer=`` where
    ``transformers`` is missing). ``model_kwargs`` go to the model class.
    ``quantize=True`` stores every eligible projection as int8 (weights
    per output channel, ``ops.quant_dense.quantize_params`` with its
    default ``min_dim=512``; 253 of ColPali-3B's): served through kernels
    Q1a and Q1b, about 0.6 of the bf16 weights' bytes on the card. The
    patch embedding, Gemma's k/v, the embeddings and the 128-d head stay
    in ``dtype``."""
    from colpali_tpu_torch.core.hf_loader import load_colpali_params, load_hf_config
    from colpali_tpu_torch.models.configs import PaliGemmaConfig
    from colpali_tpu_torch.models.paligemma import ColPali
    from colpali_tpu_torch.ops.quant_dense import quantize_params
    from colpali_tpu_torch.processors.colpali import ColPaliProcessor

    hf_cfg = load_hf_config(checkpoint_dir)
    family = family or detect_family(hf_cfg)
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of {sorted(_FAMILIES)}")
    if family in _NOT_PORTED:
        raise NotImplementedError(f"family {family!r} is not ported to colpali_tpu_torch yet "
                                  f"(ROADMAP.md {_NOT_PORTED[family]}); 'colpali' is")
    if param_dtype is not None and param_dtype != dtype:
        raise ValueError(f"the port computes in its parameters' dtype: param_dtype={param_dtype} != dtype={dtype}")
    config = PaliGemmaConfig.from_hf_config(hf_cfg)
    model = ColPali(config, dim=dim or hf_cfg.get("embedding_dim") or 128, device=device, dtype=dtype,
                    **model_kwargs)
    model.load_state_dict(load_colpali_params(checkpoint_dir, strict=strict))
    if quantize:
        quantize_params(model)
    processor = ColPaliProcessor.from_pretrained(checkpoint_dir, **{"device": device, **(processor_kwargs or {})})
    return model.eval(), processor
