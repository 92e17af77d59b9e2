"""One-call checkpoint loading (counterpart of :mod:`colpali_tpu.auto`).

:func:`load_retriever` reads a local HF-format checkpoint directory
(``config.json``, ``*.safetensors``, the tokenizer and
``preprocessor_config.json``), detects the family from ``model_type`` /
``architectures``, builds the port's model from the HF config, loads the
weights through :mod:`colpali_tpu_torch.core.hf_loader` and makes the
processor with the family's ``from_pretrained``::

    model, processor = load_retriever("/ckpts/colpali-v1.2", device="cuda", quantize=True)

The port holds the weights in the module, so it returns ``(model,
processor)`` where JAX returns ``(model, variables, processor)``. The
``colpali``, ``colqwen2``, ``colqwen2_5``, ``colqwen3``, ``colqwen3_5``,
``colidefics3``, ``colgemma3`` and ``colmodernvbert`` families are ported
(their Col models, as in JAX: a Bi model is built from its class); the
other family (``colqwen_omni``) is detected and raises. No hub download is made.
"""

from __future__ import annotations

import importlib
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
# family -> (model class, config class, processor class, loader in core.hf_loader, exporter in core.hf_export,
#            default head dim, processor defaults)
_PORTED: Dict[str, Tuple[str, str, str, str, str, int, Dict[str, Any]]] = {
    "colpali": ("models.paligemma.ColPali", "models.configs.PaliGemmaConfig", "processors.colpali.ColPaliProcessor",
                "load_colpali_params", "export_colpali_state_dict", 128, {}),
    "colqwen2": ("models.qwen2_vl.ColQwen2", "models.qwen2_vl.Qwen2VLConfig", "processors.qwen2_vl.ColQwen2Processor",
                 "load_colqwen2_params", "export_colqwen2_state_dict", 128, {"max_num_visual_tokens": 768}),
    "colqwen2_5": ("models.qwen2_5_vl.ColQwen2_5", "models.qwen2_5_vl.Qwen25VLConfig",
                   "processors.qwen2_5_vl.ColQwen2_5Processor", "load_colqwen25_params",
                   "export_colqwen25_state_dict", 128, {"max_num_visual_tokens": 768}),
    "colqwen3": ("models.qwen3_vl.ColQwen3", "models.qwen3_vl.Qwen3VLConfig", "processors.qwen3_vl.ColQwen3Processor",
                 "load_colqwen3_params", "export_colqwen3_state_dict", 320, {"max_num_visual_tokens": 768}),
    "colqwen3_5": ("models.qwen3_5.ColQwen3_5", "models.qwen3_5.Qwen35VLConfig",
                   "processors.qwen3_vl.ColQwen3_5Processor", "load_colqwen35_params", "export_colqwen35_state_dict",
                   128, {"max_num_visual_tokens": 768}),
    "colidefics3": ("models.idefics3.ColIdefics3", "models.idefics3.Idefics3Config",
                    "processors.idefics3.ColIdefics3Processor", "load_colidefics3_params",
                    "export_colidefics3_state_dict", 128, {}),
    "colgemma3": ("models.gemma3.ColGemma3", "models.gemma3.Gemma3Config", "processors.gemma3.ColGemma3Processor",
                  "load_colgemma3_params", "export_colgemma3_state_dict", 128, {}),
    "colmodernvbert": ("models.modernvbert.ColModernVBert", "models.modernvbert.ModernVBertConfig",
                       "processors.modernvbert.ColModernVBertProcessor", "load_colmodernvbert_params",
                       "export_colmodernvbert_state_dict", 128, {}),
}
# where each family that is not ported yet waits in ROADMAP.md
_NOT_PORTED = {"colqwen_omni": "Queue 1 item 8"}


def _resolve(dotted: str):
    mod, _, attr = f"colpali_tpu_torch.{dotted}".rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def detect_family(hf_config: Dict[str, Any]) -> str:
    """Map a checkpoint's config.json onto a family: its ``model_type``
    first, else the longest matching architecture substring (so
    ``colqwen2`` does not shadow ``colqwen2_5``)."""
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


def exporter_for(config: Any) -> str:
    """The name in :mod:`colpali_tpu_torch.core.hf_export` of the exporter
    of the ported family whose model config ``config`` is, matched on the
    config class's name (so the JAX package's config of that name matches
    too)."""
    name = type(config).__name__
    for _, config_path, _, _, exporter, _, _ in _PORTED.values():
        if config_path.rpartition(".")[2] == name:
            return exporter
    raise ValueError(f"no ported family has the model config {name}; {', '.join(sorted(_PORTED))} are ported")


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
    width (else the config's ``embedding_dim``, else the family's: 320 for
    ColQwen3, 128 for the others). ``strict``: an
    unmatched checkpoint key raises. ``processor_kwargs`` go to
    ``from_pretrained`` over ``device=device`` (pass ``tokenizer=`` where
    ``transformers`` is missing). ``model_kwargs`` go to the model class.
    ``quantize=True`` stores every eligible projection as int8 (weights
    per output channel, ``ops.quant_dense.quantize_params`` with its
    default ``min_dim=512``, JAX's set of layers: 253 of ColPali-3B's):
    served through kernels Q1a and Q1b, about 0.6 of the bf16 weights'
    bytes on the card. SigLIP's patch embedding, the k/v projections under
    512 wide, the embeddings, Gemma3's raw ``mm_input_projection`` and the
    retrieval head (128 or 320 wide) stay in ``dtype`` (ModernVBERT-base:
    205 layers stored). The
    Qwen families' processors default to ``max_num_visual_tokens=768``,
    as in JAX."""
    from colpali_tpu_torch.core import hf_loader
    from colpali_tpu_torch.ops.quant_dense import quantize_params

    hf_cfg = hf_loader.load_hf_config(checkpoint_dir)
    family = family or detect_family(hf_cfg)
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of {sorted(_FAMILIES)}")
    if family in _NOT_PORTED:
        raise NotImplementedError(f"family {family!r} is not ported to colpali_tpu_torch yet "
                                  f"(ROADMAP.md {_NOT_PORTED[family]}); {', '.join(sorted(_PORTED))} are")
    if param_dtype is not None and param_dtype != dtype:
        raise ValueError(f"the port computes in its parameters' dtype: param_dtype={param_dtype} != dtype={dtype}")
    model_path, config_path, proc_path, loader, _, default_dim, proc_defaults = _PORTED[family]
    config = _resolve(config_path).from_hf_config(hf_cfg)
    model = _resolve(model_path)(config, dim=dim or hf_cfg.get("embedding_dim") or default_dim, device=device,
                                 dtype=dtype, **model_kwargs)
    model.load_state_dict(getattr(hf_loader, loader)(checkpoint_dir, strict=strict))
    if quantize:
        quantize_params(model)
    processor = _resolve(proc_path).from_pretrained(
        checkpoint_dir, **{"device": device, **proc_defaults, **(processor_kwargs or {})})
    return model.eval(), processor
