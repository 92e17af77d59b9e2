"""LoRA: low-rank adapters beside a frozen model (counterpart of
:mod:`colpali_tpu.training.lora`).

The JAX package keeps the adapters in a tree of their own and rebuilds
``W_eff = W + (alpha/r) A @ B`` inside the jitted step. Here the adapters
also live apart from the model (:class:`LoraAdapters`, keyed by the JAX
parameter paths), but each adapted ``nn.Linear`` computes the branch form
through a forward hook,

    y = x @ W + (alpha/r) * (x @ (m * A)) @ B,

which is the same function without materialising merged weights or their
gradients. LoRA dropout is the JAX package's: rows of ``A`` are dropped,
``m`` in ``{0, 1/keep}^in``, one mask per adapted layer per step, shared by
all tokens and by the query, document and negative forwards.
:meth:`LoraAdapters.draw_masks` draws them from a generator seeded by
``(seed, step)`` before the forward, so a checkpointed layer's recompute
sees the very same masks. Adapters are fp32; ``a`` is cast to the
activation dtype for its product and the rank-r result goes through ``b``
in fp32.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

# The JAX package's target regex, matched on its parameter paths: attention
# and MLP projections of the language model, and the retrieval head.
DEFAULT_TARGET_PATTERN = (
    r".*(language_model|text_model).*/(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|Wi|Wo)/kernel"
    r"|.*(custom_text_proj|head/linear)/kernel"
)


@dataclasses.dataclass
class LoraSpec:
    """The LoRA recipe (rank, alpha, dropout, gaussian init, targets); attach
    it with ``ColModelTrainingConfig(peft=LoraSpec(...))``."""

    rank: int = 32
    alpha: float = 32.0
    dropout: float = 0.1
    target_pattern: str = DEFAULT_TARGET_PATTERN
    init_stddev: float = 0.01


def jax_kernel_path(module_name: str) -> str:
    """The JAX package's path of an ``nn.Linear``'s kernel:
    ``model.language_model.layers.3.mlp.up_proj`` ->
    ``model/language_model/layers_3/mlp/up_proj/kernel``, and the Qwen vision
    blocks likewise (``model.visual.blocks.0.attn.q_proj`` ->
    ``model/visual/blocks_0/attn/q_proj/kernel``)."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", module_name).replace(".", "/") + "/kernel"


class LoraAdapters(nn.Module):
    """Adapters ``a (in, r)`` (gaussian times ``init_stddev``) and
    ``b (r, out)`` (zeros) for every ``nn.Linear`` of ``model`` whose JAX
    kernel path matches ``spec.target_pattern``, hooked onto those layers.

    The model's own parameters are frozen (``requires_grad_(False)``) and
    its state dict keeps its names; only the adapters train. ``paths`` lists
    the adapted kernels in the model's module order."""

    def __init__(self, model: nn.Module, spec: LoraSpec, seed: int = 0):
        super().__init__()
        self.spec = spec
        self.scale = spec.alpha / spec.rank
        matched = [(jax_kernel_path(name), name, mod) for name, mod in model.named_modules()
                   if isinstance(mod, nn.Linear) and re.fullmatch(spec.target_pattern, jax_kernel_path(name))]
        if not matched:
            raise ValueError(f"LoRA target pattern matched no kernels: {spec.target_pattern}")
        int8 = [path for path, _, mod in matched if mod.weight.dtype == torch.int8]
        if int8:
            raise ValueError(f"LoRA adapts float weights only, as the JAX package does: {int8[0]} (and "
                             f"{len(int8) - 1} more) hold stored int8. Dequantize them first "
                             "(ops.quant_dense.dequantize_params), or quantize only layers the adapters do not "
                             "target (ColModelTrainingConfig(quantize_frozen_base=True) stores the vision tower)")
        for p in model.parameters():
            p.requires_grad_(False)
        self.paths: List[str] = [path for path, _, _ in matched]
        self.module_names: List[str] = [name for _, name, _ in matched]
        gen = torch.Generator().manual_seed(seed)
        self.a, self.b = nn.ParameterList(), nn.ParameterList()
        for _, _, mod in matched:
            dev = mod.weight.device
            a = torch.randn((mod.in_features, spec.rank), generator=gen, dtype=torch.float32) * spec.init_stddev
            self.a.append(nn.Parameter(a.to(dev)))
            self.b.append(nn.Parameter(torch.zeros((spec.rank, mod.out_features), dtype=torch.float32, device=dev)))
        self._masks: Optional[List[torch.Tensor]] = None
        self._handles = [mod.register_forward_hook(self._make_hook(i)) for i, (_, _, mod) in enumerate(matched)]

    def _make_hook(self, i: int):
        def hook(_module, args, out):
            x = args[0]
            a = self.a[i]
            if self._masks is not None:
                a = a * self._masks[i][:, None]
            low = x @ a.to(x.dtype)
            return out + ((low.float() @ self.b[i]) * self.scale).to(out.dtype)

        return hook

    def detach(self) -> None:
        """Remove the hooks: the model computes its base function again."""
        for handle in self._handles:
            handle.remove()
        self._handles = []

    def draw_masks(self, seed: int, step: int) -> None:
        """Draw this step's dropout masks (none when ``dropout`` is 0) from a
        CPU generator seeded by ``(seed, step)``, in one draw and one copy."""
        keep = 1.0 - self.spec.dropout
        if self.spec.dropout <= 0.0:
            self._masks = None
            return
        gen = torch.Generator().manual_seed((seed * 1_000_003 + step) % (2**63))
        sizes = [a.shape[0] for a in self.a]
        flat = (torch.rand(sum(sizes), generator=gen) < keep).float() / keep
        self._masks = list(flat.to(self.a[0].device).split(sizes))

    def set_masks(self, masks: Optional[Mapping[str, torch.Tensor]]) -> None:
        """Use the given ``{path: (in,) mask}`` (values 0 or 1/keep) instead
        of drawing; ``None`` turns dropout off."""
        self._masks = None if masks is None else [
            torch.as_tensor(masks[p], dtype=torch.float32).to(self.a[i].device) for i, p in enumerate(self.paths)]

    def clear_masks(self) -> None:
        self._masks = None

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{path: {"a": ..., "b": ...}}``, the JAX package's adapter tree."""
        return {p: {"a": self.a[i].detach(), "b": self.b[i].detach()} for i, p in enumerate(self.paths)}

    @torch.no_grad()
    def load_tree(self, tree: Mapping[str, Mapping[str, Any]]) -> None:
        """Take adapter values from a ``{path: {"a", "b"}}`` tree with
        exactly these paths and shapes."""
        if set(tree) != set(self.paths):
            raise ValueError(f"adapter paths differ: {sorted(set(tree) ^ set(self.paths))[:4]} ...")
        for i, p in enumerate(self.paths):
            for name, param in (("a", self.a[i]), ("b", self.b[i])):
                value = torch.as_tensor(tree[p][name], dtype=torch.float32)
                if value.shape != param.shape:
                    raise ValueError(f"{p}/{name}: {tuple(value.shape)} != {tuple(param.shape)}")
                param.copy_(value)

    @torch.no_grad()
    def merged_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's state dict with ``W + (alpha/r) A @ B`` in place of
        every adapted weight (the delta is cast to the weight's dtype, then
        added): a checkpoint that serves without adapters."""
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        for i, name in enumerate(self.module_names):
            weight = state[f"{name}.weight"]  # (out, in)
            delta = (self.a[i] @ self.b[i]).T * self.scale
            state[f"{name}.weight"] = weight + delta.to(weight.dtype)
        return state
