"""The port stands alone: colpali_tpu_torch and chip_smoke.py import
neither ``jax`` nor ``colpali_tpu`` (the GPU machine has neither), and
import no kernel toolchain at import time."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "colpali_tpu", "ml_dtypes", "transformers", "triton"):
    sys.modules[name] = None  # any import of these now raises ImportError
import colpali_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(colpali_tpu_torch.__path__, "colpali_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
tok = chip_smoke.WordTokenizer(image_token_id=100)
batch = tok(["<bos>find page<pad><pad>", "<bos>a"])
assert batch["input_ids"].tolist() == [[2, tok.convert_tokens_to_ids("find"),
                                        tok.convert_tokens_to_ids("page"), 0, 0], [2, tok.convert_tokens_to_ids("a"), 0, 0, 0]]
assert batch["attention_mask"].tolist() == [[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]]
print(len(mods))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 61  # training, the token-major and seq-major ops, checkpoints, the Qwen families
    for module in ("training.orchestrator", "training.lora", "losses.late_interaction", "evaluation.evaluator",
                   "data.collator", "configs", "train", "ops.maxsim_token_major", "ops.flash_seqmajor",
                   "core.safetensors", "core.hf_loader", "core.hf_export", "auto", "ops.quant_dense",
                   "models.qwen2_vl", "models.qwen2_5_vl", "processors.qwen2_vl", "processors.qwen2_5_vl",
                   "compression.token_pooling", "retrieval.hardneg", "interpretability.similarity_maps",
                   "interpretability.split_image", "embed_corpus", "compute_hardnegs", "models.qwen3_5",
                   "ops.gated_delta_rule"):
        assert (REPO / "colpali_tpu_torch" / (module.replace(".", "/") + ".py")).exists()


def test_no_source_mentions_jax_imports():
    sources = [*(REPO / "colpali_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    banned = re.compile(r"(import|from)\s+(jax|jaxlib|flax|optax|orbax|colpali_tpu)(\.|\s|$)")
    for path in sources:
        for line in path.read_text().splitlines():
            assert not banned.match(line.strip()), f"{path}: {line}"


def test_chip_smoke_refuses_without_a_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
