"""The port's import surface against the reference's (a move from one
package to the other is a change of the import).

- Every name that a reference ``__init__`` exports from a module the port
  has, and that module defines, is exported at the same path of the port
  (the same object). Modules not ported yet, and names of ported modules
  that wait (JAX's functional LoRA, the Qwen3.5 processors of
  ``processors.qwen3_vl``), are skipped.
- The ``_target_``s of the eleven training recipes resolve in the port
  (``configs._resolve`` reads ``colpali_tpu.`` as ``colpali_tpu_torch.``), all but
  ``utils.dataset_loading.load_train_set`` (ROADMAP.md Queue 1 item 9);
  ``load_config``, which ``python -m colpali_tpu_torch.train`` calls,
  builds a recipe with the port's classes.
"""

import ast
import importlib
from pathlib import Path

import pytest
import yaml

from colpali_tpu_torch.configs import _resolve, load_config

REPO = Path(__file__).resolve().parents[1]


def _reference_exports():
    """(package, module, name) of every ``from colpali_tpu.<module> import name``
    in the reference's ``__init__`` files."""
    for init in sorted((REPO / "colpali_tpu").rglob("__init__.py")):
        package = ".".join(init.parent.relative_to(REPO).parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("colpali_tpu."):
                for alias in node.names:
                    yield package, node.module, alias.name


def _port_name(dotted):
    return "colpali_tpu_torch" + dotted[len("colpali_tpu"):]


def test_every_ported_name_is_exported_where_the_reference_exports_it():
    exported = 0
    for package, module, name in _reference_exports():
        if not (REPO / Path(*_port_name(module).split("."))).with_suffix(".py").exists():
            continue  # a module not ported yet (ROADMAP.md Queue 1)
        if not hasattr(importlib.import_module(_port_name(module)), name):
            continue  # a name of a ported module that waits (JAX's functional LoRA, the Qwen3.5 processors)
        assert getattr(importlib.import_module(_port_name(package)), name) is \
            getattr(importlib.import_module(_port_name(module)), name), f"{_port_name(package)}.{name}"
        exported += 1
    assert exported >= 118  # compression (7 names) and interpretability (6) since they were ported
    from colpali_tpu_torch import load_retriever as top  # noqa: F401
    from colpali_tpu_torch.models import BiIdefics3, BiPaliProj, ColIdefics3, ColQwen2_5  # noqa: F401
    from colpali_tpu_torch.models import BiGemma3, ColGemma3, Gemma3Backbone, Gemma3Config  # noqa: F401
    from colpali_tpu_torch.processors import BiGemma3Processor, BiGemmaProcessor3, ColGemma3Processor  # noqa: F401
    from colpali_tpu_torch.processors import BiQwen2_5_Processor, ColGemmaProcessor3, ColIdefics3Processor  # noqa: F401
    from colpali_tpu_torch.models import BiQwen3, ColQwen3, Qwen3TextConfig, Qwen3VLBackbone, Qwen3VLConfig  # noqa: F401
    from colpali_tpu_torch.processors import BiQwen3Processor, ColQwen3Processor  # noqa: F401
    from colpali_tpu_torch.models import BiModernVBert, ColModernVBert, ModernVBertConfig  # noqa: F401
    from colpali_tpu_torch.models import ModernBertTextConfig, ModernVBertForMaskedLM, ModernVBertModel  # noqa: F401
    from colpali_tpu_torch.processors import BiModernVBertProcessor, ColModernVBertProcessor  # noqa: F401
    from colpali_tpu_torch.training import ColModelTraining, ColModelTrainingConfig, LoraSpec, TrainConfig  # noqa: F401


def _targets(node):
    if isinstance(node, dict):
        if "_target_" in node:
            yield node["_target_"]
        for value in node.values():
            yield from _targets(value)
    elif isinstance(node, list):
        for value in node:
            yield from _targets(value)


@pytest.mark.parametrize("recipe", ["train_colpali.yaml", "train_colqwen2.yaml", "train_colqwen2_5.yaml",
                                    "train_colidefics3.yaml", "train_bipali.yaml", "train_biidefics3.yaml",
                                    "train_colgemma3.yaml", "train_bigemma3.yaml", "train_colqwen3.yaml",
                                    "train_colmodernvbert.yaml", "train_colqwen3_5.yaml"])
def test_recipe_targets_resolve_in_the_port(recipe):
    targets = sorted(set(_targets(yaml.safe_load((REPO / "configs" / recipe).read_text()))))
    missing = []
    for target in targets:
        try:
            _resolve(target)
        except (ImportError, AttributeError):
            missing.append(target)
    assert missing == ["colpali_tpu.utils.dataset_loading.load_train_set"]  # ROADMAP.md Queue 1 item 9
    assert len(targets) >= 8


def test_load_config_builds_a_jax_recipe_with_the_ports_classes(tmp_path):
    """``train_colidefics3.yaml`` with a tiny model in place of colSmol and
    without the nodes that name absent files: ``colpali_tpu.`` targets are
    read as the port's and JAX's ``scan_layers`` is dropped."""
    from colpali_tpu_torch.losses import ColbertPairwiseCELoss
    from colpali_tpu_torch.models import ColIdefics3
    from colpali_tpu_torch.training import LoraSpec, TrainConfig

    recipe = yaml.safe_load((REPO / "configs" / "train_colidefics3.yaml").read_text())
    node = recipe["config"]
    assert node["model"]["scan_layers"] is True  # the port has no such option
    node["model"].update(config={"_target_": "colpali_tpu_torch.utils.testing.tiny_idefics3_config", "head_dim": 8},
                         device="cpu")
    for key in ("processor", "params", "train_datasets"):
        del node[key]
    (tmp_path / "recipe.yaml").write_text(yaml.safe_dump(recipe))
    config = load_config(str(tmp_path / "recipe.yaml"))
    assert type(config["model"]) is ColIdefics3 and config["model"].model.text_model.remat
    assert type(config["loss_func"]) is ColbertPairwiseCELoss
    assert type(config["peft"]) is LoraSpec and config["peft"].rank == 32
    assert type(config["train"]) is TrainConfig and config["train"].learning_rate == 2e-4
