"""Training CLI of the port: YAML config -> ``ColModelTraining`` -> train
and save (counterpart of ``scripts/train_colbert.py``).

    python -m colpali_tpu_torch.train <config.yaml>

The file's ``config`` mapping holds the fields of
:class:`ColModelTrainingConfig`; nodes with ``_target_`` are instantiated
(see :mod:`colpali_tpu_torch.configs`), so a recipe under ``configs/``
builds the port's classes. The config file is copied into the
output directory. The run happens on the card unless the config says
``device: cpu``.
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Train a ColVision retriever from a YAML config.")
    parser.add_argument("config_file", help="path to the YAML config")
    args = parser.parse_args(argv)

    from colpali_tpu_torch.configs import load_config
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig

    print(f"Loading config: {args.config_file}")
    config = ColModelTrainingConfig(**load_config(args.config_file, sub_path="config"))
    app = ColModelTraining(config)
    os.makedirs(config.output_dir, exist_ok=True)
    shutil.copy(args.config_file, os.path.join(config.output_dir, "training_config.yml"))
    summary = app.train()
    app.save()
    for key, value in summary.items():
        print(f"{key}: {value}")
    return summary


if __name__ == "__main__":
    main()
