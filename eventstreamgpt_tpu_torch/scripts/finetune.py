"""Fine-tunes a pretrained model on a stream classification task.

Counterpart: the repository's ``scripts/finetune.py``: a thin entry point
over `training.fine_tuning.train`.

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.finetune load_from_model_dir=./exp/pretrain \\
        task_df_name=high_utilization optimization_config.batch_size=32 [--device cpu]
"""

from __future__ import annotations

from ..training.fine_tuning import FinetuneConfig, train
from ..utils.config_tool import load_config
from . import exit_on_preemption, parse_cli


def main(argv: list[str] | None = None, device=None):
    """Returns `training.fine_tuning.train`'s ``(tuning_loss, tuning_metrics, held_out_metrics)``."""
    yaml_fp, overrides, device = parse_cli(argv, device)
    cfg = load_config(FinetuneConfig, yaml_file=yaml_fp, overrides=overrides)
    return train(cfg, device=device)


if __name__ == "__main__":
    exit_on_preemption(main)
