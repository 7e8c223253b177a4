"""Zero-shot evaluation through generation with the task's labeler.

Counterpart: the repository's ``scripts/zeroshot.py``: a thin entry point
over `training.zero_shot_evaluator.zero_shot_evaluation`.

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.zeroshot load_from_model_dir=./exp/pretrain \\
        task_df_name=high_utilization task_specific_params.num_samples=8 [--device cpu]
"""

from __future__ import annotations

from ..training.fine_tuning import FinetuneConfig
from ..training.zero_shot_evaluator import zero_shot_evaluation
from ..utils.config_tool import load_config
from . import parse_cli


def main(argv: list[str] | None = None, device=None):
    """Returns ``(tuning_metrics, held_out_metrics)``."""
    yaml_fp, overrides, device = parse_cli(argv, device)
    cfg = load_config(FinetuneConfig, yaml_file=yaml_fp, overrides=overrides)
    return zero_shot_evaluation(cfg, device=device)


if __name__ == "__main__":
    main()
