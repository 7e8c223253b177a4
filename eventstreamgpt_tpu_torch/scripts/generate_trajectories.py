"""Generates future-trajectory samples of the tuning and held-out cohorts.

Counterpart: the repository's ``scripts/generate_trajectories.py``: a thin
entry point over `evaluation.generate_trajectories` (which writes the
converted cache's ``.npz`` format, not parquet).

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.generate_trajectories load_from_model_dir=./exp/pretrain \\
        task_specific_params.num_samples=4 task_specific_params.max_new_events=32 [--device cpu]
"""

from __future__ import annotations

from ..evaluation import GenerateConfig, generate_trajectories
from ..utils.config_tool import load_config
from . import parse_cli


def main(argv: list[str] | None = None, device=None):
    """Returns the ``generated_trajectories`` directory."""
    yaml_fp, overrides, device = parse_cli(argv, device)
    cfg = load_config(GenerateConfig, yaml_file=yaml_fp, overrides=overrides)
    return generate_trajectories(cfg, device=device)


if __name__ == "__main__":
    main()
