"""Pretrains a generative event-stream transformer.

Counterpart: the repository's ``scripts/pretrain.py``: a thin entry point
over `training.pretrain.train` with hydra-style ``key.sub=value``
overrides (`utils.config_tool`); ``--config <yaml>`` supplies base values.
The resolved config is written to ``save_dir/pretrain_config.yaml`` first
(`utils.yaml_subset.dump`).

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.pretrain --config configs/pretrain_base.yaml \\
        data_config.save_dir=sample_data/converted/sample optimization_config.batch_size=32 \\
        save_dir=./exp/pretrain [--device cpu]
"""

from __future__ import annotations

import json
from pathlib import Path

from ..training.pretrain import PretrainConfig, train
from ..utils import yaml_subset
from ..utils.config_tool import load_config, unstructure
from . import exit_on_preemption, parse_cli


def resolved_config(cfg: PretrainConfig) -> dict:
    """The config as ``pretrain_config.yaml`` holds it: plain values, paths
    and enums as strings (a JSON round trip, as JAX's script does)."""
    return json.loads(json.dumps(unstructure(cfg), default=str))


def main(argv: list[str] | None = None, device=None):
    """Returns `training.pretrain.train`'s ``(tuning_loss, tuning_metrics, held_out_metrics)``."""
    yaml_fp, overrides, device = parse_cli(argv, device)
    cfg = load_config(PretrainConfig, yaml_file=yaml_fp, overrides=overrides)
    save_dir = Path(cfg.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    yaml_subset.dump_file(resolved_config(cfg), save_dir / "pretrain_config.yaml")
    return train(cfg, device=device)


if __name__ == "__main__":
    exit_on_preemption(main)
