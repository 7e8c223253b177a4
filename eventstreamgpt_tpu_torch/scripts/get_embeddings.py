"""Extracts pooled per-subject embeddings from a pretrained model.

Counterpart: the repository's ``scripts/get_embeddings.py``: a thin entry
point over `training.embedding.get_embeddings`.

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.get_embeddings load_from_model_dir=./exp/pretrain \\
        task_df_name=high_utilization [--device cpu]
"""

from __future__ import annotations

from ..training.embedding import get_embeddings
from ..training.fine_tuning import FinetuneConfig
from ..utils.config_tool import load_config
from . import parse_cli


def main(argv: list[str] | None = None, device=None):
    """Returns ``{split: the written .npy file}``."""
    yaml_fp, overrides, device = parse_cli(argv, device)
    cfg = load_config(FinetuneConfig, yaml_file=yaml_fp, overrides=overrides)
    return get_embeddings(cfg, device=device)


if __name__ == "__main__":
    main()
