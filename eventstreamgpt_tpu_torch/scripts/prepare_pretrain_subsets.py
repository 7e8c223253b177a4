"""Prepares run directories and command lists for pretraining-subset experiments.

Counterpart: the repository's ``scripts/prepare_pretrain_subsets.py``: given
an initial pretraining run directory (holding the ``pretrain_config.yaml``
that `scripts.pretrain` writes), it writes one run directory per subset size
and seed with its ``pretrain_config_source.yaml`` (`utils.yaml_subset`) and
shell command lists of the port's entry points: pretraining, few-shot
fine-tuning, zero-shot evaluation and embeddings.

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.prepare_pretrain_subsets \
        initial_model_path=./exp/pretrain subset_sizes='[100, 1000]' experiment_name=subset_experiments seeds=2
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from pathlib import Path

from ..utils import yaml_subset
from ..utils.config_tool import (
    CONFIGS_DIR,
    deep_merge,
    load_yaml_with_defaults,
    parse_overrides,
    resolve_interpolations,
)
from . import parse_cli

COMMAND = "python -m eventstreamgpt_tpu_torch.scripts"


def main(argv: list[str] | None = None, device=None):
    """Returns ``{command list name: [commands]}``; a ``--device`` (or
    ``device=``) is passed on to every command."""
    yaml_fp, argv, device = parse_cli(argv, device)
    if yaml_fp is None:
        yaml_fp = CONFIGS_DIR / "pretrain_subsets_base.yaml"

    cfg = load_yaml_with_defaults(yaml_fp)
    deep_merge(cfg, parse_overrides(argv))
    cfg = resolve_interpolations(cfg)

    initial_model_path = Path(cfg["initial_model_path"])
    initial_config_path = initial_model_path / "pretrain_config.yaml"
    if not initial_config_path.is_file():
        raise FileNotFoundError(f"{initial_config_path} does not exist!")

    subset_sizes = cfg["subset_sizes"]
    if not isinstance(subset_sizes, list):
        raise TypeError(f"subset_sizes must be a list, got {subset_sizes}!")

    seeds = cfg["seeds"]
    if isinstance(seeds, int):
        seeds = [seeds for _ in subset_sizes]
    elif isinstance(seeds, list) and len(seeds) == len(subset_sizes):
        pass
    elif isinstance(seeds, dict) and all(s in seeds for s in subset_sizes):
        seeds = [seeds[s] for s in subset_sizes]
    else:
        raise TypeError(
            f"seeds must be an int or a list/dict matching {subset_sizes}, got {seeds}!"
        )

    initial_config = yaml_subset.load_file(initial_config_path)

    experiment_dir = cfg.get("experiment_dir") or initial_config.get("experiment_dir")
    experiment_dir = Path(experiment_dir)
    runs_dir = experiment_dir / cfg["experiment_name"]
    runs_dir.mkdir(parents=True, exist_ok=True)

    ft_tasks = (cfg.get("few_shot_commands") or {}).get("fine_tuning_task_names", [])
    zs_tasks = (cfg.get("zero_shot_commands") or {}).get("fine_tuning_task_names", [])
    emb_tasks = (cfg.get("get_embeddings_commands") or {}).get("fine_tuning_task_names", [])

    commands = defaultdict(list)
    for n_seeds, subset_size in zip(seeds, subset_sizes):
        for seed in range(n_seeds):
            seed_runs_dir = runs_dir / f"subset_{subset_size}" / f"seed_{seed}"
            seed_runs_dir.mkdir(parents=True, exist_ok=True)

            if cfg.get("do_include_PT_commands", True):
                new_config = copy.deepcopy(initial_config)
                new_config["experiment_dir"] = str(experiment_dir)
                new_config.setdefault("data_config", {})["train_subset_size"] = subset_size
                new_config["data_config"]["train_subset_seed"] = seed
                new_config["save_dir"] = str(seed_runs_dir)

                new_config_path = seed_runs_dir / "pretrain_config_source.yaml"
                yaml_subset.dump_file(new_config, new_config_path)

                commands["pretrain"].append(
                    f"{COMMAND}.pretrain --config {new_config_path}"
                )

            for task in ft_tasks:
                for ft_subset in (cfg["few_shot_commands"].get("fine_tuning_subset_sizes") or ["FULL"]):
                    commands["finetune"].append(
                        f"{COMMAND}.finetune load_from_model_dir={seed_runs_dir} "
                        f"task_df_name={task} "
                        f"data_config_overrides.train_subset_size={ft_subset}"
                    )
            for task in zs_tasks:
                num_samples = (cfg["zero_shot_commands"] or {}).get("num_samples", 10)
                commands["zeroshot"].append(
                    f"{COMMAND}.zeroshot load_from_model_dir={seed_runs_dir} "
                    f"task_df_name={task} task_specific_params.num_samples={num_samples}"
                )
            for task in emb_tasks:
                commands["get_embeddings"].append(
                    f"{COMMAND}.get_embeddings load_from_model_dir={seed_runs_dir} "
                    f"task_df_name={task}"
                )

    if device is not None:
        commands = {name: [f"{c} --device {device}" for c in cmds] for name, cmds in commands.items()}
    for name, cmds in commands.items():
        fp = runs_dir / f"{name}_commands.sh"
        fp.write_text("\n".join(cmds) + "\n")
        print(f"Wrote {len(cmds)} {name} commands to {fp}")

    (runs_dir / "subset_manifest.json").write_text(
        json.dumps({"subset_sizes": subset_sizes, "seeds": seeds}, indent=2)
    )
    return dict(commands)


if __name__ == "__main__":
    main()
