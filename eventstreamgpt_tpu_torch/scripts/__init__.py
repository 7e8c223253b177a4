"""The port's command-line entry points (counterpart: the repository's root ``scripts/``).

Each module runs as ``python -m eventstreamgpt_tpu_torch.scripts.<name>
[--config <yaml>] [--device cpu] [key.sub=value ...]`` and has
``main(argv=None, device=None)``: the YAML file and the overrides are read
by `utils.config_tool` (no PyYAML, no JAX). Without ``--device`` (and with
``device=None``) an entry point runs on the CUDA device and raises without
one; ``--device cpu`` is the caller's request for the CPU, handed down as
``device=``, never a fallback.

* `pretrain`, `finetune`: training (``Preempted`` exits with
  `reliability.EXIT_PREEMPTED`, 85, after the drain's checkpoint);
* `zeroshot`, `get_embeddings`, `generate_trajectories`: from a
  pretraining ``save_dir``;
* `launch_hp_sweep`: random search, TPE and ASHA over `pretrain`;
* `prepare_pretrain_subsets`: run directories and command lists for
  pretraining-subset experiments.
"""

from __future__ import annotations

import sys
from typing import Callable

from ..utils.config_tool import split_config_arg

__all__ = ["exit_on_preemption", "parse_cli"]


def parse_cli(argv: list[str] | None, device=None) -> tuple[str | None, list[str], object]:
    """``(yaml file, overrides, device)`` of an entry point's arguments
    (``sys.argv[1:]`` when ``argv`` is None): ``--config <yaml>`` and
    ``--device <name>`` split off; ``--device`` and a different ``device=``
    together raise ``ValueError``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    yaml_fp, argv = split_config_arg(argv)
    asked, argv = split_config_arg(argv, "--device")
    if asked is not None:
        if device is not None and str(device) != asked:
            raise ValueError(f"--device {asked} and device={device!r} disagree")
        device = asked
    return yaml_fp, argv, device


def exit_on_preemption(main: Callable) -> None:
    """Runs ``main()``; a `reliability.Preempted` (raised after the drain's
    final checkpoint) prints the step and exits with
    `reliability.EXIT_PREEMPTED`, the orchestrator's "reschedule me"."""
    from ..reliability import EXIT_PREEMPTED, Preempted

    try:
        main()
    except Preempted as e:
        print(f"Preempted cleanly at step {e.step}; exiting {EXIT_PREEMPTED} for reschedule.", flush=True)
        sys.exit(EXIT_PREEMPTED)
