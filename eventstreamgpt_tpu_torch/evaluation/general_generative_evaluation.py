"""Trajectory generation at scale: generated continuations of the tuning and held-out cohorts.

Counterpart: ``eventstreamgpt_tpu/evaluation/general_generative_evaluation.py``.
`GenerateConfig` has JAX's fields and resolves them as JAX does from a
pretraining ``save_dir`` (its ``data_config.json`` and ``config.json``, left
padding and the start-time, subsequence and subject-id columns by default).
`generate_trajectories` generates ``num_samples`` continuations a subject of
both splits with cohort `generate()`, splits the expanded batch back into
per-sample batches, drops fill rows, converts each to the sparse DL format
(`data.types.EventStreamBatch.convert_to_DL`) and writes
``generated_trajectories/{split}/sample_{i}_local_rank_0.npz`` in the
converted cache's format (`data.dl_cache.write_dl_reps`; read back with
`data.dl_cache.read_dl_reps`, exported to JAX's parquet frame with
`data.dl_cache.dl_reps_to_parquet` where pyarrow is installed). Neither
pandas nor pyarrow is imported.

Randomness: batch ``b`` (counted over both splits, as JAX splits its key
batch after batch) generates from the seed ``derive_request_seed(cfg.seed,
b)``, the port's explicit streams; JAX's threefry keys give other draws.
One card and no mesh: JAX's data-parallel mesh over the expanded batch
waits for ROADMAP Queue 1 item 7 (``mesh=`` raises).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..data.config import PytorchDatasetConfig
from ..data.dl_cache import concat_dl_reps, write_dl_reps
from ..data.torch_dataset import TorchDataset
from ..generation import generate
from ..generation.sampling import derive_request_seed
from ..models.config import OptimizationConfig, Split, StructuredTransformerConfig
from ..training.checkpoint import load_pretrained
from ..training.pretrain import build_model
from ..utils import config_dataclass
from ..utils.config_tool import coerce_to_signature
from ..utils.device import resolve_device

__all__ = ["GenerateConfig", "generate_trajectories"]


@config_dataclass
class GenerateConfig:
    """The configuration of a trajectory-generation run (JAX's ``GenerateConfig``)."""

    load_from_model_dir: str | Path | None = None
    seed: int = 1

    pretrained_weights_fp: str | Path | None = None
    save_dir: str | Path | None = None

    do_overwrite: bool = False

    optimization_config: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)

    task_df_name: str | None = None

    data_config_overrides: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {
            "seq_padding_side": "left",
            "do_include_start_time_min": True,
            "do_include_subsequence_indices": True,
            "do_include_subject_id": True,
        }
    )

    task_specific_params: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"num_samples": None, "max_new_events": None}
    )

    config_overrides: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.optimization_config, dict):
            self.optimization_config = OptimizationConfig.from_dict(self.optimization_config)
        if isinstance(self.save_dir, str):
            self.save_dir = Path(self.save_dir)

        if self.load_from_model_dir is None:
            self.data_config = None
            self.config = None
            return

        self.load_from_model_dir = Path(self.load_from_model_dir)

        if self.pretrained_weights_fp is None:
            self.pretrained_weights_fp = self.load_from_model_dir
        if self.save_dir is None:
            if self.task_df_name is not None:
                self.save_dir = self.load_from_model_dir / "finetuning" / self.task_df_name
            else:
                self.save_dir = self.load_from_model_dir

        def apply_overrides(cfg, overrides: dict, label: str):
            for param, val in (overrides or {}).items():
                if param == "task_df_name":
                    # The task df is pinned by the top-level field; an
                    # override here would silently fork the two.
                    print(
                        f"WARNING: ignoring task_df_name={val!r} in {label} "
                        f"overrides (top-level task_df_name is {self.task_df_name!r})."
                    )
                    continue
                print(f"{label}.{param}: {getattr(cfg, param)!r} -> {val!r} (override)")
                setattr(cfg, param, val)

        data_config_fp = self.load_from_model_dir / "data_config.json"
        print(f"Loading data_config from {data_config_fp}")
        self.data_config = PytorchDatasetConfig.from_json_file(data_config_fp)
        if self.task_df_name is not None:
            self.data_config.task_df_name = self.task_df_name
        apply_overrides(self.data_config, self.data_config_overrides, "data_config")

        config_fp = self.load_from_model_dir / "config.json"
        print(f"Loading config from {config_fp}")
        self.config = StructuredTransformerConfig.from_json_file(config_fp)
        # The port's repair: a string for an int, float or bool parameter is coerced to it.
        apply_overrides(self.config, coerce_to_signature(StructuredTransformerConfig.__init__, self.config_overrides),
                        "config")  # fmt: skip

        if self.task_specific_params is None:
            raise ValueError("Must specify num samples to generate")

        if (
            self.data_config_overrides.get("max_seq_len", None) is None
            and self.task_specific_params.get("max_new_events", None) is not None
        ):
            self.data_config.max_seq_len = self.config.max_seq_len - self.task_specific_params["max_new_events"]

        implied_max_new_events = self.config.max_seq_len - self.data_config.max_seq_len
        if implied_max_new_events <= 0:
            raise ValueError("Implied to not be generating any new events!")

        if self.config.task_specific_params is None:
            self.config.task_specific_params = {}
        self.config.task_specific_params.update(self.task_specific_params)

        if self.task_specific_params.get("max_new_events", None) is None:
            self.config.task_specific_params["max_new_events"] = implied_max_new_events

        assert self.config.task_specific_params["max_new_events"] == implied_max_new_events


def generate_trajectories(cfg: GenerateConfig, device=None, mesh=None, stats: dict | None = None) -> Path:
    """Writes the generated trajectories of the tuning and held-out splits
    (JAX's ``generate_trajectories``) on ``device`` (None: the CUDA device,
    raising without one); returns ``cfg.save_dir / "generated_trajectories"``.

    ``stats``, when given, receives ``{split: [(events generated, seconds), ...]}``:
    each `generate` call's generated events (the valid rows' real events
    past the prompt) and its host-clock seconds, the call synchronised."""
    if mesh is not None:
        raise ValueError(
            "generate_trajectories(mesh=...): data-parallel generation over a mesh is not part of the PyTorch "
            "port yet (ROADMAP Queue 1 item 7: meshes and tensor parallelism)"
        )
    device = resolve_device(device, "generate_trajectories")
    np.random.seed(cfg.seed)

    tuning_pyd = TorchDataset(cfg.data_config, split="tuning")
    held_out_pyd = TorchDataset(cfg.data_config, split="held_out")

    config = cfg.config
    batch_size = cfg.optimization_config.validation_batch_size

    orig = (config.max_seq_len, config.mean_log_inter_event_time_min, config.std_log_inter_event_time_min)
    config.set_to_dataset(tuning_pyd)
    config.max_seq_len, config.mean_log_inter_event_time_min, config.std_log_inter_event_time_min = orig

    num_samples = config.task_specific_params["num_samples"]
    if not num_samples:
        raise ValueError("task_specific_params.num_samples must be set")
    max_new_events = config.task_specific_params["max_new_events"]

    output_dir = Path(cfg.save_dir) / "generated_trajectories"
    model, _ = load_pretrained(cfg.pretrained_weights_fp, model=build_model(config), device=device)

    batch_index = 0
    for split, dataset in ((Split.TUNING, tuning_pyd), (Split.HELD_OUT, held_out_pyd)):
        per_sample: list[list] = [[] for _ in range(num_samples)]
        for batch in dataset.batches(batch_size, shuffle=False, drop_last=False, seed=0):
            valid = None if batch.valid_mask is None else batch.valid_mask.cpu().numpy().astype(bool)
            t0 = time.perf_counter()
            generated = generate(model, batch, config, seed=derive_request_seed(cfg.seed, batch_index),
                                 max_new_events=max_new_events, num_return_sequences=num_samples, use_cache=True,
                                 device=device)  # fmt: skip
            if stats is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                seconds = time.perf_counter() - t0
                rows = np.ones(batch.batch_size, bool) if valid is None else valid
                new = generated.event_mask[:, batch.sequence_length :].sum(1).cpu().numpy()
                n_new = int(new.reshape(-1, num_samples)[rows].sum())
                stats.setdefault(str(split), []).append((n_new, seconds))
            batch_index += 1
            for samp_idx, sample_batch in enumerate(generated.split_repeated_batch(num_samples)):
                # Drop blanked wrap-around fill subjects before writing.
                if valid is not None:
                    sample_batch = sample_batch.slice(torch.from_numpy(valid).to(sample_batch.event_mask.device))
                per_sample[samp_idx].append(sample_batch.convert_to_DL())

        for samp_idx, parts in enumerate(per_sample):
            out_fp = output_dir / str(split) / f"sample_{samp_idx}_local_rank_0.npz"
            out_fp.parent.mkdir(exist_ok=True, parents=True)
            if out_fp.exists() and not cfg.do_overwrite:
                raise FileExistsError(f"{out_fp} exists and do_overwrite is False!")
            write_dl_reps(out_fp, concat_dl_reps(parts))
            print(f"Wrote {out_fp}")

    return output_dir
