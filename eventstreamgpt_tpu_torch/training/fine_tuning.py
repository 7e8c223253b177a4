"""The stream-classification metrics and the fine-tuning configuration.

Counterpart: ``eventstreamgpt_tpu/training/fine_tuning.py``:
`StreamClassificationMetrics` (binary, multiclass and multilabel accuracy,
AUROC and AUPRC over `training.metrics`) and `FinetuneConfig` (bootstraps
from a pretraining ``save_dir``: loads ``config.json`` and
``data_config.json``, applies the overrides, sets the task dataframe and
derives few-shot save directories). Zero-shot evaluation reads both.

Fine-tuning itself (``init_from_pretrained_encoder``, ``train`` and
``models/fine_tuning_model.py``) is not ported yet: `train` and
`init_from_pretrained_encoder` raise ``ValueError`` naming ROADMAP Queue 1
item 9.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Any

import numpy as np

from ..data.config import PytorchDatasetConfig
from ..models.config import OptimizationConfig, StructuredTransformerConfig
from ..utils import config_dataclass
from .metrics import (
    BinaryAccuracy,
    BinaryAUROC,
    BinaryAveragePrecision,
    MeanMetric,
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassAveragePrecision,
    MultilabelAccuracy,
    MultilabelAUROC,
    MultilabelAveragePrecision,
)

# Where fine-tuning waits (its ValueErrors name it).
FINE_TUNING = "ROADMAP Queue 1 item 9: fine-tuning (ESTForStreamClassification and its train loop)"


class StreamClassificationMetrics:
    """The binary, multiclass or multilabel metric set of a config's
    ``problem_type`` and ``num_labels`` (JAX's)."""

    def __init__(self, config: StructuredTransformerConfig, split: str, n_thresholds: int = 50):
        self.split = split
        self.loss = MeanMetric()
        problem = config.problem_type
        n = config.num_labels

        if problem == "single_label_classification" and n > 2:
            kw = {"num_classes": n}
            self.metrics = {
                "macro_AUROC": MulticlassAUROC(**kw, thresholds=n_thresholds, average="macro"),
                "weighted_AUROC": MulticlassAUROC(**kw, thresholds=n_thresholds, average="weighted"),
                "macro_accuracy": MulticlassAccuracy(**kw, average="macro"),
                "weighted_accuracy": MulticlassAccuracy(**kw, average="weighted"),
                "micro_accuracy": MulticlassAccuracy(**kw, average="micro"),
                "macro_AUPRC": MulticlassAveragePrecision(**kw, thresholds=n_thresholds, average="macro"),
                "weighted_AUPRC": MulticlassAveragePrecision(**kw, thresholds=n_thresholds, average="weighted"),
            }
        elif problem == "single_label_classification" and n == 2:
            self.metrics = {
                "AUROC": BinaryAUROC(thresholds=n_thresholds),
                "accuracy": BinaryAccuracy(),
                "AUPRC": BinaryAveragePrecision(thresholds=n_thresholds),
            }
        elif problem == "multi_label_classification":
            kw = {"num_labels": n}
            self.metrics = {
                "macro_AUROC": MultilabelAUROC(**kw, thresholds=n_thresholds, average="macro"),
                "weighted_AUROC": MultilabelAUROC(**kw, thresholds=n_thresholds, average="weighted"),
                "micro_AUROC": MultilabelAUROC(**kw, thresholds=n_thresholds, average="micro"),
                "macro_accuracy": MultilabelAccuracy(**kw, average="macro"),
                "weighted_accuracy": MultilabelAccuracy(**kw, average="weighted"),
                "micro_accuracy": MultilabelAccuracy(**kw, average="micro"),
                "macro_AUPRC": MultilabelAveragePrecision(**kw, thresholds=n_thresholds, average="macro"),
                "weighted_AUPRC": MultilabelAveragePrecision(**kw, thresholds=n_thresholds, average="weighted"),
                "micro_AUPRC": MultilabelAveragePrecision(**kw, thresholds=n_thresholds, average="micro"),
            }
        else:
            raise ValueError(f"{problem} not valid")

    def update(self, out, n_valid: int | None = None, valid_mask=None, skip_metrics=()) -> None:
        """Feeds one batch's ``out.preds`` / ``out.labels`` (numpy or CPU
        tensors) and ``out.loss``; fill rows (``valid_mask`` False, or past
        ``n_valid``) are dropped."""
        preds = np.asarray(out.preds)
        labels = np.asarray(out.labels)
        B = len(labels)
        if valid_mask is None:
            valid_mask = np.arange(B) < (B if n_valid is None else n_valid)
        else:
            valid_mask = np.asarray(valid_mask, bool)
        preds, labels = preds[valid_mask], labels[valid_mask]
        self.loss.update(float(out.loss), weight=int(valid_mask.sum()))
        for name, metric in self.metrics.items():
            if any(s in name for s in skip_metrics):
                continue
            metric.update(preds, labels)

    def compute(self) -> dict[str, float]:
        out = {f"{self.split}_loss": self.loss.compute()}
        for name, metric in self.metrics.items():
            v = metric.compute()
            if not (isinstance(v, float) and np.isnan(v)):
                out[f"{self.split}_{name}"] = v
        return out


@config_dataclass
class FinetuneConfig:
    """The fine-tuning run's configuration (JAX's ``FinetuneConfig``):
    with ``load_from_model_dir`` set it reads that pretraining directory's
    ``data_config.json`` and ``config.json``, sets ``task_df_name`` on the
    data config, applies ``data_config_overrides``, merges
    ``task_specific_params`` into the model config and applies
    ``config_overrides``."""

    load_from_model_dir: str | Path | None = None
    seed: int = 1

    pretrained_weights_fp: str | Path | None = None
    save_dir: str | Path | None = None

    do_overwrite: bool = False
    do_detect_anomaly: bool = False

    optimization_config: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)

    task_df_name: str | None = None

    data_config_overrides: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"subsequence_sampling_strategy": "to_end", "seq_padding_side": "right"}
    )

    trainer_config: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"log_every_n_steps": 10, "checkpoint_every_n_steps": 100, "max_checkpoints_to_keep": 2}
    )

    task_specific_params: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"pooling_method": "last", "num_samples": None}
    )

    config_overrides: dict[str, Any] = dataclasses.field(default_factory=dict)

    do_final_validation_on_metrics: bool = True
    do_resume_from_checkpoint: bool = True

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
        if self.task_df_name is None:
            raise ValueError("Missing mandatory parameter task_df_name!")

        if self.pretrained_weights_fp is None:
            self.pretrained_weights_fp = self.load_from_model_dir
        if self.save_dir is None:
            subset_size = self.data_config_overrides.get("train_subset_size", None)
            if subset_size in (None, "FULL"):
                self.save_dir = self.load_from_model_dir / "finetuning" / self.task_df_name
            else:
                if self.data_config_overrides.get("train_subset_seed", None) is None:
                    self.data_config_overrides["train_subset_seed"] = int(random.randint(1, int(1e6)))
                    print(
                        f"WARNING: train_subset_size={subset_size} but seed is unset. Setting to "
                        f"{self.data_config_overrides['train_subset_seed']}"
                    )
                self.save_dir = (
                    self.load_from_model_dir
                    / "finetuning"
                    / f"subset_size_{subset_size}"
                    / f"subset_seed_{self.data_config_overrides['train_subset_seed']}"
                    / self.task_df_name
                )

        data_config_fp = self.load_from_model_dir / "data_config.json"
        print(f"Loading data_config from {data_config_fp}")
        self.data_config = PytorchDatasetConfig.from_json_file(data_config_fp)
        self.data_config.task_df_name = self.task_df_name

        for param, val in (self.data_config_overrides or {}).items():
            if param == "task_df_name":
                print(
                    f"WARNING: task_df_name is set in data_config_overrides to {val}! "
                    f"Original is {self.task_df_name}. Ignoring data_config_overrides..."
                )
                continue
            print(f"Overwriting {param} in data_config from {getattr(self.data_config, param)} to {val}")
            setattr(self.data_config, param, val)

        config_fp = self.load_from_model_dir / "config.json"
        print(f"Loading config from {config_fp}")
        self.config = StructuredTransformerConfig.from_json_file(config_fp)

        if self.task_specific_params is not None:
            if self.config.task_specific_params is None:
                self.config.task_specific_params = {}
            self.config.task_specific_params.update(self.task_specific_params)

        for param, val in (self.config_overrides or {}).items():
            print(f"Overwriting {param} in config from {getattr(self.config, param)} to {val}")
            setattr(self.config, param, val)


def init_from_pretrained_encoder(*args, **kwargs):
    """JAX's warm start of a stream classifier from a pretrained encoder: not ported yet."""
    raise ValueError(f"init_from_pretrained_encoder is not part of the PyTorch port yet ({FINE_TUNING})")


def train(cfg: FinetuneConfig, *args, **kwargs):
    """JAX's fine-tuning loop: not ported yet."""
    raise ValueError(f"fine-tuning's train is not part of the PyTorch port yet ({FINE_TUNING})")
