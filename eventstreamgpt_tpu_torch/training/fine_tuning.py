"""Fine-tuning a stream classifier from a pretrained encoder.

Counterpart: ``eventstreamgpt_tpu/training/fine_tuning.py``:
`StreamClassificationMetrics` (binary, multiclass and multilabel accuracy,
AUROC and AUPRC over `training.metrics`), `FinetuneConfig` (bootstraps
from a pretraining ``save_dir``: loads ``config.json`` and
``data_config.json``, applies the overrides, sets the task dataframe and
derives few-shot save directories), `init_from_pretrained_encoder` (the
encoder's weights grafted by name from a `save_pretrained` directory) and
`train` (JAX's fine-tuning loop on `models.fine_tuning_model.ESTForStreamClassification`).
Zero-shot evaluation and embedding extraction read the configuration too.

`train` runs `training.pretrain`'s machinery: the captured single step of
`make_train_step` (one CUDA graph a batch signature), the epochs of
`training.pretrain.fit` (log windows, vetted checkpoints, the sentinel and
its rollback, preemption, early stopping) and its refusals; only the model,
the loss and the metrics differ.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch

from ..data.config import PytorchDatasetConfig
from ..data.device_dataset import DeviceDataset
from ..data.torch_dataset import TorchDataset
from ..models.config import OptimizationConfig, Split, StructuredTransformerConfig
from ..models.fine_tuning_model import ESTForStreamClassification
from ..utils import config_dataclass
from ..utils.config_tool import coerce_to_signature
from ..utils.device import resolve_device
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
from .checkpoint import PRETRAINED_WEIGHTS_DIR, WEIGHTS_FILE, save_pretrained
from .pretrain import eval_batches

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

        # The port's repair: a string for an int, float or bool parameter is coerced to it.
        for param, val in coerce_to_signature(StructuredTransformerConfig.__init__, self.config_overrides or {}).items():
            print(f"Overwriting {param} in config from {getattr(self.config, param)} to {val}")
            setattr(self.config, param, val)


def init_from_pretrained_encoder(model: torch.nn.Module, pretrained_dir: Path | str) -> torch.nn.Module:
    """Grafts a `save_pretrained` directory's encoder weights into ``model``
    (a stream classifier or an encoder-only model) in place; returns it.

    JAX's graft walks the destination: each ``encoder.*`` tensor of
    ``model`` takes the pretrained tensor of the same name; one that is
    missing there, or has another shape, keeps its fresh init with a
    warning. Everything else (the logit layer; a generative checkpoint's
    heads) stays as it is, silently."""
    weights = Path(pretrained_dir).expanduser().resolve() / PRETRAINED_WEIGHTS_DIR / WEIGHTS_FILE
    pretrained = torch.load(weights, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not name.startswith("encoder."):
                continue
            src = pretrained.get(name)
            if src is None:
                print(f"WARNING: {name} missing from pretrained weights; keeping fresh init")
            elif tuple(src.shape) != tuple(t.shape):
                print(f"WARNING: shape mismatch at {name}; keeping fresh init")
            else:
                t.copy_(src)
    return model


def new_classifier(config: StructuredTransformerConfig, seed: int) -> ESTForStreamClassification:
    """A fresh stream classifier: the encoder numpy-seeded from ``seed``
    (`convert.init_params_from_seed`), the logit layer drawn as flax's
    ``Dense`` draws one (`ESTForStreamClassification.reset_logit_layer`)."""
    from ..convert import init_params_from_seed

    return init_params_from_seed(ESTForStreamClassification(config), seed=seed).reset_logit_layer(seed)


def evaluate(eval_step, dataset, batch_size: int, config: StructuredTransformerConfig, split: str,
             device_data=None) -> dict[str, float]:  # fmt: skip
    """One pass over a split (`training.pretrain.eval_batches`); returns its
    ``{split}_...`` classification metrics, the fill rows of the last batch
    dropped by ``valid_mask``. The outputs are read from the device once,
    after the pass."""
    metrics = StreamClassificationMetrics(config, split)
    outs = []
    for batch, valid in eval_batches(dataset, batch_size, device_data):
        out = eval_step(batch)
        outs.append((out.loss, out.preds, out.labels, valid))
    for loss, preds, labels, valid in [tuple(t.cpu() for t in row) for row in outs]:
        metrics.update(SimpleNamespace(loss=loss, preds=preds.numpy(), labels=labels.numpy()), valid_mask=valid.numpy())
    return metrics.compute()


def device_dispatches(train_step: Callable, device_data, batch_size: int, seed: int, epoch_seed: int, skip: int):
    """`training.pretrain.fit`'s ``(run, 1, n_events)`` over batches
    collated on the device from resident tables, one step each."""
    for batch, n_events in device_data.batches(batch_size, shuffle=True, seed=epoch_seed, skip_batches=skip,
                                               with_counts=True):  # fmt: skip
        yield functools.partial(train_step, batch, seed), 1, n_events


def train(cfg: FinetuneConfig, device=None) -> tuple[float | None, dict | None, dict | None]:
    """End-to-end fine-tuning from a pretraining ``save_dir`` (JAX's ``train``).

    Returns ``(tuning_loss, tuning_metrics, held_out_metrics)`` of the final
    validation, or ``(None, None, None)`` without it. ``device=None`` means
    the CUDA device (and raises without one); the tests pass ``"cpu"``.

    In JAX's order: ``train`` and ``tuning`` `TorchDataset`s of the task,
    the configs set to the dataset, ``config.json``, ``data_config.json``
    and ``optimization_config.json`` under ``cfg.save_dir``, a fresh
    classifier (`new_classifier` from ``cfg.seed``) with the encoder of
    ``cfg.pretrained_weights_fp`` grafted in (`init_from_pretrained_encoder`),
    AdamW, resume from the newest verified checkpoint, then the epochs of
    `training.pretrain.fit` on the captured single step: with the tables
    resident (``trainer_config["device_resident_data"]``: ``"auto"``, True
    or False, as pretraining reads it) each batch collated on the device,
    otherwise on the host with the prefetch thread. Each epoch ends with the
    tuning evaluation (`StreamClassificationMetrics`), the epoch-end
    checkpoint and early stopping. Then ``save_pretrained`` of the final
    weights and, unless ``do_final_validation_on_metrics`` is off, the
    held-out evaluation beside the last epoch's tuning metrics
    (``tuning_metrics.json``, ``held_out_metrics.json``). The log records
    are pretraining's (`training.pretrain.fit`), with a ``"final"`` record.

    Raises ``ValueError`` for what `training.pretrain.refusals` names.
    """
    from ..reliability import faults
    from ..reliability.integrity import resume_training_state
    from .pretrain import (
        check_train_size,
        fit,
        host_dispatches,
        json_logger,
        load_train_state,
        make_eval_step,
        make_train_step,
        optimizer_setup,
        refusals,
        reliability_setup,
        resident_datasets,
        train_state_dict,
        write_final_metrics,
        write_run_configs,
    )

    device = resolve_device(device, "train")
    refusals(cfg)
    np.random.seed(cfg.seed)
    anomaly = bool(cfg.do_detect_anomaly)

    train_ds = TorchDataset(cfg.data_config, split="train")
    tuning_ds = TorchDataset(cfg.data_config, split="tuning")
    config, oc = cfg.config, cfg.optimization_config
    config.set_to_dataset(train_ds)
    oc.set_to_dataset(train_ds)
    save_dir = Path(cfg.save_dir)
    write_run_configs(cfg, config, save_dir)

    check_train_size(train_ds, oc)
    model = new_classifier(config, cfg.seed)
    if cfg.pretrained_weights_fp is not None:
        init_from_pretrained_encoder(model, cfg.pretrained_weights_fp)
    model.to(device).train()
    optimizer, scheduler, state = optimizer_setup(model, oc, device)

    def state_dict() -> dict:
        return train_state_dict(model, optimizer, scheduler, state)

    def load_state(sd: dict) -> None:
        load_train_state(sd, model, optimizer, scheduler, state)

    tc = dict(cfg.trainer_config or {})
    sentinel, rollback_ctl, ckpt_mgr = reliability_setup(tc, save_dir)
    start_epoch = skip_batches = 0
    if cfg.do_resume_from_checkpoint and ckpt_mgr.latest_step() is not None:
        _, start_epoch, skip_batches = resume_training_state(ckpt_mgr, load_state)

    device_train, device_tuning, budget = resident_datasets(tc, train_ds, tuning_ds, device)
    train_step = make_train_step(model, optimizer, scheduler, with_health=sentinel is not None, device=device,
                                 cuda_graph=not anomaly, state=state)  # fmt: skip
    eval_step = make_eval_step(model, device)

    def dispatches(epoch: int, skip: int):
        if device_train is not None:
            return device_dispatches(train_step, device_train, oc.batch_size, cfg.seed, cfg.seed + epoch, skip)
        batches = train_ds.batches(oc.batch_size, shuffle=True, seed=cfg.seed + epoch, skip_batches=skip)
        return host_dispatches(train_step, faults.wrap_batches(batches, epoch=epoch, first_index=skip), device,
                               cfg.seed)  # fmt: skip

    def evaluate_epoch(epoch: int) -> dict:
        return evaluate(eval_step, tuning_ds, oc.validation_batch_size, config, Split.TUNING, device_tuning)

    log_record = json_logger(save_dir / "train_log.jsonl")
    steps_per_epoch = len(train_ds) // oc.batch_size
    tuning_metrics = fit(
        label="fine-tuning", oc=oc, tc=tc, device=device, state=state, step_fn=train_step, dispatches=dispatches,
        full_dispatch=1, evaluate_epoch=evaluate_epoch, sentinel=sentinel, rollback_ctl=rollback_ctl,
        ckpt_mgr=ckpt_mgr, start_epoch=start_epoch, skip_batches=skip_batches, state_dict=state_dict,
        load_state=load_state, log_record=log_record,
        total_steps=oc.max_training_steps or steps_per_epoch * oc.max_epochs, anomaly=anomaly,
    )  # fmt: skip

    ckpt_mgr.wait_until_finished()
    t0 = time.perf_counter()
    save_pretrained(save_dir, model)
    save_s = time.perf_counter() - t0
    if not cfg.do_final_validation_on_metrics:
        log_record({"split": "final", "save_pretrained_s": save_s})
        ckpt_mgr.close()
        return None, None, None

    held_out_ds = TorchDataset(cfg.data_config, split="held_out")
    device_held_out = (
        DeviceDataset.try_create(held_out_ds, device=device, max_bytes=budget) if device_train is not None else None
    )
    # The last epoch's tuning evaluation ran on these weights: JAX reuses it.
    final_tuning = tuning_metrics
    if final_tuning is None:
        final_tuning = evaluate(eval_step, tuning_ds, oc.validation_batch_size, config, Split.TUNING, device_tuning)
    final_held_out = evaluate(eval_step, held_out_ds, oc.validation_batch_size, config, Split.HELD_OUT,
                              device_held_out)  # fmt: skip
    log_record({"split": "final", "save_pretrained_s": save_s, "validation_s": time.perf_counter() - t0 - save_s})
    write_final_metrics(save_dir, final_tuning, final_held_out)
    ckpt_mgr.close()
    return final_tuning.get("tuning_loss"), final_tuning, final_held_out
