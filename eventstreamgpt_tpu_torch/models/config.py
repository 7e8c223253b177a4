"""Model and optimization configuration for structured event-stream transformers.

Counterpart: ``eventstreamgpt_tpu/models/config.py``
(`StructuredTransformerConfig`, `OptimizationConfig`, `MetricsConfig` and
its enums `Split`, `MetricCategories`, `Metrics`, `Averaging`). The constructors,
their validation and ``to_dict``/``from_dict`` follow the JAX classes field
for field, so one ``config.json`` loads in both packages and ``to_dict``
gives the same dictionary. ``compute_dtype`` is a ``torch.dtype``.
``dep_graph_fused_attention`` and ``dep_graph_attention_impl`` are kept so
a JAX ``config.json`` loads; they select nothing in the port, where the
tensors' device routes dep-graph attention (`ops.dep_graph`).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Any, Hashable, Union

import torch

from ..data.config import MeasurementConfig
from ..data.types import DataModality
from ..utils import JSONableMixin, StrEnum, config_dataclass
from .embedding import MeasIndexGroupOptions, StaticEmbeddingMode


class Split(StrEnum):
    """What data split is being used."""

    TRAIN = enum.auto()
    TUNING = enum.auto()
    HELD_OUT = enum.auto()


class MetricCategories(StrEnum):
    """Categories of metrics, for configuring what to track."""

    LOSS_PARTS = enum.auto()
    TTE = "TTE"
    CLASSIFICATION = enum.auto()
    REGRESSION = enum.auto()


class Metrics(StrEnum):
    """Supported metric functions."""

    AUROC = "AUROC"
    AUPRC = "AUPRC"
    ACCURACY = enum.auto()
    EXPLAINED_VARIANCE = enum.auto()
    MSE = "MSE"
    MSLE = "MSLE"


class Averaging(StrEnum):
    """Metric averaging modes in multi-class and multi-label settings."""

    MACRO = enum.auto()
    MICRO = enum.auto()
    WEIGHTED = enum.auto()


def _default_include_metrics() -> dict:
    def eval_metrics() -> dict:
        return {
            MetricCategories.LOSS_PARTS: True,
            MetricCategories.TTE: {Metrics.MSE: True, Metrics.MSLE: True},
            MetricCategories.CLASSIFICATION: {Metrics.AUROC: [Averaging.WEIGHTED], Metrics.ACCURACY: True},
            MetricCategories.REGRESSION: {Metrics.MSE: True},
        }

    return {Split.TUNING: eval_metrics(), Split.HELD_OUT: eval_metrics()}


@config_dataclass
class MetricsConfig(JSONableMixin):
    """Which metrics are tracked, over which splits, with which averagings.

    ``include_metrics`` is ``{split: {category: True | {metric: True |
    [averagings]}}}``; ``do_skip_all_metrics`` clears it.
    """

    n_auc_thresholds: int | None = 50
    do_skip_all_metrics: bool = False
    do_validate_args: bool = False
    include_metrics: dict[str, Any] = dataclasses.field(default_factory=_default_include_metrics)

    def __post_init__(self):
        if self.do_skip_all_metrics:
            self.include_metrics = {}

    def do_log_only_loss(self, split: str) -> bool:
        """True if only the loss (no other metric) is logged for ``split``."""
        inc = self.include_metrics.get(split) if not self.do_skip_all_metrics else None
        return not inc or (len(inc) == 1 and MetricCategories.LOSS_PARTS in inc)

    def do_log(self, split: str, cat: str, metric_name: str | None = None) -> bool:
        """True if ``metric_name`` is tracked for ``split`` and ``cat``. A
        name may carry an averaging prefix (``weighted_AUROC``);
        ``explained_variance`` is the one unprefixed name with an underscore."""
        if self.do_log_only_loss(split):
            return False
        inc_dict = self.include_metrics[split].get(cat, False)
        if not inc_dict:
            return False
        if metric_name is None or inc_dict is True:
            return True
        if "_" not in metric_name.replace("explained_variance", ""):
            return metric_name in inc_dict
        averaging, _, metric = metric_name.partition("_")
        permissible = inc_dict.get(metric, [])
        return permissible is True or averaging in permissible

    def do_log_any(self, cat: str, metric_name: str | None = None) -> bool:
        """True if ``metric_name`` is tracked for ``cat`` on any split."""
        return any(self.do_log(split, cat, metric_name) for split in Split.values())


class StructuredEventProcessingMode(StrEnum):
    """Structured event sequence processing modes."""

    CONDITIONALLY_INDEPENDENT = enum.auto()
    NESTED_ATTENTION = enum.auto()


class TimeToEventGenerationHeadType(StrEnum):
    """Options for model TTE generation heads."""

    EXPONENTIAL = enum.auto()
    LOG_NORMAL_MIXTURE = enum.auto()


class AttentionLayerType(StrEnum):
    """Attention layer type options."""

    GLOBAL = enum.auto()
    LOCAL = enum.auto()


ATTENTION_TYPES_LIST_T = Union[str, list]


class StructuredTransformerConfig(JSONableMixin):
    """Configuration for event-stream transformer models (JAX field set)."""

    def __init__(
        self,
        vocab_sizes_by_measurement: dict[str, int] | None = None,
        vocab_offsets_by_measurement: dict[str, int] | None = None,
        measurement_configs: dict[str, MeasurementConfig] | None = None,
        measurements_idxmap: dict[str, dict[Hashable, int]] | None = None,
        measurements_per_generative_mode: dict[str, list[str]] | None = None,
        event_types_idxmap: dict[str, int] | None = None,
        measurements_per_dep_graph_level: list | None = None,
        max_seq_len: int = 256,
        do_split_embeddings: bool = False,
        categorical_embedding_dim: int | None = None,
        numerical_embedding_dim: int | None = None,
        static_embedding_mode: str = StaticEmbeddingMode.SUM_ALL,
        static_embedding_weight: float = 0.5,
        dynamic_embedding_weight: float = 0.5,
        categorical_embedding_weight: float = 0.5,
        numerical_embedding_weight: float = 0.5,
        do_normalize_by_measurement_index: bool = False,
        structured_event_processing_mode: str = StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT,
        hidden_size: int | None = None,
        head_dim: int | None = 64,
        num_hidden_layers: int = 2,
        num_attention_heads: int = 4,
        seq_attention_types: ATTENTION_TYPES_LIST_T | None = None,
        seq_window_size: int = 32,
        attention_implementation: str = "einsum",
        gradient_checkpointing: str = "none",
        scan_layers: bool = False,
        precision: str = "fp32",
        dep_graph_attention_types: ATTENTION_TYPES_LIST_T | None = None,
        dep_graph_window_size: int | None = 2,
        dep_graph_fused_attention: bool | None = True,
        dep_graph_attention_impl: str | None = None,
        head_narrow_projections: bool = True,
        intermediate_size: int = 32,
        activation_function: str = "gelu",
        attention_dropout: float = 0.1,
        input_dropout: float = 0.1,
        resid_dropout: float = 0.1,
        init_std: float = 0.02,
        layer_norm_epsilon: float = 1e-5,
        do_full_block_in_dep_graph_attention: bool | None = True,
        do_full_block_in_seq_attention: bool | None = False,
        TTE_generation_layer_type: str = TimeToEventGenerationHeadType.EXPONENTIAL,
        TTE_lognormal_generation_num_components: int | None = None,
        mean_log_inter_event_time_min: float | None = None,
        std_log_inter_event_time_min: float | None = None,
        use_cache: bool = True,
        finetuning_task: str | None = None,
        id2label: dict[int, str] | None = None,
        label2id: dict[str, int] | None = None,
        num_labels: int | None = None,
        problem_type: str | None = None,
        task_specific_params: dict[str, Any] | None = None,
        **kwargs,
    ):
        self.event_types_idxmap = event_types_idxmap or {}
        self.measurement_configs = {
            k: (MeasurementConfig.from_dict(v) if type(v) is dict else v)
            for k, v in (measurement_configs or {}).items()
        }

        if do_split_embeddings:
            for nm, v in (
                ("categorical_embedding_dim", categorical_embedding_dim),
                ("numerical_embedding_dim", numerical_embedding_dim),
            ):
                if type(v) is not int or v <= 0:
                    raise ValueError(
                        f"When do_split_embeddings={do_split_embeddings}, {nm} must be "
                        f"a positive integer. Got {v}."
                    )
        else:
            categorical_embedding_dim = numerical_embedding_dim = None
        self.do_split_embeddings = do_split_embeddings
        self.categorical_embedding_dim = categorical_embedding_dim
        self.numerical_embedding_dim = numerical_embedding_dim
        self.static_embedding_mode = StaticEmbeddingMode(static_embedding_mode)
        self.static_embedding_weight = static_embedding_weight
        self.dynamic_embedding_weight = dynamic_embedding_weight
        self.categorical_embedding_weight = categorical_embedding_weight
        self.numerical_embedding_weight = numerical_embedding_weight
        self.do_normalize_by_measurement_index = do_normalize_by_measurement_index

        if structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION:
            for nm, v in (
                ("do_full_block_in_seq_attention", do_full_block_in_seq_attention),
                ("do_full_block_in_dep_graph_attention", do_full_block_in_dep_graph_attention),
                ("measurements_per_dep_graph_level", measurements_per_dep_graph_level),
            ):
                if v is None:
                    raise ValueError(f"For a {structured_event_processing_mode} model, {nm} should not be None")
            levels = []
            for group in measurements_per_dep_graph_level:
                proc = []
                for m in group:
                    if isinstance(m, str):
                        proc.append(m)
                    elif isinstance(m, (list, tuple)) and len(m) == 2 and isinstance(m[0], str):
                        if m[1] not in MeasIndexGroupOptions.values():
                            raise ValueError(f"Invalid `measurements_per_dep_graph_level` entry {m}.")
                        proc.append((m[0], m[1]))
                    else:
                        raise ValueError(f"Invalid `measurements_per_dep_graph_level` entry {m}.")
                levels.append(proc)
            measurements_per_dep_graph_level = levels
        elif structured_event_processing_mode == StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            # NA-only knobs are nulled for CI models, as in the JAX config.
            measurements_per_dep_graph_level = None
            do_full_block_in_seq_attention = None
            do_full_block_in_dep_graph_attention = None
            dep_graph_attention_types = None
            dep_graph_window_size = None
            dep_graph_fused_attention = None
        else:
            raise ValueError(
                "`structured_event_processing_mode` must be a valid `StructuredEventProcessingMode` "
                f"enum member ({StructuredEventProcessingMode.values()}). Got "
                f"{structured_event_processing_mode}."
            )
        self.structured_event_processing_mode = structured_event_processing_mode

        if head_dim is None and hidden_size is None:
            raise ValueError("Must specify at least one of hidden size or head dim!")
        if hidden_size is None:
            hidden_size = head_dim * num_attention_heads
        elif head_dim is None:
            head_dim = hidden_size // num_attention_heads
        if head_dim * num_attention_heads != hidden_size:
            raise ValueError(
                f"hidden_size must be divisible by num_attention_heads (got `hidden_size`: {hidden_size} "
                f"and `num_attention_heads`: {num_attention_heads})."
            )
        if type(num_hidden_layers) is not int:
            raise TypeError(f"num_hidden_layers must be an int! Got {type(num_hidden_layers)}.")
        if num_hidden_layers <= 0:
            raise ValueError(f"num_hidden_layers must be > 0! Got {num_hidden_layers}.")
        self.num_hidden_layers = num_hidden_layers

        if seq_attention_types is None:
            seq_attention_types = ["local", "global"]
        self.seq_attention_types = seq_attention_types
        self.seq_attention_layers = self.expand_attention_types_params(seq_attention_types)
        if len(self.seq_attention_layers) != num_hidden_layers:
            raise ValueError("`len(config.seq_attention_layers)` must equal `config.num_hidden_layers`.")
        if structured_event_processing_mode != StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            if dep_graph_attention_types is None:
                dep_graph_attention_types = "global"
            dep_graph_attention_layers = self.expand_attention_types_params(dep_graph_attention_types)
        else:
            dep_graph_attention_layers = None
        self.dep_graph_attention_types = dep_graph_attention_types
        self.dep_graph_attention_layers = dep_graph_attention_layers

        self.seq_window_size = seq_window_size
        if attention_implementation not in ("einsum", "pallas_flash", "ring"):
            raise ValueError(
                f"attention_implementation must be 'einsum', 'pallas_flash', or 'ring'; got "
                f"{attention_implementation}"
            )
        self.attention_implementation = attention_implementation
        if gradient_checkpointing not in ("none", "block", "dots", "dots_no_batch", "save_attention"):
            raise ValueError(f"invalid gradient_checkpointing {gradient_checkpointing}")
        self.gradient_checkpointing = gradient_checkpointing
        self.scan_layers = bool(scan_layers)
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be 'fp32' or 'bf16'; got {precision}")
        self.precision = precision
        self.dep_graph_window_size = dep_graph_window_size
        self.dep_graph_fused_attention = dep_graph_fused_attention
        if dep_graph_attention_impl not in (None, "auto", "pallas", "pallas_interpret", "xla"):
            raise ValueError(f"invalid dep_graph_attention_impl {dep_graph_attention_impl}")
        self.dep_graph_attention_impl = dep_graph_attention_impl
        self.head_narrow_projections = head_narrow_projections

        if TTE_generation_layer_type == TimeToEventGenerationHeadType.LOG_NORMAL_MIXTURE:
            if TTE_lognormal_generation_num_components is None:
                raise ValueError(
                    f"For a {TTE_generation_layer_type} model, "
                    "TTE_lognormal_generation_num_components should not be None"
                )
            if type(TTE_lognormal_generation_num_components) is not int:
                raise TypeError("`TTE_lognormal_generation_num_components` must be an int!")
            if TTE_lognormal_generation_num_components <= 0:
                raise ValueError("`TTE_lognormal_generation_num_components` should be >0")
            if mean_log_inter_event_time_min is None:
                mean_log_inter_event_time_min = 0.0
            if std_log_inter_event_time_min is None:
                std_log_inter_event_time_min = 1.0
        elif TTE_generation_layer_type == TimeToEventGenerationHeadType.EXPONENTIAL:
            TTE_lognormal_generation_num_components = None
            mean_log_inter_event_time_min = None
            std_log_inter_event_time_min = None
        else:
            raise ValueError(
                f"Invalid option for `TTE_generation_layer_type`. Must be in "
                f"({TimeToEventGenerationHeadType.values()}). Got {TTE_generation_layer_type}."
            )
        self.TTE_generation_layer_type = TTE_generation_layer_type
        self.TTE_lognormal_generation_num_components = TTE_lognormal_generation_num_components
        self.mean_log_inter_event_time_min = mean_log_inter_event_time_min
        self.std_log_inter_event_time_min = std_log_inter_event_time_min

        self.init_std = init_std
        self.max_seq_len = max_seq_len
        self.vocab_sizes_by_measurement = vocab_sizes_by_measurement or {}
        self.vocab_offsets_by_measurement = vocab_offsets_by_measurement or {}
        self.measurements_idxmap = measurements_idxmap or {}
        self.measurements_per_generative_mode = measurements_per_generative_mode or {}
        self.measurements_per_dep_graph_level = measurements_per_dep_graph_level
        if self.vocab_offsets_by_measurement:
            self.vocab_size = (
                sum(self.vocab_sizes_by_measurement.values())
                + min(self.vocab_offsets_by_measurement.values())
                + (len(self.vocab_offsets_by_measurement) - len(self.vocab_sizes_by_measurement))
            )
        else:
            self.vocab_size = max(sum(self.vocab_sizes_by_measurement.values()), 1)

        self.head_dim = head_dim
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.attention_dropout = attention_dropout
        self.input_dropout = input_dropout
        self.resid_dropout = resid_dropout
        self.intermediate_size = intermediate_size
        self.layer_norm_epsilon = layer_norm_epsilon
        self.activation_function = activation_function
        self.do_full_block_in_seq_attention = do_full_block_in_seq_attention
        self.do_full_block_in_dep_graph_attention = do_full_block_in_dep_graph_attention
        self.use_cache = use_cache
        self.finetuning_task = finetuning_task
        self.id2label = id2label
        self.label2id = label2id
        self.num_labels = num_labels
        self.problem_type = problem_type
        self.task_specific_params = task_specific_params
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._extra_kwargs = sorted(kwargs.keys())

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 activations and matmuls under ``precision="bf16"``, else fp32."""
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    def measurements_for(self, modality: DataModality) -> list[str]:
        return self.measurements_per_generative_mode.get(modality, [])

    def expand_attention_types_params(self, attention_types: ATTENTION_TYPES_LIST_T) -> list[str]:
        """Expands the attention-type mini-language into a per-layer list.

        Examples:
            >>> StructuredTransformerConfig(num_hidden_layers=3).expand_attention_types_params(
            ...     ["local", "global"])
            ['local', 'global', 'local']
        """
        if isinstance(attention_types, str):
            return [attention_types] * self.num_hidden_layers
        if not isinstance(attention_types, list):
            raise TypeError(f"Config Invalid {attention_types} ({type(attention_types)}) is wrong type!")
        if isinstance(attention_types[0], str):
            return (attention_types * self.num_hidden_layers)[: self.num_hidden_layers]
        if isinstance(attention_types[0], (list, tuple)):
            out = []
            for sub_list, n_layers in attention_types:
                out.extend(list(sub_list) * n_layers)
            return out[: self.num_hidden_layers]
        raise TypeError(f"Config Invalid {attention_types} El 0 ({type(attention_types[0])}) is wrong type!")

    def set_to_dataset(self, dataset) -> None:
        """Copies the vocabulary, the measurement layout, ``max_seq_len`` and
        (for a lognormal TTE head) the log inter-event-time statistics from a
        dataset with `data.torch_dataset.TorchDataset`'s attributes (JAX's
        ``set_to_dataset``; task fields only when ``dataset.has_task``)."""
        vc = dataset.vocabulary_config
        self.measurement_configs = dataset.measurement_configs
        self.measurements_idxmap = vc.measurements_idxmap
        self.measurements_per_generative_mode = dict(vc.measurements_per_generative_mode)
        for k in DataModality.values():
            self.measurements_per_generative_mode.setdefault(k, [])
        if self.structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION:
            in_dep = {
                x[0] if isinstance(x, (list, tuple)) and len(x) == 2 else x
                for x in itertools.chain.from_iterable(self.measurements_per_dep_graph_level)
            }
            in_generative_mode = set(itertools.chain.from_iterable(self.measurements_per_generative_mode.values()))
            if not in_generative_mode.issubset(in_dep):
                raise ValueError(
                    "Config is attempting to generate something outside the dependency graph:\n"
                    f"{in_generative_mode - in_dep}"
                )
        self.event_types_idxmap = vc.event_types_idxmap
        self.vocab_offsets_by_measurement = vc.vocab_offsets_by_measurement
        self.vocab_sizes_by_measurement = dict(vc.vocab_sizes_by_measurement)
        for k in set(self.vocab_offsets_by_measurement) - set(self.vocab_sizes_by_measurement):
            self.vocab_sizes_by_measurement[k] = 1
        self.vocab_size = vc.total_vocab_size
        self.max_seq_len = dataset.max_seq_len
        if self.TTE_generation_layer_type == TimeToEventGenerationHeadType.LOG_NORMAL_MIXTURE:
            self.mean_log_inter_event_time_min = dataset.mean_log_inter_event_time_min
            self.std_log_inter_event_time_min = dataset.std_log_inter_event_time_min
        if getattr(dataset, "has_task", False):
            if len(dataset.tasks) == 1:
                self.finetuning_task = dataset.tasks[0]
                task_type = dataset.task_types[self.finetuning_task]
                if task_type in ("binary_classification", "multi_class_classification"):
                    self.id2label = dict(enumerate(dataset.task_vocabs[self.finetuning_task]))
                    self.label2id = {v: i for i, v in self.id2label.items()}
                    self.num_labels = len(self.id2label)
                    self.problem_type = "single_label_classification"
                elif task_type == "regression":
                    self.num_labels = 1
                    self.problem_type = "regression"
            elif all(t == "binary_classification" for t in dataset.task_types.values()):
                self.problem_type = "multi_label_classification"
                self.num_labels = len(dataset.tasks)
            elif all(t == "regression" for t in dataset.task_types.values()):
                self.num_labels = len(dataset.tasks)
                self.problem_type = "regression"

    def to_dict(self) -> dict[str, Any]:
        as_dict = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("seq_attention_layers", "_extra_kwargs", "dep_graph_attention_layers")
        }
        if as_dict.get("measurement_configs"):
            as_dict["measurement_configs"] = {
                k: (v if isinstance(v, dict) else v.to_dict())
                for k, v in as_dict["measurement_configs"].items()
            }
        if as_dict.get("id2label") is not None:
            as_dict["id2label"] = {int(k): v for k, v in as_dict["id2label"].items()}
        return as_dict

    @classmethod
    def from_dict(cls, as_dict: dict) -> "StructuredTransformerConfig":
        as_dict = dict(as_dict)
        if as_dict.get("id2label") is not None:
            as_dict["id2label"] = {int(k): v for k, v in as_dict["id2label"].items()}
        return cls(**as_dict)

    def __eq__(self, other) -> bool:
        return isinstance(other, StructuredTransformerConfig) and self.to_dict() == other.to_dict()



@config_dataclass
class OptimizationConfig(JSONableMixin):
    """Optimization settings: AdamW + polynomial decay with linear warmup.

    ``set_to_dataset`` derives the step counts from the training dataset's
    length.
    """

    init_lr: float = 1e-2
    end_lr: float | None = None
    end_lr_frac_of_init_lr: float | None = 1e-3
    max_epochs: int = 100
    batch_size: int = 32
    validation_batch_size: int = 32
    lr_frac_warmup_steps: float | None = 0.01
    lr_num_warmup_steps: int | None = None
    max_training_steps: int | None = None
    lr_decay_power: float = 1.0
    weight_decay: float = 0.01
    patience: int | None = None
    gradient_accumulation: int | None = None
    num_dataloader_workers: int = 0

    def __post_init__(self):
        if self.end_lr_frac_of_init_lr is not None:
            if self.end_lr_frac_of_init_lr <= 0.0 or self.end_lr_frac_of_init_lr >= 1.0:
                raise ValueError("`end_lr_frac_of_init_lr` must be between 0.0 and 1.0!")
            if self.end_lr is not None:
                prod = self.end_lr_frac_of_init_lr * self.init_lr
                if not math.isclose(self.end_lr, prod):
                    raise ValueError(
                        "If both set, `end_lr` must be equal to `end_lr_frac_of_init_lr * init_lr`! Got "
                        f"end_lr={self.end_lr}, end_lr_frac_of_init_lr * init_lr = {prod}!"
                    )
            self.end_lr = self.end_lr_frac_of_init_lr * self.init_lr
        else:
            if self.end_lr is None:
                raise ValueError("Must set either end_lr or end_lr_frac_of_init_lr!")
            self.end_lr_frac_of_init_lr = self.end_lr / self.init_lr

    def set_to_dataset(self, dataset, steps_per_epoch: int | None = None) -> None:
        """Derives ``max_training_steps`` and the warmup steps from the
        training dataset (``ceil(len(dataset) / batch_size)`` steps an epoch)
        or from ``steps_per_epoch`` (the packed stream's count)."""
        if steps_per_epoch is None:
            steps_per_epoch = int(math.ceil(len(dataset) / self.batch_size))
        if self.max_training_steps is None:
            self.max_training_steps = steps_per_epoch * self.max_epochs
        if self.lr_num_warmup_steps is None:
            if self.lr_frac_warmup_steps is None:
                raise ValueError("set lr_frac_warmup_steps or lr_num_warmup_steps")
            self.lr_num_warmup_steps = int(round(self.lr_frac_warmup_steps * self.max_training_steps))
        elif self.lr_frac_warmup_steps is None:
            self.lr_frac_warmup_steps = self.lr_num_warmup_steps / self.max_training_steps
        if not (
            math.floor(self.lr_frac_warmup_steps * self.max_training_steps) <= self.lr_num_warmup_steps
            <= math.ceil(self.lr_frac_warmup_steps * self.max_training_steps)
        ):
            raise ValueError(
                "`self.lr_frac_warmup_steps`, `self.max_training_steps`, and `self.lr_num_warmup_steps` "
                "should be consistent, but they aren't! Got\n"
                f"\tself.max_training_steps = {self.max_training_steps}\n"
                f"\tself.lr_frac_warmup_steps = {self.lr_frac_warmup_steps}\n"
                f"\tself.lr_num_warmup_steps = {self.lr_num_warmup_steps}"
            )
