"""Per-measurement generative metrics, gated by ``MetricsConfig``.

Counterpart: ``eventstreamgpt_tpu/training/generative_metrics.py``. One
accumulator per measurement, modality, metric and averaging that the config
admits on the split; `GenerativeMetrics.update` reads one
``GenerativeSequenceModelOutput`` as JAX's does (the sampled TTE and
regression metrics draw from the predicted distributions, the
classification metrics read the logits at observed events, indexed
regression is scored as its dense expansion over the vocabulary,
`training.metrics`' ``update_indexed``); ``compute`` gives
``{split}_{measurement}_{metric}`` values. The accumulators of one
measurement and modality that keep the same state (the AUROC and AUPRC
curves, each metric at each averaging) are fed once a batch, and
``compute`` hands the fed state to the rest: at 3,500 labels that is the
bulk of a validation pass.

Draws come from an explicit ``torch.Generator`` (JAX's come from a threefry
key), so the sampled metrics are reproducible from a seed but are not JAX's
numbers; the loss parts and the classification metrics are.

Losses are tracked per subject: a batch's component losses average over its
subjects, the fill rows of a last short batch contributing zeros, so the TTE
part is re-weighted by ``batch_size / n_valid`` and the total rebuilt from
the parts on such a batch.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..data.types import DataModality
from ..models.config import Averaging, MetricCategories, Metrics, MetricsConfig, Split, StructuredTransformerConfig
from .metrics import (
    ExplainedVariance,
    MeanMetric,
    MeanSquaredError,
    MeanSquaredLogError,
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassAveragePrecision,
    MultilabelAccuracy,
    MultilabelAUROC,
    MultilabelAveragePrecision,
)

CLASSIFICATION_MODALITIES = {DataModality.SINGLE_LABEL_CLASSIFICATION, DataModality.MULTI_LABEL_CLASSIFICATION}
# Each AUPRC class subclasses its AUROC class: both count the same binned curve.
_CURVES = (MulticlassAUROC, MultilabelAUROC)
_READ_BY_COMPUTE = ("average", "multioutput")


def _state_kind(acc) -> type:
    """Accumulators of one measurement and modality with one kind keep the
    same state from the same updates: their averaging is read only by
    ``compute``."""
    return next((c for c in _CURVES if isinstance(acc, c)), type(acc))


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _zoo(task_type: str, vocab_size: int, n_thresh: int) -> tuple[str, dict]:
    """``(category, {metric: (factory(averaging), averagings)})`` of a modality."""
    if task_type == DataModality.SINGLE_LABEL_CLASSIFICATION:
        return MetricCategories.CLASSIFICATION, {
            Metrics.ACCURACY: (
                lambda avg: MulticlassAccuracy(vocab_size, average=avg, ignore_index=0),
                [Averaging.MACRO, Averaging.WEIGHTED, Averaging.MICRO],
            ),
            Metrics.AUROC: (
                lambda avg: MulticlassAUROC(vocab_size, thresholds=n_thresh, average=avg, ignore_index=0),
                [Averaging.MACRO, Averaging.WEIGHTED],
            ),
            Metrics.AUPRC: (
                lambda avg: MulticlassAveragePrecision(vocab_size, thresholds=n_thresh, average=avg, ignore_index=0),
                [Averaging.MACRO, Averaging.WEIGHTED],
            ),
        }
    if task_type == DataModality.MULTI_LABEL_CLASSIFICATION:
        every = [Averaging.MACRO, Averaging.WEIGHTED, Averaging.MICRO]
        return MetricCategories.CLASSIFICATION, {
            Metrics.ACCURACY: (lambda avg: MultilabelAccuracy(vocab_size, average=avg), every),
            Metrics.AUROC: (lambda avg: MultilabelAUROC(vocab_size, thresholds=n_thresh, average=avg), every),
            Metrics.AUPRC: (
                lambda avg: MultilabelAveragePrecision(vocab_size, thresholds=n_thresh, average=avg),
                every,
            ),
        }
    if task_type == DataModality.UNIVARIATE_REGRESSION:
        return MetricCategories.REGRESSION, {
            Metrics.MSE: (lambda avg: MeanSquaredError(), [None]),
            Metrics.EXPLAINED_VARIANCE: (lambda avg: ExplainedVariance(), [None]),
        }
    if task_type == DataModality.MULTIVARIATE_REGRESSION:
        return MetricCategories.REGRESSION, {
            Metrics.MSE: (lambda avg: MeanSquaredError(), [None]),
            Metrics.EXPLAINED_VARIANCE: (
                lambda avg: ExplainedVariance(
                    multioutput="uniform_average" if avg == Averaging.MACRO else "variance_weighted"
                ),
                [Averaging.MACRO, Averaging.WEIGHTED],
            ),
        }
    raise ValueError(f"Unrecognized modality {task_type}!")


class GenerativeMetrics:
    """Accumulates the loss and the quality metrics of one split's evaluation."""

    def __init__(
        self, config: StructuredTransformerConfig, metrics_config: MetricsConfig, split: str = Split.TUNING
    ):
        self.config = config
        self.metrics_config = metrics_config
        self.split = split
        self.loss = MeanMetric()
        self.loss_parts: dict[str, MeanMetric] = {}
        n_thresh = metrics_config.n_auc_thresholds or 50

        self.tte_metrics: dict[str, Any] = {}
        if metrics_config.do_log(split, MetricCategories.TTE):
            for name, m in (("MSE", MeanSquaredError), ("MSLE", MeanSquaredLogError),
                            ("explained_variance", ExplainedVariance)):  # fmt: skip
                if metrics_config.do_log(split, MetricCategories.TTE, name):
                    self.tte_metrics[name] = m()

        self.metrics: dict[str, dict[str, dict[str, Any]]] = {}
        # (measurement, modality) -> {state kind: the accumulator `update` feeds}
        self._fed: dict[tuple[str, str], dict[type, Any]] = {}
        for task_type, measurements in config.measurements_per_generative_mode.items():
            for measurement in measurements:
                vocab_size = config.vocab_sizes_by_measurement.get(measurement, 1)
                per_meas = self.metrics.setdefault(measurement, {}).setdefault(task_type, {})
                cat, zoo = _zoo(task_type, vocab_size, n_thresh)
                for metric, (factory, averagings) in zoo.items():
                    for averaging in averagings:
                        metric_name = str(metric) if averaging is None else f"{averaging}_{metric}"
                        if metrics_config.do_log(split, cat, metric_name):
                            per_meas[metric_name] = factory(averaging)
                fed = self._fed[(measurement, task_type)] = {}
                for acc in per_meas.values():
                    fed.setdefault(_state_kind(acc), acc)

    @staticmethod
    def sample(dist, generator: torch.Generator | None) -> np.ndarray:
        """One draw of ``dist`` (the sampled metrics' only randomness)."""
        return _np(dist.sample(generator))

    def update(self, out, generator: torch.Generator | None = None, n_valid: int | None = None) -> None:
        """Accumulates one batch's output.

        ``n_valid`` counts the batch's real subjects (``valid_mask.sum()``);
        ``generator`` draws the TTE and regression samples and is needed
        only when those categories are on."""
        mc, split = self.metrics_config, self.split
        event_mask = _np(out.event_mask).astype(bool)
        B = event_mask.shape[0]
        n_valid = B if n_valid is None else n_valid

        tte_scale = B / max(n_valid, 1)
        parts: dict[str, float] = {}
        if out.losses is not None:
            if out.losses.classification:
                parts.update({f"{k}_cls_NLL": float(v) for k, v in out.losses.classification.items()})
            if out.losses.regression:
                parts.update({f"{k}_reg_NLL": float(v) for k, v in out.losses.regression.items()})
            if out.losses.time_to_event is not None:
                parts["TTE_reg_NLL"] = float(out.losses.time_to_event) * tte_scale
        if out.loss is not None:
            loss_val = float(out.loss) if n_valid == B or not parts else sum(parts.values())
            self.loss.update(loss_val, weight=n_valid)
        if mc.do_log(split, MetricCategories.LOSS_PARTS):
            for name, v in parts.items():
                self.loss_parts.setdefault(name, MeanMetric()).update(v, weight=n_valid)
        if mc.do_log_only_loss(split):
            return

        if self.tte_metrics and out.preds is not None and out.preds.time_to_event is not None:
            tte_preds = self.sample(out.preds.time_to_event, generator)
            sel = event_mask[:, 1:]
            tte_preds = tte_preds[:, :-1][sel]
            tte_labels = _np(out.labels.time_to_event)[sel]
            for acc in self.tte_metrics.values():
                acc.update(tte_preds, tte_labels)

        values_mask = _np(out.dynamic_values_mask).astype(bool) if out.dynamic_values_mask is not None else None
        for measurement, by_task in self.metrics.items():
            mask = event_mask
            if not mask.any():
                continue
            for task_type, metric_dict in by_task.items():
                if not metric_dict:
                    continue
                fed = self._fed[(measurement, task_type)].values()
                if task_type in CLASSIFICATION_MODALITIES:
                    _, sample_dist = out.preds.classification[measurement]
                    preds = _np(sample_dist.logits)[mask]
                    labels = _np(out.labels.classification[measurement])[mask]
                    for acc in fed:
                        acc.update(preds, labels.astype(np.int64) if labels.ndim == 1 else labels)
                elif task_type == DataModality.MULTIVARIATE_REGRESSION:
                    vocab_size = self.config.vocab_sizes_by_measurement[measurement]
                    _, dist = out.preds.regression[measurement]
                    preds = self.sample(dist, generator)[mask]
                    labels = _np(out.labels.regression[measurement])[mask]
                    preds_indices = _np(out.preds.regression_indices[measurement])[mask]
                    labels_indices = _np(out.labels.regression_indices[measurement])[mask]
                    el = values_mask[mask]
                    # The dense (rows, vocabulary) planes JAX expands these into, without building them.
                    for acc in fed:
                        acc.update_indexed(preds[el], preds_indices[el], labels[el], labels_indices[el], vocab_size)
                elif task_type == DataModality.UNIVARIATE_REGRESSION:
                    _, dist = out.preds.regression[measurement]
                    preds = self.sample(dist, generator)[mask]
                    labels = _np(out.labels.regression[measurement])[mask]
                    for acc in fed:
                        acc.update(preds, labels)

    def compute(self) -> dict[str, float]:
        """``{split}_...`` metric values, NaNs dropped."""
        split = self.split
        result = {f"{split}_loss": self.loss.compute()}
        for name, acc in self.loss_parts.items():
            result[f"{split}_{name}"] = acc.compute()
        for name, acc in self.tte_metrics.items():
            result[f"{split}_TTE_{name}"] = acc.compute()
        for measurement, by_task in self.metrics.items():
            for task_type, metric_dict in by_task.items():
                fed = self._fed[(measurement, task_type)]
                for metric_name, acc in metric_dict.items():
                    owner = fed[_state_kind(acc)]
                    if acc is not owner:  # the fed accumulator's state, this one's averaging
                        vars(acc).update({k: v for k, v in vars(owner).items() if k not in _READ_BY_COMPUTE})
                    result[f"{split}_{measurement}_{metric_name}"] = acc.compute()
        return {k: v for k, v in result.items() if not (isinstance(v, float) and np.isnan(v))}
