"""Streaming metric accumulators, on the host in numpy.

Counterpart: ``eventstreamgpt_tpu/training/metrics.py``: the same state and
the same values, to the last bit on the same inputs. Two changes make a
vocabulary of thousands affordable: the binned curves count every series of
a batch at once (each value's threshold bin, one ``bincount``, a suffix
sum: the same integer counts JAX's per-series comparisons make; a
multilabel micro curve is the sum of the labels' counts, not a series of
its own), and `MeanSquaredError` / `ExplainedVariance` take indexed values
(``update_indexed``) without building the dense ``(rows, vocabulary)``
planes the indexed regression metrics are defined over (equal to the dense
update up to the order of float sums). AUROC and AUPRC are computed on a fixed threshold grid
(``MetricsConfig.n_auc_thresholds``), as the binned ``torchmetrics``
configuration computes them, so the memory stays bounded at cohort scale.

Averaging follows ``torchmetrics``:

* multiclass accuracy: per-class recall; ``macro`` averages the classes
  with support, ``micro`` and ``weighted`` collapse to overall correct / N;
* multilabel accuracy: per-label binary accuracy at a 0.5 threshold;
* AUROC: trapezoidal area under the binned (FPR, TPR) curve;
* AUPRC (average precision): the step-interpolated sum over the binned PR
  curve;
* explained variance: ``1 - Var[y - yhat] / Var[y]`` per output, combined
  by ``uniform_average`` or ``variance_weighted``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BinaryAccuracy",
    "BinaryAUROC",
    "BinaryAveragePrecision",
    "MeanMetric",
    "MulticlassAccuracy",
    "MultilabelAccuracy",
    "MulticlassAUROC",
    "MultilabelAUROC",
    "MulticlassAveragePrecision",
    "MultilabelAveragePrecision",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "ExplainedVariance",
]


class MeanMetric:
    """Weighted running mean (the ``self.log`` aggregation in the reference)."""

    def __init__(self):
        self.total = 0.0
        self.weight = 0.0

    def update(self, value: float, weight: float = 1.0) -> None:
        if not np.isfinite(value):
            return
        self.total += float(value) * float(weight)
        self.weight += float(weight)

    def compute(self) -> float:
        return self.total / self.weight if self.weight > 0 else float("nan")


def _as_probs_multiclass(preds: np.ndarray) -> np.ndarray:
    """Logits → probabilities if needed (torchmetrics auto-detection)."""
    if preds.size and (preds.min() < 0 or preds.max() > 1):
        z = preds - preds.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)
    return preds


def _as_probs_binary(preds: np.ndarray) -> np.ndarray:
    if preds.size and (preds.min() < 0 or preds.max() > 1):
        return 1.0 / (1.0 + np.exp(-preds))
    return preds


class MulticlassAccuracy:
    """Multiclass accuracy over ``(N, C)`` preds and ``(N,)`` int labels.

    ``macro`` = mean per-class recall over classes with support; ``micro`` and
    ``weighted`` = overall fraction correct (they coincide for accuracy).
    """

    def __init__(self, num_classes: int, average: str = "micro", ignore_index: int | None = None):
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.correct = np.zeros(num_classes, dtype=np.int64)
        self.support = np.zeros(num_classes, dtype=np.int64)

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        if preds.ndim == labels.ndim + 1:
            preds = preds.reshape(-1, preds.shape[-1]).argmax(axis=-1)
        else:
            preds = preds.reshape(-1)
        if self.ignore_index is not None:
            keep = labels != self.ignore_index
            preds, labels = preds[keep], labels[keep]
        if labels.size == 0:
            return
        self.support += np.bincount(labels, minlength=self.num_classes)
        hits = labels[preds == labels]
        self.correct += np.bincount(hits, minlength=self.num_classes)

    def compute(self) -> float:
        if self.average == "macro":
            has = self.support > 0
            if not has.any():
                return float("nan")
            return float((self.correct[has] / self.support[has]).mean())
        total = self.support.sum()
        return float(self.correct.sum() / total) if total else float("nan")


class MultilabelAccuracy:
    """Multilabel accuracy over ``(N, L)`` preds (logits or probs) and 0/1 labels."""

    def __init__(self, num_labels: int, average: str = "macro", threshold: float = 0.5):
        self.num_labels = num_labels
        self.average = average
        self.threshold = threshold
        self.correct = np.zeros(num_labels, dtype=np.int64)
        self.count = np.zeros(num_labels, dtype=np.int64)
        self.positives = np.zeros(num_labels, dtype=np.int64)

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = _as_probs_binary(np.asarray(preds, dtype=np.float64)).reshape(-1, self.num_labels)
        labels = np.asarray(labels).reshape(-1, self.num_labels) > 0.5
        hard = preds >= self.threshold
        self.correct += (hard == labels).sum(axis=0)
        self.count += labels.shape[0]
        self.positives += labels.sum(axis=0)

    def compute(self) -> float:
        if not self.count.any():
            return float("nan")
        per_label = self.correct / np.maximum(self.count, 1)
        if self.average == "micro":
            return float(self.correct.sum() / self.count.sum())
        if self.average == "weighted":
            w = self.positives.astype(np.float64)
            if w.sum() == 0:
                return float("nan")
            return float((per_label * w).sum() / w.sum())
        return float(per_label.mean())


def _auroc(tp: np.ndarray, fp: np.ndarray, pos: int, neg: int) -> float:
    """Trapezoidal area under one series' binned (FPR, TPR) curve."""
    if pos == 0 or neg == 0:
        return float("nan")
    tpr = tp / pos
    fpr = fp / neg
    # Thresholds ascend → rates descend; integrate over increasing FPR.
    order = np.argsort(fpr, kind="stable")
    return float(np.trapezoid(tpr[order], fpr[order]))


def _ap(tp: np.ndarray, fp: np.ndarray, pos: int) -> float:
    """Average precision of one series' binned PR curve."""
    if pos == 0:
        return float("nan")
    recall = tp / pos
    denom = tp + fp
    precision = np.where(denom > 0, tp / np.maximum(denom, 1), 1.0)
    # Thresholds ascending → recall descending. AP = Σ (R_t − R_{t+1})·P_t
    # with R after the last threshold pinned to 0.
    r = np.concatenate([recall, [0.0]])
    return float(np.sum((r[:-1] - r[1:]) * precision))


class _BinnedCurve:
    """Shared thresholded confusion state for AUROC / average precision.

    State per label/class: TP and FP counts at each threshold on a uniform
    [0, 1] grid, plus positive/negative totals — the same bounded-memory
    scheme ``torchmetrics`` uses when ``thresholds`` is an int.
    """

    def __init__(self, n_series: int, thresholds: int):
        self.n_series = n_series
        self.thresholds = np.linspace(0.0, 1.0, int(thresholds))
        self.tp = np.zeros((n_series, len(self.thresholds)), dtype=np.int64)
        self.fp = np.zeros((n_series, len(self.thresholds)), dtype=np.int64)
        self.pos = np.zeros(n_series, dtype=np.int64)
        self.neg = np.zeros(n_series, dtype=np.int64)

    def _update_block(self, s0: int, probs: np.ndarray, targets: np.ndarray, cells: int = 1 << 21) -> None:
        """Series ``s0 .. s0 + S`` from probs ``(M, S)`` and bool targets
        ``(M, S)``: a value is above threshold ``j`` (``p >= t_j``) exactly
        when more than ``j`` thresholds are ``<= p``, so each value's count of
        those (0 for NaN) histogrammed per series and suffix-summed gives the
        TP and FP counts at every threshold. Pieces of ``cells`` values."""
        M, S = probs.shape
        T = len(self.thresholds)
        cols = max(min(S, cells // max(M, 1)), 1)
        rows = max(cells // cols, 1)
        for c0 in range(0, S, cols):
            n = min(cols, S - c0)
            hist = np.zeros((2, n, T + 1), np.int64)  # [positives, negatives]
            for r0 in range(0, M, rows):
                p, t = probs[r0 : r0 + rows, c0 : c0 + n], targets[r0 : r0 + rows, c0 : c0 + n]
                idx = np.arange(n)[None, :] * (T + 1) + self._at_or_below(p) + (~t) * (n * (T + 1))
                hist += np.bincount(idx.reshape(-1), minlength=2 * n * (T + 1)).reshape(2, n, T + 1)
            for counts, hist in ((self.tp, hist[0]), (self.fp, hist[1])):
                counts[s0 + c0 : s0 + c0 + n] += np.cumsum(hist[:, ::-1], axis=1)[:, ::-1][:, 1:]
            self.pos[s0 + c0 : s0 + c0 + n] += targets[:, c0 : c0 + n].sum(axis=0)
            self.neg[s0 + c0 : s0 + c0 + n] += (~targets[:, c0 : c0 + n]).sum(axis=0)

    def _at_or_below(self, p: np.ndarray) -> np.ndarray:
        """How many thresholds are ``<= p`` (0 for NaN): the uniform grid's
        bin by ``floor``, then one exact comparison each way with the grid's
        own values."""
        t = self.thresholds
        T = len(t)
        nan = np.isnan(p)
        if nan.any():
            p = np.where(nan, -1.0, p)
        k = np.clip(np.floor(p * (T - 1)), -1, T - 1).astype(np.int64)  # the last threshold <= p, about
        k -= (k >= 0) & (t[np.maximum(k, 0)] > p)
        k += (k + 1 < T) & (t[np.minimum(k + 1, T - 1)] <= p)
        return k + 1

    def _auroc_series(self, s: int) -> float:
        return _auroc(self.tp[s], self.fp[s], self.pos[s], self.neg[s])

    def _ap_series(self, s: int) -> float:
        return _ap(self.tp[s], self.fp[s], self.pos[s])

    def _average(self, per_series: np.ndarray, average: str) -> float:
        valid = ~np.isnan(per_series)
        if not valid.any():
            return float("nan")
        if average == "weighted":
            w = self.pos.astype(np.float64)
            w[~valid] = 0.0
            if w.sum() == 0:
                return float("nan")
            return float(np.nansum(per_series * w) / w.sum())
        # macro
        return float(per_series[valid].mean())


class MulticlassAUROC(_BinnedCurve):
    """One-vs-rest binned AUROC over ``(N, C)`` preds, ``(N,)`` int labels."""

    def __init__(
        self,
        num_classes: int,
        thresholds: int = 50,
        average: str = "macro",
        ignore_index: int | None = None,
    ):
        super().__init__(num_classes, thresholds)
        self.average = average
        self.ignore_index = ignore_index

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds, dtype=np.float64).reshape(-1, self.n_series)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        if self.ignore_index is not None:
            keep = labels != self.ignore_index
            preds, labels = preds[keep], labels[keep]
        if labels.size == 0:
            return
        probs = _as_probs_multiclass(preds)
        self._update_block(0, probs, labels[:, None] == np.arange(self.n_series)[None, :])

    def compute(self) -> float:
        per = np.array([self._auroc_series(c) for c in range(self.n_series)])
        return self._average(per, self.average)


class MultilabelAUROC(_BinnedCurve):
    """Per-label binned AUROC over ``(N, L)`` preds and 0/1 labels. The
    micro curve (every value flattened into one series) is the sum of the
    labels' counts, so it is not counted apart."""

    def __init__(self, num_labels: int, thresholds: int = 50, average: str = "macro"):
        super().__init__(num_labels, thresholds)
        self.num_labels = num_labels
        self.average = average

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds, dtype=np.float64).reshape(-1, self.num_labels)
        labels = np.asarray(labels).reshape(-1, self.num_labels) > 0.5
        self._update_block(0, _as_probs_binary(preds), labels)

    def _micro(self) -> tuple:
        return self.tp.sum(axis=0), self.fp.sum(axis=0), self.pos.sum(), self.neg.sum()

    def compute(self) -> float:
        if self.average == "micro":
            return _auroc(*self._micro())
        return self._average(np.array([self._auroc_series(c) for c in range(self.num_labels)]), self.average)


class MulticlassAveragePrecision(MulticlassAUROC):
    def compute(self) -> float:
        per = np.array([self._ap_series(c) for c in range(self.n_series)])
        return self._average(per, self.average)


class MultilabelAveragePrecision(MultilabelAUROC):
    def compute(self) -> float:
        if self.average == "micro":
            tp, fp, pos, _ = self._micro()
            return _ap(tp, fp, pos)
        return self._average(np.array([self._ap_series(c) for c in range(self.num_labels)]), self.average)


class BinaryAccuracy:
    """Binary accuracy over ``(N,)`` preds (logits or probs) and 0/1 labels."""

    def __init__(self, threshold: float = 0.5):
        self.inner = MultilabelAccuracy(1, average="micro", threshold=threshold)

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        self.inner.update(np.asarray(preds).reshape(-1, 1), np.asarray(labels).reshape(-1, 1))

    def compute(self) -> float:
        return self.inner.compute()


class BinaryAUROC:
    """Binned AUROC over ``(N,)`` preds (logits or probs) and 0/1 labels."""

    def __init__(self, thresholds: int = 50):
        self.inner = MultilabelAUROC(1, thresholds=thresholds, average="macro")

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        self.inner.update(np.asarray(preds).reshape(-1, 1), np.asarray(labels).reshape(-1, 1))

    def compute(self) -> float:
        return self.inner.compute()


class BinaryAveragePrecision:
    """Binned average precision over ``(N,)`` preds and 0/1 labels."""

    def __init__(self, thresholds: int = 50):
        self.inner = MultilabelAveragePrecision(1, thresholds=thresholds, average="macro")

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        self.inner.update(np.asarray(preds).reshape(-1, 1), np.asarray(labels).reshape(-1, 1))

    def compute(self) -> float:
        return self.inner.compute()


class MeanSquaredError:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds, dtype=np.float64).reshape(-1)
        labels = np.asarray(labels, dtype=np.float64).reshape(-1)
        self.total += float(((preds - labels) ** 2).sum())
        self.count += preds.size

    def update_indexed(self, preds, preds_idx, labels, labels_idx, size: int) -> None:
        """The update of the dense ``(N, size)`` planes holding ``preds[i]``
        at column ``preds_idx[i]`` and ``labels[i]`` at ``labels_idx[i]`` (0
        elsewhere), without building them."""
        diff = _indexed_diff(preds, preds_idx, labels, labels_idx)
        self.total += float((diff**2).sum())
        self.count += len(np.asarray(preds).reshape(-1)) * size

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")


def _indexed_diff(preds, preds_idx, labels, labels_idx) -> np.ndarray:
    """``preds - labels`` of each row at its preds column, and ``-labels``
    where a row's label sits in another column (``(N,)`` or ``(N, 2)``)."""
    preds = np.asarray(preds, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    same = np.asarray(preds_idx).reshape(-1) == np.asarray(labels_idx).reshape(-1)
    if same.all():
        return preds - labels
    return np.concatenate([np.where(same, preds - labels, preds), -labels[~same]])


class MeanSquaredLogError:
    """mean((log1p(pred) − log1p(label))²); inputs must be ≥ −1."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds, dtype=np.float64).reshape(-1)
        labels = np.asarray(labels, dtype=np.float64).reshape(-1)
        with np.errstate(invalid="ignore"):
            err = np.log1p(np.maximum(preds, -1.0)) - np.log1p(np.maximum(labels, -1.0))
        self.total += float(np.nansum(err**2))
        self.count += preds.size

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")


class ExplainedVariance:
    """``1 − Var[y − ŷ]/Var[y]`` per output dim, then averaged.

    ``multioutput``: ``uniform_average`` (reference ``macro``) or
    ``variance_weighted`` (reference ``weighted``); scalar streams use a
    single output dim.
    """

    def __init__(self, multioutput: str = "uniform_average"):
        self.multioutput = multioutput
        self._n = None

    def _init_state(self, d: int) -> None:
        self._n = np.zeros(d)
        self._sum_y = np.zeros(d)
        self._sum_y2 = np.zeros(d)
        self._sum_e = np.zeros(d)
        self._sum_e2 = np.zeros(d)

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds, dtype=np.float64)
        labels = np.asarray(labels, dtype=np.float64)
        if preds.ndim <= 1:
            preds = preds.reshape(-1, 1)
            labels = labels.reshape(-1, 1)
        else:
            preds = preds.reshape(-1, preds.shape[-1])
            labels = labels.reshape(-1, labels.shape[-1])
        if self._n is None:
            self._init_state(preds.shape[-1])
        err = labels - preds
        self._n += preds.shape[0]
        self._sum_y += labels.sum(axis=0)
        self._sum_y2 += (labels**2).sum(axis=0)
        self._sum_e += err.sum(axis=0)
        self._sum_e2 += (err**2).sum(axis=0)

    def update_indexed(self, preds, preds_idx, labels, labels_idx, size: int) -> None:
        """`update` of the dense ``(N, size)`` planes (`MeanSquaredError.update_indexed`),
        per column by weighted ``bincount`` over the indices."""
        preds = np.asarray(preds, dtype=np.float64).reshape(-1)
        labels = np.asarray(labels, dtype=np.float64).reshape(-1)
        p_idx = np.asarray(preds_idx, dtype=np.int64).reshape(-1)
        l_idx = np.asarray(labels_idx, dtype=np.int64).reshape(-1)
        if self._n is None:
            self._init_state(size)

        def col(idx, w):
            return np.bincount(idx, weights=w, minlength=size)

        self._n += len(preds)
        self._sum_y += col(l_idx, labels)
        self._sum_y2 += col(l_idx, labels**2)
        # err = labels - preds: per row, +label at its label column and -pred at its pred column.
        same = p_idx == l_idx
        e_idx = np.concatenate([l_idx, p_idx[~same]])
        e_val = np.concatenate([np.where(same, labels - preds, labels), -preds[~same]])
        self._sum_e += col(e_idx, e_val)
        self._sum_e2 += col(e_idx, e_val**2)

    def compute(self) -> float:
        if self._n is None or not self._n.any():
            return float("nan")
        n = np.maximum(self._n, 1)
        var_y = self._sum_y2 / n - (self._sum_y / n) ** 2
        var_e = self._sum_e2 / n - (self._sum_e / n) ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            ev = 1.0 - var_e / var_y
        ev = np.where(var_y > 0, ev, 0.0)
        if self.multioutput == "variance_weighted":
            denom = var_y.sum()
            return float((ev * var_y).sum() / denom) if denom > 0 else float("nan")
        return float(ev.mean())
