"""Longitudinal, MCF-based evaluation over measurement predicates, without pandas.

Counterpart: ``eventstreamgpt_tpu/evaluation/mcf_evaluation.py``: the same
functions and arithmetic (float64, bit for bit), over column dicts where
JAX takes DataFrames. A *frame* here is a dict of columns of one length, a
row a subject: scalar columns (``subject_id``, ``align_time``,
``control_align_idx``) as sequences or numpy arrays, ragged columns
(``time``, ``pred_{i}``) as one list a subject and list-of-lists columns
(``dynamic_indices``, ``dynamic_values``, an unobserved value None) as one
list of lists a subject. `dl_frame` makes one from the converted format's
rows (`data.dl_cache.DLReps`, e.g. a generated trajectory file), with
``time`` the absolute event time (``start_time`` plus the row's ``time``).

`get_aligned_timestamps` takes an explicit numpy ``Generator`` or
``RandomState`` for its downsampling where JAX draws from numpy's global
state (``RandomState(s)`` gives JAX's draw after ``np.random.seed(s)``).
"""

from __future__ import annotations

import numpy as np

from ..data.dl_cache import DLReps

RANGE_T = tuple  # (lower, upper), each None | float | (float, inclusive_bool)

__all__ = [
    "align_time_and_eval_predicates",
    "crps",
    "dl_frame",
    "eval_range",
    "get_MCF",
    "get_MCF_coordinates",
    "get_aligned_timestamps",
]


def dl_frame(reps: DLReps, absolute_time: bool = True) -> dict:
    """The frame of ``reps``' rows (`data.dl_cache.DLReps.to_columns`). Rows
    without a ``time`` column get it from ``time_delta``: event ``i`` at the
    float64 sum of the deltas before it. With ``absolute_time`` each row's
    times are offset by its ``start_time`` (minutes), so that a generated
    sample and its prompt align on one clock."""
    frame = reps.to_columns()
    if "time" not in frame:
        frame["time"] = [np.concatenate([[0.0], np.cumsum(np.asarray(row, np.float64))[:-1]]).tolist() if row else []
                         for row in frame["time_delta"]]  # fmt: skip
    if absolute_time and "start_time" in frame:
        frame["time"] = [[float(start) + t for t in row] for start, row in zip(frame["start_time"], frame["time"])]
    return frame


def _n_rows(frame: dict) -> int:
    return len(next(iter(frame.values())))


def _take(frame: dict, order) -> dict:
    """The frame's rows in ``order`` (row indices)."""
    return {k: [v[i] for i in order] if isinstance(v, list) else np.asarray(v)[np.asarray(order, np.int64)]
            for k, v in frame.items()}  # fmt: skip


def _stable_order(subject_ids) -> np.ndarray:
    return np.argsort(np.asarray(subject_ids), kind="stable")


def crps(samples: np.ndarray, true: np.ndarray) -> np.ndarray:
    """The empirical Continuous Ranked Probability Score (JAX's `crps`):
    ``samples`` holds independent draws on axis 0; NaNs mark missing or
    censored draws and observations.

    Examples:
        >>> crps(np.array([[-2]]), np.array([0]))
        array([2])
        >>> crps(np.array([[-2], [np.nan], [np.nan], [1], [2]]), np.array([0]))
        array([0.77777778])
        >>> crps(np.array([[-2], [-1], [0], [1], [2]]), np.array([0]))
        array([0.4])
        >>> true = np.array([-2, 0, -2, np.nan])
        >>> samples = np.array([
        ...     [-1, 1,  -1,      -1],
        ...     [1, -2,   1,       1],
        ...     [2, -20,  np.nan,  2],
        ...     [0,  10,  0,       0],
        ...     [3,  1,   3,       3],
        ...     [1,  1,   1,       1]
        ... ])
        >>> crps(samples, true)
        array([2.27777778, 1.41666667, 2.08      ,        nan])
        >>> crps(np.array([-2, -1, 0, 1, 2]), true)
        Traceback (most recent call last):
            ...
        ValueError: The shape of true (4,) must match that of samples (5,) after the 1st dimension.
    """
    if true.shape != samples.shape[1:]:
        raise ValueError(
            f"The shape of true {true.shape} must match that of samples {samples.shape} after the 1st dimension."
        )

    if samples.shape[0] == 1:
        return np.abs(samples[0] - true)

    # CRPS(F, y) = E|X - y| - E|X - X'| / 2 for the empirical F; the pairwise
    # term over the gaps between consecutive order statistics (the gap above
    # rank k is crossed by k (n - k) of the n^2 ordered pairs). NaN draws sort
    # last, and ranks past the valid ones get k (n - k) <= 0 and drop out.
    n_valid = (~np.isnan(samples)).sum(0)
    ordered = np.sort(samples, axis=0)
    gaps = ordered[1:] - ordered[:-1]
    rank = np.arange(1, samples.shape[0]).reshape((-1,) + (1,) * true.ndim)
    pairs_crossing = rank * (n_valid - rank)
    spread = np.where(pairs_crossing > 0, gaps * pairs_crossing, 0.0).sum(0)
    mean_abs_err = np.nanmean(np.abs(true - samples), axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return mean_abs_err - spread / n_valid.astype(float) ** 2


def eval_range(rng: bool | RANGE_T, val: np.ndarray) -> np.ndarray:
    """True where ``val`` satisfies the range spec (JAX's `eval_range`):
    ``rng`` a bool (returned as it is) or ``(lower, upper)``, each bound None
    (unbounded), a number (exclusive) or ``(number, inclusive)``. NaN values
    never satisfy numeric bounds.

    Examples:
        >>> vals = np.array([0.1, 1.0, 3.0, np.nan])
        >>> eval_range(True, vals)
        array([ True,  True,  True,  True])
        >>> eval_range((1, 2), vals)
        array([False, False, False, False])
        >>> eval_range(((1, True), 2), vals)
        array([False,  True, False, False])
        >>> eval_range((None, 2), vals)
        array([ True,  True, False, False])
        >>> eval_range((1, None), vals)
        array([False, False,  True, False])
    """
    val = np.asarray(val, dtype=np.float64)
    if isinstance(rng, bool):
        return np.full(val.shape, rng)

    lower_bound, upper_bound = rng
    with np.errstate(invalid="ignore"):
        out = np.ones(val.shape, dtype=bool)
        if lower_bound is not None:
            if isinstance(lower_bound, tuple):
                bound, incl = lower_bound
                out &= (val >= bound) if incl else (val > bound)
            else:
                out &= val > lower_bound
        if upper_bound is not None:
            if isinstance(upper_bound, tuple):
                bound, incl = upper_bound
                out &= (val <= bound) if incl else (val < bound)
            else:
                out &= val < upper_bound
        out &= ~np.isnan(val)
    if lower_bound is None and upper_bound is None:
        return np.full(val.shape, True)
    return out


def align_time_and_eval_predicates(frame: dict, measurement_predicates: dict[int, bool | RANGE_T]) -> dict:
    """Re-zeroes each row's times at its ``align_time`` and evaluates the
    predicates per event (JAX's `align_time_and_eval_predicates`). ``frame``
    holds ``subject_id``, ``time``, ``dynamic_indices``, ``dynamic_values``
    and ``align_time``. Returns a frame a row a subject, sorted by subject
    (stable): ``subject_id``, ``time`` (the distinct aligned times, sorted)
    and ``pred_{idx}`` (a bool a time: any observation at it satisfies the
    predicate)."""
    records = {"subject_id": [], "time": [], **{f"pred_{idx}": [] for idx in measurement_predicates}}
    for i in range(_n_rows(frame)):
        align = float(frame["align_time"][i])
        per_time: dict[float, dict[int, bool]] = {}
        for t, idxs, vals in zip(frame["time"][i], frame["dynamic_indices"][i], frame["dynamic_values"][i]):
            t = float(t) - align
            slot = per_time.setdefault(t, {k: False for k in measurement_predicates})
            idxs = np.asarray(list(idxs), dtype=np.int64) if len(list(idxs)) else np.zeros(0, np.int64)
            vals_arr = (
                np.asarray([np.nan if v is None else float(v) for v in vals], dtype=np.float64)
                if len(list(vals))
                else np.zeros(0, np.float64)
            )
            for pred_idx, rng in measurement_predicates.items():
                hit = (idxs == pred_idx) & eval_range(rng, vals_arr)
                slot[pred_idx] = slot[pred_idx] or bool(hit.any())
        times = sorted(per_time)
        records["subject_id"].append(frame["subject_id"][i])
        records["time"].append(times)
        for idx in measurement_predicates:
            records[f"pred_{idx}"].append([per_time[t][idx] for t in times])
    return _take(records, _stable_order(records["subject_id"])) if records["subject_id"] else records


def get_aligned_timestamps(control_T, *sample_Ts, n_timestamps: int | None = None, rng=None) -> list[float]:
    """The union of all observed (aligned) times, sorted; downsampled to
    ``n_timestamps`` without replacement by ``rng`` (a numpy ``Generator``
    or ``RandomState``, required then) when there are more (JAX's
    `get_aligned_timestamps`). Inputs are iterables of a time list a
    subject (None entries skipped)."""

    def get_Ts(series) -> set:
        out = set()
        for row in series:
            if row is None:
                continue
            out.update(float(t) for t in row)
        return out

    all_Ts = get_Ts(control_T)
    for T in sample_Ts:
        all_Ts |= get_Ts(T)
    all_Ts = list(all_Ts)
    if n_timestamps is not None and len(all_Ts) > n_timestamps:
        if rng is None:
            raise ValueError("get_aligned_timestamps downsamples with an explicit rng (numpy Generator or RandomState)")
        all_Ts = list(rng.choice(all_Ts, size=n_timestamps, replace=False))
    return sorted(all_Ts)


def get_MCF(aligned_Ts: list[float], MCF_cols: list[str], *frames: dict) -> tuple[np.ndarray, np.ndarray]:
    """The population's censor masks and cumulative predicate incidences (JAX's `get_MCF`):

    1. bool ``(len(frames), n_subjects, len(aligned_Ts) + 1)``: the subject
       has data at or after each aligned time (the first column always True);
    2. float ``(len(frames), n_subjects, len(aligned_Ts) + 1, len(MCF_cols))``:
       new predicate incidences a bucket between timestamps; NaN where the
       subject has no event in a bucket that other subjects populate, 0 in
       a bucket no subject populates.
    """
    n_buckets = len(aligned_Ts) + 1
    censor_slices, MCF_slices = [], []
    for frame in frames:
        frame = _take(frame, _stable_order(frame["subject_id"]))
        n_subj = _n_rows(frame)
        max_time = np.asarray([max(row) if len(row) else -np.inf for row in frame["time"]])
        censor = np.concatenate(
            [np.ones((n_subj, 1), dtype=bool), max_time[:, None] >= np.asarray(aligned_Ts)[None, :]], axis=1
        )
        censor_slices.append(censor)

        # Buckets: the searchsorted of each event time into aligned_Ts; bucket
        # j collects the events in (aligned_Ts[j - 1], aligned_Ts[j]].
        per_col = np.full((n_subj, n_buckets, len(MCF_cols)), np.nan)
        buckets_populated = np.zeros((n_subj, n_buckets), dtype=bool)
        all_populated = np.zeros(n_buckets, dtype=bool)
        for i in range(n_subj):
            times = np.asarray(frame["time"][i], dtype=np.float64)
            b = np.searchsorted(np.asarray(aligned_Ts), times, side="left")
            buckets_populated[i, b] = True
            all_populated[b] = True
            for k, col in enumerate(MCF_cols):
                flags = np.asarray(frame[col][i], dtype=np.float64)
                per_col[i, :, k] = np.bincount(b, weights=flags, minlength=n_buckets)
        for j in range(n_buckets):
            if not all_populated[j]:
                per_col[:, j, :] = 0.0
            else:
                per_col[~buckets_populated[:, j], j, :] = np.nan
        MCF_slices.append(per_col)

    return np.stack(censor_slices, axis=0), np.stack(MCF_slices, axis=0)


def get_MCF_coordinates(
    control_frame: dict,
    sample_frames: list[dict],
    measurement_predicates: dict[int, bool | RANGE_T],
    n_timestamps: int | None = None,
    rng=None,
):
    """Aligned per-subject MCF coordinates of the control against the
    samples (JAX's `get_MCF_coordinates`). ``control_frame`` holds
    ``control_align_idx`` (the index of the event that is time zero); the
    sample frames align at the control's time of the same subject.

    Returns ``(subject_ids, aligned_Ts, dynamic_indices, control_censor_mask,
    control_MCF, sample_censor_mask, sample_MCF)``.
    """
    control = dict(control_frame)
    control["align_time"] = [
        float(control["time"][i][int(control["control_align_idx"][i])]) for i in range(_n_rows(control))
    ]
    align_times = dict(zip(np.asarray(control["subject_id"]).tolist(), control["align_time"]))

    aligned_samples = []
    for frame in sample_frames:
        ids = np.asarray(frame["subject_id"]).tolist()
        joined = _take(frame, [i for i, s in enumerate(ids) if s in align_times])
        joined["align_time"] = [align_times[s] for s in np.asarray(joined["subject_id"]).tolist()]
        aligned_samples.append(align_time_and_eval_predicates(joined, measurement_predicates))

    control_aligned = align_time_and_eval_predicates(control, measurement_predicates)
    subject_ids = np.asarray(control_aligned["subject_id"]).tolist()

    aligned_timestamps = get_aligned_timestamps(
        control_aligned["time"], *[f["time"] for f in aligned_samples], n_timestamps=n_timestamps, rng=rng
    )

    dynamic_indices = list(measurement_predicates.keys())
    MCF_cols = [f"pred_{i}" for i in dynamic_indices]
    control_censor_mask, control_MCF = get_MCF(aligned_timestamps, MCF_cols, control_aligned)
    sample_censor_mask, sample_MCF = get_MCF(aligned_timestamps, MCF_cols, *aligned_samples)

    return (
        subject_ids,
        aligned_timestamps,
        dynamic_indices,
        control_censor_mask,
        control_MCF,
        sample_censor_mask,
        sample_MCF,
    )
