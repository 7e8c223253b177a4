"""The converted DL cache: the parquet DL representation as numpy arrays.

Counterpart: the parquet read of ``eventstreamgpt_tpu/data/jax_dataset.py``
(``_read_dl_reps``). The JAX dataset reads ``DL_reps/{split}_{k}.parquet``
with pandas; the card's machine has neither pandas nor pyarrow, so the port
reads a converted copy of the cache that numpy alone can load.

Layout of a converted cache (``convert_dl_cache`` writes it; so does
`data.synthetic.write_synthetic_cache`)::

    vocabulary_config.json              copied unchanged
    inferred_measurement_configs.json   copied unchanged
    inferred_measurement_metadata/      the metadata files the configs name
    DL_reps/{split}_{k}.npz             one archive a parquet chunk
    task_dfs/{name}.npz                 one archive a task dataframe
    task_dfs/{name}_labeler.py          its zero-shot labeler, importing the port

Each archive holds every column of its chunk as flat values plus offsets:

* a scalar column (``subject_id``) is one array, a row each;
* ``start_time`` is int64 nanoseconds since the epoch;
* a list column ``c`` (``time``, ``static_indices``, ...) is ``c`` (the
  values, flat) and ``c__offsets`` (``n_rows + 1``);
* a list-of-lists column (``dynamic_indices``, ...) adds ``c__offsets2``
  (one entry an inner list, plus one) and, when any inner list was null,
  ``c__nulls2`` (a bool an inner list).

A task archive holds ``subject_id``, ``start_time`` and ``end_time`` (int64
ns) and the label columns, a row a task window. Values keep the parquet's
types: ``dynamic_indices`` stay the floats the reference cache writes, null
values inside a float list are NaN, a string column is a numpy ``str``
array. Reading
(`read_dl_cache`) concatenates a split's chunks in the numeric order of
their suffix and needs numpy only; only `convert_dl_cache`'s body imports
pyarrow.

Generated trajectories (`evaluation.generate_trajectories`) are written in
the same format, one archive a sample (`write_dl_reps` of
`data.types.EventStreamBatch.convert_to_DL`), and read back with
`read_dl_reps`; `dl_reps_to_parquet` exports such an archive, on a host
with pyarrow, as the parquet frame the JAX package writes.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np

__all__ = [
    "DLReps",
    "RaggedColumn",
    "concat_dl_reps",
    "concat_ranges",
    "convert_dl_cache",
    "dl_reps_to_parquet",
    "lengths_to_offsets",
    "port_labeler_source",
    "read_dl_cache",
    "read_dl_reps",
    "read_task_df",
    "write_dl_reps",
]

# The one module of the JAX package a zero-shot labeler may import, and its port.
_LABELER_MODULE = "eventstreamgpt_tpu.models.zero_shot_labeler"
_PORT_LABELER_MODULE = "eventstreamgpt_tpu_torch.models.zero_shot_labeler"

# Parquet's pandas index column, which the cache does not need.
_SKIP = {"__index_level_0__"}


@dataclasses.dataclass
class RaggedColumn:
    """A list (``offsets2`` None) or list-of-lists column of a split.

    Row ``i`` holds ``values`` positions ``offsets[i]:offsets[i + 1]`` (a
    list column) or inner lists ``offsets[i]:offsets[i + 1]``, inner list
    ``j`` holding ``values[offsets2[j]:offsets2[j + 1]]``; ``nulls2[j]``
    marks a null inner list (None: none was null)."""

    values: np.ndarray
    offsets: np.ndarray
    offsets2: np.ndarray | None = None
    nulls2: np.ndarray | None = None

    def take(self, rows: np.ndarray) -> "RaggedColumn":
        """The column of the given rows, in that order."""
        rows = np.asarray(rows, np.int64)
        lengths = np.diff(self.offsets.astype(np.int64))[rows]
        return self.slice_rows(rows, np.zeros_like(lengths), lengths)

    def slice_rows(self, rows: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> "RaggedColumn":
        """Row ``i`` of the result is row ``rows[i]``'s elements (or inner
        lists) ``lo[i]:hi[i]``."""
        off = self.offsets.astype(np.int64)
        start = off[np.asarray(rows, np.int64)] + np.asarray(lo, np.int64)
        end = start + (np.asarray(hi, np.int64) - np.asarray(lo, np.int64))
        inner = concat_ranges(start, end)
        new_off = lengths_to_offsets(end - start)
        if self.offsets2 is None:
            return RaggedColumn(self.values[inner], new_off)
        off2 = self.offsets2.astype(np.int64)
        return RaggedColumn(
            self.values[concat_ranges(off2[inner], off2[inner + 1])],
            new_off,
            lengths_to_offsets(off2[inner + 1] - off2[inner]),
            None if self.nulls2 is None else self.nulls2[inner],
        )


# The column order of JAX's ``EventStreamBatch.convert_to_DL_DF`` frame: its list
# columns, then its scalar ones.
_FRAME_COLUMNS = ("time_delta", "time", "static_indices", "static_measurement_indices", "dynamic_indices",
                  "dynamic_measurement_indices", "dynamic_values", "start_time", "subject_id", "start_idx", "end_idx")


@dataclasses.dataclass
class DLReps:
    """A split's DL representation: ``scalars`` (``subject_id``,
    ``start_time`` in int64 ns, ...) and ``lists`` (`RaggedColumn`s), a row
    a subject."""

    scalars: dict
    lists: dict

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.scalars.values()))) if self.scalars else len(next(iter(self.lists.values())).offsets) - 1

    def take(self, rows: np.ndarray) -> "DLReps":
        rows = np.asarray(rows, np.int64)
        return DLReps({k: v[rows] for k, v in self.scalars.items()}, {k: c.take(rows) for k, c in self.lists.items()})

    def to_columns(self) -> dict:
        """The rows as JAX's ``convert_to_DL_DF`` frame holds them, without
        pandas: its columns in its order (`_FRAME_COLUMNS`, those present),
        each a list a row of Python numbers, lists or lists of lists, an
        unobserved ``dynamic_values`` entry (NaN) as None."""
        columns = {}
        for name in _FRAME_COLUMNS:
            if name in self.scalars:
                columns[name] = self.scalars[name].tolist()
            elif name in self.lists:
                col = self.lists[name]
                flat = col.values.tolist()
                if name == "dynamic_values":
                    flat = [None if v != v else v for v in flat]
                if col.offsets2 is not None:
                    flat = [flat[a:b] for a, b in zip(col.offsets2[:-1].tolist(), col.offsets2[1:].tolist())]
                columns[name] = [flat[a:b] for a, b in zip(col.offsets[:-1].tolist(), col.offsets[1:].tolist())]
        return columns


def lengths_to_offsets(lengths: np.ndarray) -> np.ndarray:
    """``n + 1`` int64 offsets of ``n`` consecutive runs of the given lengths.

    Examples:
        >>> lengths_to_offsets(np.array([2, 0, 3])).tolist()
        [0, 2, 2, 5]
    """
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out



def concat_ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The concatenation of ``arange(lo[i], hi[i])`` for every ``i``."""
    lengths = hi - lo
    starts = np.repeat(lo - lengths_to_offsets(lengths)[:-1], lengths)
    return starts + np.arange(int(lengths.sum()), dtype=np.int64)


def _chunk_key(fp: Path):
    """Chunks sort by their numeric suffix (``x_10`` after ``x_2``), as the
    JAX reader orders its parquet files."""
    stem, _, suffix = fp.stem.rpartition("_")
    return (stem, int(suffix)) if suffix.isdigit() else (fp.stem, -1)


def write_dl_reps(fp: Path | str, reps: DLReps) -> None:
    """Writes ``reps`` as one archive of the converted format."""
    arrays = dict(reps.scalars)
    for name, col in reps.lists.items():
        arrays[name] = col.values
        arrays[f"{name}__offsets"] = col.offsets
        if col.offsets2 is not None:
            arrays[f"{name}__offsets2"] = col.offsets2
        if col.nulls2 is not None:
            arrays[f"{name}__nulls2"] = col.nulls2
    Path(fp).parent.mkdir(parents=True, exist_ok=True)
    with open(fp, "wb") as f:
        np.savez(f, **arrays)


def read_dl_reps(fp: Path | str) -> DLReps:
    """One archive of the converted format (`write_dl_reps`' inverse)."""
    with np.load(fp, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    names = [k for k in arrays if "__" not in k]
    scalars, lists = {}, {}
    for name in names:
        if f"{name}__offsets" in arrays:
            lists[name] = RaggedColumn(
                arrays[name], arrays[f"{name}__offsets"], arrays.get(f"{name}__offsets2"), arrays.get(f"{name}__nulls2")
            )
        else:
            scalars[name] = arrays[name]
    return DLReps(scalars, lists)


def concat_dl_reps(parts: list[DLReps]) -> DLReps:
    """The rows of ``parts``, one after the other (the columns of the first)."""
    if len(parts) == 1:
        return parts[0]
    scalars = {k: np.concatenate([p.scalars[k] for p in parts]) for k in parts[0].scalars}
    lists = {}
    for k, first in parts[0].lists.items():
        cols = [p.lists[k] for p in parts]
        inner = first.offsets2 is not None
        off, off2, shift, shift2 = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)], 0, 0
        for c in cols:
            off.append(c.offsets[1:].astype(np.int64) + shift)
            shift += int(c.offsets[-1])
            if inner:
                off2.append(c.offsets2[1:].astype(np.int64) + shift2)
                shift2 += int(c.offsets2[-1])
        nulls = None
        if inner and any(c.nulls2 is not None for c in cols):
            nulls = np.concatenate(
                [c.nulls2 if c.nulls2 is not None else np.zeros(len(c.offsets2) - 1, bool) for c in cols]
            )
        lists[k] = RaggedColumn(
            np.concatenate([c.values for c in cols]),
            np.concatenate(off),
            np.concatenate(off2) if inner else None,
            nulls,
        )
    return DLReps(scalars, lists)


def read_dl_cache(save_dir: Path | str, split: str) -> DLReps:
    """The split's rows of a converted cache, its chunks in numeric order."""
    dl_dir = Path(save_dir) / "DL_reps"
    files = sorted(dl_dir.glob(f"{split}*.npz"), key=_chunk_key)
    if not files:
        raise FileNotFoundError(
            f"No converted DL_reps chunks for split {split} in {dl_dir} (convert a parquet cache with "
            "data.dl_cache.convert_dl_cache on a host with pandas)"
        )
    return concat_dl_reps([read_dl_reps(fp) for fp in files])


def read_task_df(save_dir: Path | str, task_df_name: str) -> dict:
    """The columns of a converted task dataframe (``task_dfs/{name}.npz``)."""
    fp = Path(save_dir) / "task_dfs" / f"{task_df_name}.npz"
    if not fp.is_file():
        raise FileNotFoundError(
            f"{fp} does not exist, but config.task_df_name = {task_df_name}! (convert the parquet cache with "
            "data.dl_cache.convert_dl_cache on a host with pandas)"
        )
    with np.load(fp, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def port_labeler_source(source: str, name: str = "<labeler>") -> str:
    """A zero-shot labeler's source with its import of the JAX package's
    ``models.zero_shot_labeler`` rewritten to the port's. Raises
    ``ValueError`` if it imports anything else of the JAX package."""
    import ast

    lines = source.splitlines(keepends=True)
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            modules = [node.module or ""]
        elif isinstance(node, ast.Import):
            modules = [a.name for a in node.names]
        else:
            continue
        for module in modules:
            if module.split(".")[0] != "eventstreamgpt_tpu":
                continue
            if module != _LABELER_MODULE:
                raise ValueError(
                    f"{name} imports {module} from the JAX package; a labeler the port loads may import only "
                    f"{_LABELER_MODULE} (rewritten to {_PORT_LABELER_MODULE})"
                )
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = lines[i].replace(_LABELER_MODULE, _PORT_LABELER_MODULE)
    return "".join(lines)


def dl_reps_to_parquet(reps: DLReps, fp: Path | str) -> Path:
    """Writes ``reps`` (`data.types.EventStreamBatch.convert_to_DL` rows) as
    the parquet file the JAX package writes of ``convert_to_DL_DF``'s frame
    (`DLReps.to_columns`). Runs where pyarrow is installed (imported here,
    lazily); returns ``fp``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    fp = Path(fp)
    fp.parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(pa.table(reps.to_columns()), fp)
    return fp


def _metadata_files(src: Path) -> list[Path]:
    """The metadata files ``inferred_measurement_configs.json`` names, as
    the dataset resolves them."""
    from .config import MeasurementConfig

    fp = src / "inferred_measurement_configs.json"
    if not fp.exists():
        return []
    out = []
    for v in json.loads(fp.read_text()).values():
        mm = MeasurementConfig.from_dict(v, base_dir=src)._measurement_metadata
        if isinstance(mm, Path) and mm.is_file():
            out.append(mm)
    return out


def _arrow_list(col):
    """``(values, offsets, nulls)`` of an arrow list array, honouring slices and null lists."""
    import pyarrow.compute as pc

    lengths = pc.fill_null(pc.list_value_length(col), 0).to_numpy(zero_copy_only=False).astype(np.int64)
    nulls = col.is_null().to_numpy(zero_copy_only=False).astype(bool)
    return col.flatten(), lengths_to_offsets(lengths), nulls


def _encode_table(table) -> DLReps:
    import pyarrow as pa

    scalars, lists = {}, {}
    for name in table.column_names:
        if name in _SKIP:
            continue
        col = table.column(name).combine_chunks()
        if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            values, offsets, _ = _arrow_list(col)
            offsets2 = nulls2 = None
            if pa.types.is_list(values.type) or pa.types.is_large_list(values.type):
                values, offsets2, nulls = _arrow_list(values)
                nulls2 = nulls if nulls.any() else None
            lists[name] = RaggedColumn(values.to_numpy(zero_copy_only=False), offsets, offsets2, nulls2)
        elif pa.types.is_timestamp(col.type):
            scalars[name] = col.cast(pa.timestamp("ns")).cast(pa.int64()).to_numpy(zero_copy_only=False)
        else:
            values = col.to_numpy(zero_copy_only=False)
            scalars[name] = values.astype(str) if values.dtype == object else values
    return DLReps(scalars, lists)


def convert_dl_cache(src: Path | str, dst: Path | str) -> Path:
    """Converts the parquet DL cache under ``src`` into the numpy format
    under ``dst`` (the module docstring); returns ``dst``.

    Runs where pyarrow is installed (it is imported here, and nowhere else in
    the port). Copies ``vocabulary_config.json``,
    ``inferred_measurement_configs.json`` and the metadata files the latter
    names (into ``dst/inferred_measurement_metadata``), writes one
    ``DL_reps/{stem}.npz`` for every ``DL_reps/{stem}.parquet`` and one
    ``task_dfs/{name}.npz`` for every ``task_dfs/{name}.parquet``, and copies
    each ``task_dfs/{name}_labeler.py`` through `port_labeler_source`."""
    import pyarrow.parquet as pq

    src, dst = Path(src), Path(dst)
    (dst / "DL_reps").mkdir(parents=True, exist_ok=True)
    for name in ("vocabulary_config.json", "inferred_measurement_configs.json"):
        if (src / name).exists():
            shutil.copy2(src / name, dst / name)
    for fp in _metadata_files(src):
        (dst / "inferred_measurement_metadata").mkdir(exist_ok=True)
        shutil.copy2(fp, dst / "inferred_measurement_metadata" / fp.name)
    files = sorted((src / "DL_reps").glob("*.parquet"), key=_chunk_key)
    if not files:
        raise FileNotFoundError(f"No DL_reps parquet files in {src / 'DL_reps'}")
    for fp in files:
        write_dl_reps(dst / "DL_reps" / f"{fp.stem}.npz", _encode_table(pq.read_table(fp)))
    for fp in sorted((src / "task_dfs").glob("*.parquet")):
        write_dl_reps(dst / "task_dfs" / f"{fp.stem}.npz", _encode_table(pq.read_table(fp)))
    for fp in sorted((src / "task_dfs").glob("*_labeler.py")):
        (dst / "task_dfs" / fp.name).write_text(port_labeler_source(fp.read_text(), str(fp)))
    return dst
