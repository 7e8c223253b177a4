"""Zero-shot classification by generation ("generative prompting").

Counterpart: ``eventstreamgpt_tpu/training/zero_shot_evaluator.py``. For
each evaluation batch, generate ``num_samples`` continuations a subject with
the pretrained generative model, apply the task's `Labeler` to each, and
average the one-hot labels over the samples whose label the labeler could
determine into empirical class probabilities. Subjects whose samples were
all unpredictable are dropped; ``frac_unpredictable`` is kept a split.
`zero_shot_evaluation` bootstraps from a pretraining ``save_dir`` through
`FinetuneConfig`, imports ``task_dfs/{task}_labeler.py`` (class
``TaskLabeler``) from the converted data directory and writes
``zero_shot_{split}_metrics.json``.

Generation runs through the serving engine by default: CI models on the
paged copy-on-write cache, one `GenerationEngine.fork` a subject (its
history prefills once, its branches share the blocks); NA models on the
monolithic cache, one request a (subject, sample) row; ``use_engine=False``
runs cohort `generate()`. Randomness: batch ``b`` of a split draws from the
seed ``derive_request_seed(cfg.seed, b)``; expanded row ``i`` of a
monolithic engine from ``derive_request_seed(batch seed, i)`` (the seed
`generate()` gives its row ``i``); branch ``j`` of subject ``s`` of a fork
from ``derive_request_seed(derive_request_seed(batch seed, s), j)``, so a
fork equals the per-(subject, sample) requests with those seeds bit for
bit. JAX's ``fold_in`` keys are not reproduced; parity with JAX is greedy.

One card and no mesh: JAX's data-parallel mesh over the expanded batch
waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import ast
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ..data.device_dataset import DeviceDataset
from ..data.torch_dataset import TorchDataset
from ..data.types import EventStreamBatch
from ..generation import generate
from ..generation.sampling import derive_request_seed
from ..models.config import Split, StructuredEventProcessingMode, StructuredTransformerConfig
from ..models.zero_shot_labeler import Labeler
from ..utils.device import resolve_device
from .checkpoint import load_pretrained
from .fine_tuning import FinetuneConfig, StreamClassificationMetrics
from .pretrain import build_model


def import_class_from_file(module_path: Path | str, class_name: str):
    """The class ``class_name`` of the Python file at ``module_path`` (JAX's
    dynamic import). A file that imports the JAX package is refused: the
    port loads the labeler `data.dl_cache.convert_dl_cache` copied into the
    converted data directory, its import pointed at the port."""
    module_path = Path(module_path)
    for node in ast.walk(ast.parse(module_path.read_text())):
        names = [node.module or ""] if isinstance(node, ast.ImportFrom) else (
            [a.name for a in node.names] if isinstance(node, ast.Import) else [])  # fmt: skip
        if any(n.split(".")[0] == "eventstreamgpt_tpu" for n in names):
            raise ValueError(
                f"{module_path} imports the JAX package (eventstreamgpt_tpu); load the copy that "
                "data.dl_cache.convert_dl_cache writes into the converted data directory, which imports the port"
            )
    spec = importlib.util.spec_from_file_location(class_name, module_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, class_name)


def _aggregate_predictions(generated, batch, config: StructuredTransformerConfig, labeling_function: Labeler,
                           num_samples: int, return_generated: bool = False):  # fmt: skip
    """Labels a generated batch and averages the labels into empirical
    probabilities (JAX's shared tail of both generation paths). Returns
    ``(output, frac_unpredictable of the valid subjects)``: ``output.preds``
    and ``output.labels`` hold the subjects with a predictable sample."""
    B = batch.batch_size
    empirical_labels, labels_unpredicted = labeling_function(generated, input_seq_len=batch.sequence_length)

    num_labels = config.num_labels
    empirical_labels = np.asarray(empirical_labels, dtype=np.float64).reshape(B, num_samples, num_labels)
    labels_unpredicted = np.asarray(labels_unpredicted, dtype=bool).reshape(B, num_samples)

    weight = (~labels_unpredicted)[:, :, None].astype(np.float64)
    denom = weight.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        probs = np.where(denom > 0, (empirical_labels * weight).sum(axis=1) / denom, 0.0)
    frac_unpredictable = labels_unpredicted.mean(axis=1)

    predictable = frac_unpredictable != 1.0
    valid = None if batch.valid_mask is None else np.asarray(batch.valid_mask.cpu(), bool)
    if valid is not None:  # fill rows of a short last batch
        predictable = predictable & valid

    probs = probs[predictable]
    true_labels = np.asarray(batch.stream_labels[config.finetuning_task].cpu())[predictable]

    if config.id2label == {0: False, 1: True}:
        probs = probs[:, 1]
        true_labels = true_labels.astype(np.int64)

    output = SimpleNamespace(loss=float("nan"), preds=probs, labels=true_labels)
    frac = frac_unpredictable[valid if valid is not None else slice(None)]
    if return_generated:
        return output, frac, generated
    return output, frac


def get_generative_predictions(
    model,
    config: StructuredTransformerConfig,
    labeling_function: Labeler,
    batch: EventStreamBatch,
    seed: int,
    num_samples: int,
    max_new_events: int,
    use_cache: bool = True,
    do_validate_batch: bool = True,
    return_generated: bool = False,
    engine=None,
    device=None,
):
    """Generates ``num_samples`` continuations a subject, labels them and
    averages into empirical label probabilities (JAX's; ``seed`` an integer
    where JAX takes a key). With ``engine`` (a `serving.GenerationEngine`
    over the same model and config) generation runs through the engine
    (`_generate_via_engine`); otherwise through cohort `generate()` on
    ``device``. The generated batch (CPU tensors, ``prompt + max_new_events``
    events a row, rows in `EventStreamBatch.repeat_batch_elements` order) is
    appended with ``return_generated``."""
    if engine is not None:
        generated = _generate_via_engine(engine, batch, seed, num_samples, max_new_events)
    else:
        generated = generate(model, batch, config, seed=seed, max_new_events=max_new_events,
                             num_return_sequences=num_samples, use_cache=use_cache,
                             do_validate_batch=do_validate_batch, device=device).map(lambda t: t.cpu())  # fmt: skip
    return _aggregate_predictions(generated, batch, config, labeling_function, num_samples, return_generated)


def _generate_via_engine(engine, batch: EventStreamBatch, seed: int, num_samples: int, max_new_events: int):
    """One evaluation batch's expanded rows through the serving engine (JAX's
    ``_generate_via_engine``): a paged engine forks each subject's prompt
    into ``num_samples`` branches (session ``derive_request_seed(seed, s)``),
    a monolithic one takes a request a row (seed ``derive_request_seed(seed,
    i)``). Every row keeps its nominal prompt length; the results are put
    back into the fixed ``(B * num_samples, prompt_len + max_new_events)``
    layout the labeler contract expects, a row stopped early padded with
    masked events where `generate()` would have written them."""
    from ..serving import Request

    batch = batch.map(lambda t: t.cpu())
    expanded = batch.repeat_batch_elements(num_samples)
    n_rows = expanded.batch_size
    if engine.paged_kv:
        for s in range(batch.batch_size):
            engine.fork(batch.slice((slice(s, s + 1), slice(None))), num_samples, max_new_events,
                        key=derive_request_seed(seed, s), request_id=s)  # fmt: skip
        results = engine.run()
        row_of = {(s, j): s * num_samples + j for s in range(batch.batch_size) for j in range(num_samples)}
    else:
        requests = [
            Request(prompt=expanded.slice((slice(i, i + 1), slice(None))), max_new_events=max_new_events,
                    key=derive_request_seed(seed, i), request_id=i)  # fmt: skip
            for i in range(n_rows)
        ]
        results = engine.run(requests)
        row_of = {i: i for i in range(n_rows)}

    target_len = batch.sequence_length + max_new_events
    M = batch.n_data_elements
    out = {
        "event_mask": torch.zeros((n_rows, target_len), dtype=torch.bool),
        "time_delta": torch.zeros((n_rows, target_len), dtype=torch.float32),
        "dynamic_indices": torch.zeros((n_rows, target_len, M), dtype=torch.int64),
        "dynamic_measurement_indices": torch.zeros((n_rows, target_len, M), dtype=torch.int64),
        "dynamic_values": torch.zeros((n_rows, target_len, M), dtype=torch.float32),
        "dynamic_values_mask": torch.zeros((n_rows, target_len, M), dtype=torch.bool),
    }
    for res in results:
        if res.error is not None:
            raise RuntimeError(f"zero-shot generation of row {res.request_id} failed: {res.error!r}")
        i = row_of[res.request_id]
        n = min(res.n_events, target_len)
        for field, dst in out.items():
            dst[i, :n] = getattr(res.batch, field)[0, :n].to(dst.dtype)
    return EventStreamBatch(
        static_indices=expanded.static_indices,
        static_measurement_indices=expanded.static_measurement_indices,
        start_time=expanded.start_time,
        **out,
    )


def zero_shot_evaluation(cfg: FinetuneConfig, num_samples: int | None = None, use_engine: bool = True,
                         device=None) -> tuple[dict, dict]:  # fmt: skip
    """Zero-shot evaluation over the tuning and held-out splits (JAX's
    ``zero_shot_evaluation``), on ``device`` (None: the CUDA device, raising
    without one). Returns the two splits' metric dicts and writes them to
    ``cfg.save_dir/zero_shot_{tuning,held_out}_metrics.json``.

    The model is `training.pretrain.build_model` of ``cfg.config`` set to the
    tuning split (keeping its ``max_seq_len`` and TTE statistics), with the
    weights of ``cfg.pretrained_weights_fp`` (`load_pretrained`). Each split
    collates on the device when `DeviceDataset.try_create` admits it, else
    on the host. The engine holds ``validation_batch_size * num_samples``
    slots of ``max_len`` = the data's ``max_seq_len`` + the new events, and
    (CI) blocks of the largest divisor of ``max_len`` up to 16."""
    device = resolve_device(device, "zero_shot_evaluation")
    np.random.seed(cfg.seed)
    tuning_pyd = TorchDataset(cfg.data_config, split="tuning")
    held_out_pyd = TorchDataset(cfg.data_config, split="held_out")

    config = cfg.config
    batch_size = cfg.optimization_config.validation_batch_size
    orig = (config.max_seq_len, config.mean_log_inter_event_time_min, config.std_log_inter_event_time_min)
    config.set_to_dataset(tuning_pyd)
    config.max_seq_len, config.mean_log_inter_event_time_min, config.std_log_inter_event_time_min = orig

    labeler_fp = Path(cfg.data_config.save_dir) / "task_dfs" / f"{cfg.task_df_name}_labeler.py"
    labeling_function = import_class_from_file(labeler_fp, "TaskLabeler")(config=config)

    if num_samples is None:
        num_samples = (config.task_specific_params or {}).get("num_samples") or 1
    max_new_events = config.max_seq_len - tuning_pyd.max_seq_len
    if max_new_events <= 0:
        raise ValueError(
            f"config.max_seq_len ({config.max_seq_len}) must exceed the dataset's max_seq_len "
            f"({tuning_pyd.max_seq_len}) to leave room for generation."
        )

    if cfg.pretrained_weights_fp is None:
        raise ValueError("pretrained_weights_fp must be specified")
    model, _ = load_pretrained(cfg.pretrained_weights_fp, model=build_model(config), device=device)
    init_batch = next(tuning_pyd.batches(min(batch_size, len(tuning_pyd)), shuffle=False, seed=0))

    engine = None
    if use_engine:
        from ..serving import GenerationEngine

        max_len = tuning_pyd.max_seq_len + max_new_events
        paged = config.structured_event_processing_mode != StructuredEventProcessingMode.NESTED_ATTENTION
        block_size = next(b for b in range(min(16, max_len), 0, -1) if max_len % b == 0)
        engine = GenerationEngine(model, config, template=init_batch, n_slots=batch_size * num_samples,
                                  max_len=max_len, max_prompt_len=tuning_pyd.max_seq_len, paged_kv=paged,
                                  block_size=block_size if paged else 16, device=device)  # fmt: skip

    results = {}
    batch_index = 0
    for split, dataset in ((Split.TUNING, tuning_pyd), (Split.HELD_OUT, held_out_pyd)):
        metrics = StreamClassificationMetrics(config, split)
        frac_unpredictable: list[np.ndarray] = []
        device_ds = DeviceDataset.try_create(dataset, device=device)
        source = device_ds if device_ds is not None else dataset
        for batch in source.batches(batch_size, shuffle=False, drop_last=False, seed=0):
            out, frac = get_generative_predictions(
                model, config, labeling_function, batch, derive_request_seed(cfg.seed, batch_index),
                num_samples=num_samples, max_new_events=max_new_events, do_validate_batch=device_ds is None,
                engine=engine, device=device,
            )  # fmt: skip
            batch_index += 1
            if len(out.labels):
                metrics.update(out)
            frac_unpredictable.append(frac)
        result = metrics.compute()
        result.pop(f"{split}_loss", None)  # zero-shot has no loss
        if frac_unpredictable:
            result[f"{split}_frac_unpredictable"] = float(np.concatenate(frac_unpredictable).mean())
        results[str(split)] = result

    save_dir = Path(cfg.save_dir)
    print("Saving final metrics...")
    save_dir.mkdir(parents=True, exist_ok=True)
    for split in (Split.TUNING, Split.HELD_OUT):
        with open(save_dir / f"zero_shot_{split}_metrics.json", "w") as f:
            json.dump(results[str(split)], f)
    return results[str(Split.TUNING)], results[str(Split.HELD_OUT)]
