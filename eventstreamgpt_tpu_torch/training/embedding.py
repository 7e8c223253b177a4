"""Embedding extraction: the pretrained encoder's pooled encodings of every subject.

Counterpart: ``eventstreamgpt_tpu/training/embedding.py``
(`EmbeddingsOnlyModel`, `embed_batch`, `get_embeddings`): an encoder-only
model, its weights grafted from a pretraining ``save_dir``
(`training.fine_tuning.init_from_pretrained_encoder`), pooled per subject
(``last``, ``max``, ``mean`` or ``none``) and written per split to
``{load_from_model_dir}/embeddings/{task_df_name or "all"}/{split}_embeddings.npy``.
The fill rows of a short last batch are dropped by ``valid_mask``, so each
subject appears once, in the dataset's order.

On the card the pooled forward is captured into a CUDA graph per batch
signature (its first batch runs eagerly as the warm-up, the second is
captured) and replayed for every later batch (`make_embed_step`). The
files hold fp32 (numpy has no bf16; a bf16 model's encodings are widened
exactly).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..data.device_dataset import DeviceDataset
from ..data.torch_dataset import TorchDataset
from ..data.types import X32, EventStreamBatch
from ..models.config import StructuredTransformerConfig
from ..models.fine_tuning_model import build_encoder, event_encodings, pool_events
from ..utils.device import resolve_device
from ..utils.graphs import CapturedProgram
from .fine_tuning import FinetuneConfig, init_from_pretrained_encoder
from .pretrain import _copy_batch, _signature, eval_batches

SPLITS = ("train", "tuning", "held_out")


class EmbeddingsOnlyModel(nn.Module):
    """The encoder alone (flax name ``encoder``)."""

    def __init__(self, config: StructuredTransformerConfig):
        super().__init__()
        self.config = config
        self.encoder = build_encoder(config)

    def forward(self, batch: EventStreamBatch, dropout=None):
        return self.encoder(batch, dropout=dropout)


def embed_batch(model: nn.Module, config: StructuredTransformerConfig, batch: EventStreamBatch,
                pooling_method: str) -> torch.Tensor:  # fmt: skip
    """Pooled per-subject encodings of one batch (``(B, H)``; ``(B, L, H)``
    for ``none``), no dropout and no gradients."""
    with torch.no_grad():
        encoded = model(batch).last_hidden_state
        return pool_events(event_encodings(config, encoded), batch.event_mask, pooling_method)


def make_embed_step(model: nn.Module, config: StructuredTransformerConfig, pooling_method: str, device=None,
                    cuda_graph: bool = True) -> Callable:  # fmt: skip
    """``embed(batch) -> (B, ...)``: `embed_batch` on ``device`` (None: the
    CUDA device). Each batch is copied into its signature's static buffers
    there; on the card with ``cuda_graph=True`` each signature's first batch
    runs eagerly on a side stream (its warm-up), its second is captured and
    replayed, and every later one is one replay. The output is a fresh
    tensor on the device. ``embed.stats()`` counts signatures, warm-ups,
    captures and replays."""
    device = resolve_device(device, "make_embed_step")
    model.to(device).eval()
    capture = cuda_graph and device.type == "cuda"
    statics: dict = {}
    programs: dict = {}

    def embed(batch: EventStreamBatch) -> torch.Tensor:
        signature = _signature(batch)
        if signature not in statics:
            statics[signature] = batch.map(
                lambda t: torch.empty(t.shape, dtype=X32.get(t.dtype, t.dtype), device=device)
            )
        static = statics[signature]
        _copy_batch(static, batch)
        if not capture:
            return embed_batch(model, config, static, pooling_method)
        program = programs.get(signature)
        if program is None:
            program = programs[signature] = CapturedProgram(
                lambda: embed_batch(model, config, static, pooling_method), "the embedding forward", device=device
            )
            return program.warmup()
        if program.graph is None:
            program.capture()
        return program.replay().clone()

    def stats() -> dict:
        progs = list(programs.values())
        return {
            "cuda_graph": capture,
            "batch_signatures": len(statics),
            "graph_warmups": sum(p.warmups for p in progs),
            "graph_captures": sum(p.captures for p in progs),
            "graph_replays": sum(p.replays for p in progs),
        }

    embed.stats = stats
    return embed


def get_embeddings(
    cfg: FinetuneConfig, device=None, cuda_graph: bool = True, stats: dict | None = None
) -> dict[str, Path]:
    """Extracts and writes the embeddings of the train, tuning and held-out
    splits (JAX's ``get_embeddings``); returns each split's file.

    ``device=None`` means the CUDA device (and raises without one). The
    encoder of ``cfg.pretrained_weights_fp`` is grafted into a numpy-seeded
    encoder-only model; each split is read through a `DeviceDataset` where
    it fits the device's budget (host collation otherwise) in the
    validation batch size, without shuffling, and each subject's encoding
    kept once. An existing file is kept unless ``cfg.do_overwrite``.
    ``stats`` (a dict), when given, receives the embed step's `stats` and
    each split's ``{split}_subjects`` and ``{split}_s`` (host seconds from
    the split's first batch to its embeddings on the host)."""
    from ..convert import init_params_from_seed

    device = resolve_device(device, "get_embeddings")
    config, oc = cfg.config, cfg.optimization_config
    train_ds = TorchDataset(cfg.data_config, split="train")
    config.set_to_dataset(train_ds)
    pooling_method = (config.task_specific_params or {}).get("pooling_method", "last")

    model = init_params_from_seed(EmbeddingsOnlyModel(config), seed=0)
    init_from_pretrained_encoder(model, cfg.pretrained_weights_fp)
    embed = make_embed_step(model, config, pooling_method, device=device, cuda_graph=cuda_graph)

    out_dir = Path(cfg.load_from_model_dir) / "embeddings" / (cfg.task_df_name or "all")
    written: dict[str, Path] = {}
    stats = {} if stats is None else stats
    for sp in SPLITS:
        dataset = train_ds if sp == "train" else TorchDataset(cfg.data_config, split=sp)
        device_data = DeviceDataset.try_create(dataset, device=device)
        t0 = time.perf_counter()
        outs = [(embed(batch), valid) for batch, valid in eval_batches(dataset, oc.validation_batch_size, device_data)]
        embeddings = np.concatenate([emb.float().cpu().numpy()[valid.numpy()] for emb, valid in outs], axis=0)
        stats[f"{sp}_s"], stats[f"{sp}_subjects"] = time.perf_counter() - t0, len(embeddings)

        embeddings_fp = out_dir / f"{sp}_embeddings.npy"
        if embeddings_fp.is_file() and not cfg.do_overwrite:
            print(f"Embeddings already exist at {embeddings_fp}. To overwrite, set `do_overwrite=True`.")
        else:
            embeddings_fp.parent.mkdir(parents=True, exist_ok=True)
            print(f"Saving {sp} embeddings to {embeddings_fp}.")
            np.save(embeddings_fp, embeddings)
        written[sp] = embeddings_fp
    stats.update(embed.stats())
    return written
