"""Training (counterpart: ``eventstreamgpt_tpu/training``): the optimizer and
the single-device train steps (CI and nested-attention models), per batch
and chunked over a device-resident dataset, the checkpoint directory and the
resume checkpoints, the metrics, `evaluate` and the pretraining loop
(`train`)."""

from .checkpoint import PRETRAINED_WEIGHTS_DIR, TrainCheckpointManager, load_pretrained, save_pretrained
from .optimizer import build_optimizer, polynomial_decay_with_warmup
from .pretrain import (
    PretrainConfig,
    TrainState,
    build_model,
    evaluate,
    make_chunked_train_step,
    make_eval_step,
    make_train_step,
    train,
    train_steps,
)
from .fine_tuning import FinetuneConfig, init_from_pretrained_encoder
from .fine_tuning import train as finetune
from .embedding import get_embeddings

__all__ = [
    "FinetuneConfig",
    "PRETRAINED_WEIGHTS_DIR",
    "PretrainConfig",
    "TrainCheckpointManager",
    "TrainState",
    "build_model",
    "build_optimizer",
    "evaluate",
    "finetune",
    "get_embeddings",
    "init_from_pretrained_encoder",
    "make_chunked_train_step",
    "make_eval_step",
    "load_pretrained",
    "make_train_step",
    "polynomial_decay_with_warmup",
    "save_pretrained",
    "train",
    "train_steps",
]
