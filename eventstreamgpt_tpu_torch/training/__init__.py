"""Training (counterpart: ``eventstreamgpt_tpu/training``): the optimizer and
the single-device train step (CI and nested-attention models)."""

from .optimizer import build_optimizer, polynomial_decay_with_warmup
from .pretrain import TrainState, build_model, make_train_step, train_steps

__all__ = [
    "TrainState",
    "build_model",
    "build_optimizer",
    "make_train_step",
    "polynomial_decay_with_warmup",
    "train_steps",
]
