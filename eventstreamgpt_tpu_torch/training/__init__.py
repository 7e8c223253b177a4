"""Training (counterpart: ``eventstreamgpt_tpu/training``): the optimizer and
the single-device train steps (CI and nested-attention models), per batch
and chunked over a device-resident dataset, and the checkpoint directory."""

from .checkpoint import PRETRAINED_WEIGHTS_DIR, load_pretrained, save_pretrained
from .optimizer import build_optimizer, polynomial_decay_with_warmup
from .pretrain import TrainState, build_model, make_chunked_train_step, make_train_step, train_steps

__all__ = [
    "PRETRAINED_WEIGHTS_DIR",
    "TrainState",
    "build_model",
    "build_optimizer",
    "make_chunked_train_step",
    "load_pretrained",
    "make_train_step",
    "polynomial_decay_with_warmup",
    "save_pretrained",
    "train_steps",
]
