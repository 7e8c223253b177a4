"""Model checkpoints: the ``save_pretrained`` directory contract.

Counterpart: ``save_pretrained`` and ``load_pretrained`` of
``eventstreamgpt_tpu/training/checkpoint.py``. The directory holds
``config.json`` (the configuration both packages read) and the weights under
``pretrained_weights/``. JAX writes those with orbax, which only JAX reads;
the port writes the model's fp32 ``state_dict`` with ``torch.save`` into
``pretrained_weights/model.pt``, tensors in a plain dict and nothing else,
so ``torch.load(..., weights_only=True)`` reads it on any PyTorch that has
that mode. `convert.checkpoint_from_jax` turns JAX parameters into such a
directory.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..models.config import StructuredTransformerConfig
from ..utils.device import resolve_device
from .pretrain import build_model

PRETRAINED_WEIGHTS_DIR = "pretrained_weights"
WEIGHTS_FILE = "model.pt"


def _abs(path: Path | str) -> Path:
    return Path(path).expanduser().resolve()


def save_pretrained(save_dir: Path | str, model, config: StructuredTransformerConfig | None = None) -> Path:
    """Writes ``model``'s weights (a module or its ``state_dict``), and the
    config when given, under ``save_dir``; returns the weights directory.
    Float tensors are written in fp32, every tensor contiguous on the CPU."""
    save_dir = _abs(save_dir)
    weights_dir = save_dir / PRETRAINED_WEIGHTS_DIR
    weights_dir.mkdir(parents=True, exist_ok=True)
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    out = {}
    for name, t in state.items():
        t = t.detach().to("cpu")
        out[name] = (t.float() if t.is_floating_point() else t).contiguous().clone()
    torch.save(out, weights_dir / WEIGHTS_FILE)
    if config is not None:
        config.to_json_file(save_dir / "config.json", do_overwrite=True)
    return weights_dir


def load_pretrained(save_dir: Path | str, model=None, device=None) -> tuple:
    """``(model, config)`` from a `save_pretrained` directory: the weights
    loaded into ``model`` (default: `training.pretrain.build_model` of the
    config) on ``device`` (default: the CUDA device, raising without one).
    Loading is strict: a missing or unexpected tensor, or one whose shape or
    dtype differs from the model's, raises ``ValueError`` naming it."""
    save_dir = _abs(save_dir)
    device = resolve_device(device, "load_pretrained")
    config = StructuredTransformerConfig.from_json_file(save_dir / "config.json")
    if model is None:
        model = build_model(config)
    state = torch.load(save_dir / PRETRAINED_WEIGHTS_DIR / WEIGHTS_FILE, map_location=device, weights_only=True)
    want = model.state_dict()
    missing, extra = sorted(set(want) - set(state)), sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint {save_dir} does not match the model: missing {missing}, unexpected {extra}")
    for name, t in want.items():
        got = state[name]
        if tuple(got.shape) != tuple(t.shape) or got.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {save_dir}: {name} is {tuple(got.shape)}/{got.dtype}, the model's "
                f"{tuple(t.shape)}/{t.dtype}"
            )
    model.to(device)
    model.load_state_dict(state, strict=True)
    return model, config
