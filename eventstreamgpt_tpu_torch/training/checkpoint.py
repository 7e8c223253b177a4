"""Model checkpoints: the ``save_pretrained`` directory contract, and resume checkpoints.

Counterpart: ``eventstreamgpt_tpu/training/checkpoint.py`` (``save_pretrained``,
``load_pretrained``, ``TrainCheckpointManager``). The directory holds
``config.json`` (the configuration both packages read) and the weights under
``pretrained_weights/``. JAX writes those with orbax, which only JAX reads;
the port writes the model's fp32 ``state_dict`` with ``torch.save`` into
``pretrained_weights/model.pt``, tensors in a plain dict and nothing else,
so ``torch.load(..., weights_only=True)`` reads it on any PyTorch that has
that mode. `convert.checkpoint_from_jax` turns JAX parameters into such a
directory.

`TrainCheckpointManager` keeps the training loop's resume checkpoints: one
directory a step, ``{ckpt_dir}/{step}/state.pt``, holding a plain dict of
CPU tensors and integers written with ``torch.save`` (the parameters, the
AdamW state, the scheduler's position, ``TrainState.step`` and the
gradient-accumulation buffers; `training.pretrain` builds and reads it),
beside a ``metadata_{step}.json`` sidecar. This is the port's own format:
JAX's orbax resume steps are not read here; `convert.train_state_from_jax`
turns one (given as numpy) into a port checkpoint.
"""

from __future__ import annotations

import json
import shutil
import warnings
from pathlib import Path

import torch

from ..models.config import StructuredTransformerConfig
from ..utils.device import resolve_device
from ..utils.serialization import atomic_write_json
from .pretrain import build_model

PRETRAINED_WEIGHTS_DIR = "pretrained_weights"
WEIGHTS_FILE = "model.pt"
STATE_FILE = "state.pt"


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


class TrainCheckpointManager:
    """Step-level resume checkpoints, the most recent ``max_to_keep`` kept.

    A save writes ``{step}/state.pt`` into a temporary directory and renames
    it into place, so a step directory is whole or absent. As orbax's
    manager does, a save at a step at or below the latest is skipped (it
    returns False), though its metadata sidecar is still written when the
    step exists (an epoch-end save that lands on an in-loop save's step
    marks it ``epoch_complete``). Saves are synchronous:
    `wait_until_finished` and `close` have nothing to wait for.
    """

    def __init__(self, ckpt_dir: Path | str, max_to_keep: int = 2):
        self.ckpt_dir = _abs(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _step_dir(self, step: int) -> Path:
        return self.ckpt_dir / str(step)

    def _write(self, step: int, state: dict) -> None:
        tmp = self.ckpt_dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        tmp.rename(self._step_dir(step))

    def save(self, step: int, state: dict, metadata: dict | None = None) -> bool:
        """Writes ``state`` at ``step``; returns whether it was written."""
        latest = self.latest_step()
        saved = latest is None or step > latest
        if saved:
            self._write(step, state)
        if metadata is not None and (saved or step in self.all_steps()):
            atomic_write_json(self.ckpt_dir / f"metadata_{step}.json", metadata)
        if saved:
            for old in self.all_steps()[: -self.max_to_keep] if self.max_to_keep else []:
                self.delete(old)
            self._prune_metadata()
        return saved

    def delete(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _prune_metadata(self) -> None:
        """Drops sidecars (metadata, manifests, stray temporaries) of deleted steps."""
        live = set(self.all_steps())
        for pattern in ("metadata_*.json", "manifest_*.json"):
            for fp in self.ckpt_dir.glob(pattern):
                try:
                    step = int(fp.stem.split("_")[-1])
                except ValueError:
                    continue
                if step not in live:
                    fp.unlink(missing_ok=True)
        for pattern in ("*.json.tmp", "*.json.*.tmp"):
            for fp in self.ckpt_dir.glob(pattern):
                fp.unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """Every committed step, ascending."""
        return sorted(int(p.name) for p in self.ckpt_dir.iterdir() if p.is_dir() and p.name.isdigit())

    def load(self, step: int) -> dict:
        """The state saved at ``step`` (CPU tensors)."""
        return torch.load(self._step_dir(step) / STATE_FILE, map_location="cpu", weights_only=True)

    def metadata(self, step: int) -> dict | None:
        """The step's sidecar; None when it is missing or unreadable."""
        fp = self.ckpt_dir / f"metadata_{step}.json"
        if not fp.exists():
            return None
        try:
            with open(fp) as f:
                return json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            warnings.warn(f"undecodable checkpoint metadata sidecar {fp}: {e}; ignoring it", RuntimeWarning, stacklevel=2)
            return None

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""
