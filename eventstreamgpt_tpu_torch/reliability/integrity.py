"""Checkpoint integrity: retries with backoff, checksum manifests, walk-back.

Counterpart: ``eventstreamgpt_tpu/reliability/integrity.py``. Three failure
modes of storage under long runs:

* transient errors (a flaky network filesystem): every save and restore
  attempt runs under `retry_transient`, exponential backoff on ``OSError``;
* silent corruption: every committed step gets a ``manifest_<step>.json`` of
  per-file sha256 digests, written atomically after the state; a restore
  recomputes them before it reads the state;
* partial writes (a kill mid-save): `restore_latest_verified` walks the steps
  newest first, skipping steps that fail verification or whose load raises,
  and lands on the newest one that restores.

Steps without a manifest are accepted with a warning (the walk-back still
catches them if they fail to load).
"""

from __future__ import annotations

import hashlib
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable

from ..training.checkpoint import TrainCheckpointManager
from ..utils.serialization import atomic_write_json
from . import faults

__all__ = ["ReliableCheckpointManager", "decode_resume_metadata", "resume_training_state", "retry_transient"]

BACKOFF_MAX_S = 8.0  # the longest wait between two attempts


def decode_resume_metadata(meta: dict | None) -> tuple[int, int]:
    """``(resume_epoch, skip_batches)`` of a checkpoint's metadata: an
    epoch-complete checkpoint resumes at the next epoch's start, a mid-epoch
    one re-enters its epoch past the batches already trained on."""
    meta = meta or {}
    if meta.get("epoch_complete", True):
        return int(meta.get("epoch", 0)) + 1, 0
    return int(meta.get("epoch", 0)), int(meta.get("step_in_epoch", 0))


def resume_training_state(
    ckpt_mgr: "ReliableCheckpointManager", load_state: Callable[[dict], None]
) -> tuple[int, int, int]:
    """The training loop's auto-resume: the newest verifiable checkpoint
    with readable metadata, handed to ``load_state`` (which writes it into
    the live tensors in place). Returns ``(restored_step, start_epoch,
    skip_batches)``."""
    state, step = ckpt_mgr.restore_latest_verified(require_metadata=True)
    load_state(state)
    start_epoch, skip = decode_resume_metadata(ckpt_mgr.metadata(step))
    print(f"Resumed from checkpoint at step {step} (epoch {start_epoch}, skipping {skip} batches)")
    return step, start_epoch, skip


def retry_transient(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    backoff_base: float = 0.5,
    describe: str = "checkpoint I/O",
) -> Any:
    """Runs ``fn`` at most ``retries + 1`` times, sleeping ``min(backoff_base
    * 2**attempt, BACKOFF_MAX_S)`` after each ``OSError``; other errors
    propagate at once."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError as e:
            if attempt == retries:
                raise
            delay = min(backoff_base * (2.0**attempt), BACKOFF_MAX_S)
            warnings.warn(
                f"{describe} failed (attempt {attempt + 1}/{retries + 1}): {e}; retrying in {delay:.2f}s",
                RuntimeWarning,
                stacklevel=2,
            )
            time.sleep(delay)


def _file_sha256(fp: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(fp, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


class ReliableCheckpointManager(TrainCheckpointManager):
    """`TrainCheckpointManager` with retried saves, manifests and walk-back
    restores (`restore_latest_verified`)."""

    def __init__(
        self,
        ckpt_dir: Path | str,
        max_to_keep: int = 2,
        *,
        retries: int = 3,
        backoff_base: float = 0.5,
    ):
        super().__init__(ckpt_dir, max_to_keep=max_to_keep)
        self._retry = dict(retries=retries, backoff_base=backoff_base)
        self._save_calls = 0

    def save(self, step: int, state: dict, metadata: dict | None = None) -> bool:
        save_index = self._save_calls
        self._save_calls += 1
        attempts = iter(range(1 << 30))

        def attempt() -> bool:
            faults.maybe_fail_save(save_index, next(attempts))
            return super(ReliableCheckpointManager, self).save(step, state, metadata)

        saved = retry_transient(attempt, **self._retry, describe=f"checkpoint save (step {step})")
        if saved:
            # The crash window: the state is on disk, its manifest is not yet.
            faults.maybe_kill_during_save(self.ckpt_dir, step, save_index)
            retry_transient(
                lambda: self._write_manifest(step), **self._retry, describe=f"checkpoint manifest (step {step})"
            )
            faults.maybe_corrupt_after_save(self.ckpt_dir, step, save_index)
        return saved

    def _manifest_fp(self, step: int) -> Path:
        return self.ckpt_dir / f"manifest_{step}.json"

    def _write_manifest(self, step: int) -> None:
        step_dir = self._step_dir(step)
        files = {
            fp.relative_to(step_dir).as_posix(): {"sha256": _file_sha256(fp), "bytes": fp.stat().st_size}
            for fp in sorted(p for p in step_dir.rglob("*") if p.is_file())
        }
        atomic_write_json(self._manifest_fp(step), {"step": step, "algo": "sha256", "files": files})

    def _verify_status(self, step: int) -> str:
        """``"verified"``, ``"legacy"`` (no manifest) or ``"failed"``."""
        fp = self._manifest_fp(step)
        if not fp.exists():
            warnings.warn(f"checkpoint step {step} has no integrity manifest; accepting unverified", RuntimeWarning,
                          stacklevel=2)  # fmt: skip
            return "legacy"
        try:
            with open(fp) as f:
                files = json.load(f)["files"]
        except (OSError, json.JSONDecodeError, KeyError, UnicodeDecodeError) as e:
            warnings.warn(f"unreadable manifest for step {step}: {e}", RuntimeWarning, stacklevel=2)
            return "failed"
        step_dir = self._step_dir(step)
        for rel, meta in files.items():
            f = step_dir / rel
            if not f.is_file():
                warnings.warn(f"step {step}: missing file {rel}", RuntimeWarning, stacklevel=2)
                return "failed"
            if f.stat().st_size != meta["bytes"] or _file_sha256(f) != meta["sha256"]:
                warnings.warn(f"step {step}: checksum mismatch on {rel}", RuntimeWarning, stacklevel=2)
                return "failed"
        return "verified"

    def restore_latest_verified(self, *, require_metadata: bool = False) -> tuple[dict, int]:
        """``(state, step)`` of the newest checkpoint that verifies and loads.

        Steps that fail verification, whose load raises or (with
        ``require_metadata``) whose metadata is unreadable are skipped with a
        warning. After a restore, the skipped newer steps that are provably
        bad (failed checksums, unverified torn writes, lost metadata) are
        deleted, since a save at or below the latest step is skipped; a
        verified step whose load failed is kept. Raises
        ``FileNotFoundError`` when nothing restores."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"No checkpoints found under {self.ckpt_dir}")
        skipped: dict[int, str] = {}
        for step in steps:
            status = self._verify_status(step)
            if status == "failed":
                warnings.warn(f"skipping corrupt/unverifiable checkpoint step {step}; walking back", RuntimeWarning,
                              stacklevel=2)  # fmt: skip
                skipped[step] = "failed"
                continue
            if require_metadata and self.metadata(step) is None:
                warnings.warn(f"checkpoint step {step} has no readable resume metadata; walking back",
                              RuntimeWarning, stacklevel=2)  # fmt: skip
                skipped[step] = "verified" if status == "verified" else "no-metadata"
                continue
            try:
                state = retry_transient(
                    lambda: self.load(step),
                    **{**self._retry, "retries": min(self._retry["retries"], 1)},
                    describe=f"checkpoint restore (step {step})",
                )
            except Exception as e:  # a torn file raises any of several types
                warnings.warn(f"restore of checkpoint step {step} failed ({type(e).__name__}: {e}); walking back",
                              RuntimeWarning, stacklevel=2)  # fmt: skip
                skipped[step] = status
                continue
            self._dispose_skipped(skipped, restored_step=step)
            return state, step
        raise FileNotFoundError(f"No verifiable checkpoint could be restored under {self.ckpt_dir} (tried {steps})")

    def _dispose_skipped(self, skipped: dict[int, str], restored_step: int) -> None:
        for newer, why in sorted(skipped.items()):
            if why == "verified":
                warnings.warn(
                    f"checkpoint step {newer} is checksum-verified but was skipped; keeping it (saves at steps <= "
                    f"{newer} are skipped until training passes it)",
                    RuntimeWarning,
                    stacklevel=3,
                )
                continue
            self.delete(newer)
            warnings.warn(f"deleted unrestorable checkpoint step {newer} (walked back to {restored_step})",
                          RuntimeWarning, stacklevel=3)  # fmt: skip
        self._prune_metadata()
