"""Divergence sentinel: health vectors from the step, verdicts on the host,
and the bounded rollback state machine.

Counterpart: ``eventstreamgpt_tpu/reliability/sentinel.py``. The train step
computes its own health, ``[loss, grad_global_norm]`` as an fp32 vector on
the device beside the loss (``with_health=True``), and the loop buffers
those vectors as it buffers the window losses. Nothing is read back a step;
the buffer is inspected only at the flush cadence (checkpoint saves, epoch
end), where the loop reads the device anyway. A window is bad when a step in
it has a non-finite loss or gradient norm, a gradient norm above
``grad_norm_max``, or a loss above ``spike_factor`` times the running loss
EMA (updated from healthy windows only).

After ``bad_windows_to_rollback`` consecutive bad windows the loop restores
the last good checkpoint (none is ever written from a bad window: the
inspection runs before the save), skips past the poisoned window and goes
on. The restore writes into the live parameters and optimizer state in
place (`training.pretrain`), so the captured step programs keep reading
them. `RollbackController` bounds the run at ``max_rollbacks`` rollbacks;
past that, or with no checkpoint to return to, it writes a diagnostic dump
beside the run and raises `DivergenceError`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from pathlib import Path
from typing import Any, Callable

import numpy as np

from ..utils.serialization import atomic_write_json
from .preemption import Preempted

__all__ = [
    "DivergenceError",
    "DivergenceSentinel",
    "EpochOutcome",
    "HealthMonitor",
    "RollbackController",
    "SentinelConfig",
    "finish_epoch",
    "rollback_restore",
]


class DivergenceError(RuntimeError):
    """Training diverged beyond what rollback can repair.

    Carries the path of the diagnostic dump written before raising.
    """

    def __init__(self, message: str, diagnostics_fp: Path | None = None):
        super().__init__(message)
        self.diagnostics_fp = diagnostics_fp


@dataclasses.dataclass
class SentinelConfig:
    """Divergence-sentinel thresholds (all host-side; the step only emits
    ``[loss, grad_norm]``). Non-finite checks are always on; the spike and
    gradient-norm ceilings are opt-in."""

    ema_decay: float = 0.9
    spike_factor: float | None = None  # loss > spike_factor * EMA -> bad
    grad_norm_max: float | None = None  # grad norm above this -> bad
    warmup_windows: int = 1  # healthy windows before spike checks engage
    bad_windows_to_rollback: int = 1  # K consecutive bad windows
    max_rollbacks: int = 3  # M rollbacks before aborting

    @classmethod
    def from_trainer_config(cls, tc: dict) -> "SentinelConfig | None":
        """Parses the ``sentinel_*`` trainer-config keys; ``None`` (sentinel
        off) when ``sentinel_enabled`` is explicitly false."""
        if not tc.get("sentinel_enabled", True):
            return None
        cfg = cls()
        if tc.get("sentinel_ema_decay") is not None:
            cfg.ema_decay = float(tc["sentinel_ema_decay"])
        if tc.get("sentinel_spike_factor") is not None:
            cfg.spike_factor = float(tc["sentinel_spike_factor"])
        if tc.get("sentinel_grad_norm_max") is not None:
            cfg.grad_norm_max = float(tc["sentinel_grad_norm_max"])
        if tc.get("sentinel_warmup_windows") is not None:
            cfg.warmup_windows = int(tc["sentinel_warmup_windows"])
        if tc.get("sentinel_bad_windows") is not None:
            cfg.bad_windows_to_rollback = max(int(tc["sentinel_bad_windows"]), 1)
        if tc.get("sentinel_max_rollbacks") is not None:
            cfg.max_rollbacks = int(tc["sentinel_max_rollbacks"])
        return cfg


class DivergenceSentinel:
    """Classifies inspection windows from buffered ``[loss, grad_norm]``
    health vectors and tracks the consecutive-bad count."""

    def __init__(self, config: SentinelConfig):
        self.config = config
        self.ema: float | None = None
        self.healthy_windows = 0
        self.consecutive_bad = 0
        # Ring buffer of recent window summaries for the diagnostic dump.
        self.history: deque[dict] = deque(maxlen=64)

    def observe_window(self, health: np.ndarray, *, step: int, epoch: int) -> bool:
        """Feeds one inspection window; returns True when it is healthy.

        ``health`` is the stacked per-step vectors, shape ``(n_steps, 2)``
        with columns ``[loss, grad_norm]`` (already host-side: the caller
        reads the buffers back at a cadence where the pipeline drains
        anyway).
        """
        health = np.asarray(health, dtype=np.float64).reshape(-1, 2)
        losses, gnorms = health[:, 0], health[:, 1]
        cfg = self.config

        reasons = []
        if not np.isfinite(losses).all():
            reasons.append("non-finite loss")
        if not np.isfinite(gnorms).all():
            reasons.append("non-finite grad norm")
        if cfg.grad_norm_max is not None and np.isfinite(gnorms).all():
            if (gnorms > cfg.grad_norm_max).any():
                reasons.append(
                    f"grad norm {float(np.nanmax(gnorms)):.3e} > {cfg.grad_norm_max:.3e}"
                )
        if (
            cfg.spike_factor is not None
            and not reasons
            and self.ema is not None
            and self.healthy_windows >= cfg.warmup_windows
        ):
            threshold = cfg.spike_factor * self.ema
            if (losses > threshold).any():
                reasons.append(
                    f"loss spike {float(losses.max()):.4e} > "
                    f"{cfg.spike_factor:g} x EMA ({self.ema:.4e})"
                )

        bad = bool(reasons)

        def finite_stat(arr: np.ndarray, fn) -> float | None:
            finite = arr[np.isfinite(arr)]
            return float(fn(finite)) if finite.size else None

        self.history.append(
            {
                "step": int(step),
                "epoch": int(epoch),
                "n_steps": int(health.shape[0]),
                "n_nonfinite": int((~np.isfinite(health)).any(axis=1).sum()),
                "loss_mean": finite_stat(losses, np.mean),
                "loss_max": finite_stat(losses, np.max),
                "grad_norm_max": finite_stat(gnorms, np.max),
                "ema": self.ema,
                "bad": bad,
                "reasons": reasons,
            }
        )
        if bad:
            self.consecutive_bad += 1
            return False
        self.consecutive_bad = 0
        self.healthy_windows += 1
        for loss in losses:
            self.ema = (
                float(loss)
                if self.ema is None
                else cfg.ema_decay * self.ema + (1.0 - cfg.ema_decay) * float(loss)
            )
        return True

    @property
    def should_rollback(self) -> bool:
        return self.consecutive_bad >= self.config.bad_windows_to_rollback

    def reset_after_rollback(self) -> None:
        """Restored state re-warms from scratch: the poisoned tail must not
        leave a bad streak or a spiked EMA behind."""
        self.consecutive_bad = 0
        self.ema = None
        self.healthy_windows = 0


class HealthMonitor:
    """Per-epoch health-flag buffer + inspection gate, shared verbatim by
    the pretrain and fine-tune loops (the verdict/gating logic is where
    subtle bugs live - one copy only).

    The loops `record` each dispatch's device health arrays (no readback)
    and call `inspect` only at their flush cadence; `inspect` returns the
    window's verdict, and checkpoint saves must gate on it - even a bad
    window below the K-streak must never commit a poisoned rollback target.
    """

    def __init__(self, sentinel: DivergenceSentinel | None):
        self.sentinel = sentinel
        self.pending: list = []
        self.rollback_requested = False
        self.detection_progress = 0

    def record(self, health: Any) -> None:
        """Buffers one dispatch's device health array(s) - shape ``(2,)``
        (per-batch step) or ``(k, 2)`` (scanned chunk)."""
        if self.sentinel is not None:
            self.pending.append(health)

    def inspect(self, *, step: int, epoch: int, progress: int) -> bool:
        """Feeds the buffer to the sentinel; returns the window verdict
        (True = healthy or nothing to inspect). ``progress`` is the
        epoch-order batch index reached - it becomes the poisoned-window
        edge if this window flips the rollback request."""
        if self.sentinel is None or not self.pending:
            return True
        window = np.concatenate([np.asarray(h.detach().cpu() if hasattr(h, "detach") else h).reshape(-1, 2)
                                 for h in self.pending])
        self.pending.clear()
        healthy = self.sentinel.observe_window(window, step=step, epoch=epoch)
        if self.sentinel.should_rollback and not self.rollback_requested:
            self.rollback_requested = True
            self.detection_progress = progress
        return healthy

    def vetted_save(
        self,
        ckpt_mgr,
        step: int,
        state_dict_fn: Callable[[], Any],
        metadata: dict,
        *,
        epoch: int,
        progress: int,
    ) -> bool:
        """The cadence checkpoint gate both loops share: inspect first, and
        commit only when THIS window vetted healthy and no rollback is
        pending - a bad-but-below-streak window must never become a poisoned
        rollback target. Returns True when the save ran (``state_dict_fn``'s
        device readback drained the pipeline, so callers flush their
        buffered log records on that signal)."""
        healthy = self.inspect(step=step, epoch=epoch, progress=progress)
        if not healthy or self.rollback_requested:
            return False
        ckpt_mgr.save(step, state_dict_fn(), metadata=metadata)
        return True


class RollbackController:
    """Bounds rollbacks at M and owns the poisoned-window excision map.

    ``poisoned`` maps epoch -> the epoch-order batch index training must skip
    to when (re-)entering that epoch: the restored checkpoint may predate
    the poisoned window by several cadences, and the batch order within an
    epoch is deterministic, so excising ``[restore point, detection point)``
    is what keeps a data-caused fault from simply re-firing after restore.
    """

    def __init__(self, max_rollbacks: int, diagnostics_fp: Path | str):
        self.max_rollbacks = max_rollbacks
        self.diagnostics_fp = Path(diagnostics_fp)
        self.rollbacks = 0
        self.poisoned: dict[int, int] = {}
        self.events: list[dict] = []

    def epoch_skip(self, epoch: int, skip: int) -> int:
        return max(skip, self.poisoned.get(epoch, 0))

    def request_rollback(
        self, sentinel: DivergenceSentinel, *, epoch: int, step_in_epoch: int, global_step: int
    ) -> None:
        """Registers a rollback attempt; raises `DivergenceError` past M."""
        self.rollbacks += 1
        self.poisoned[epoch] = max(self.poisoned.get(epoch, 0), step_in_epoch)
        self.events.append(
            {
                "rollback": self.rollbacks,
                "epoch": epoch,
                "step_in_epoch": step_in_epoch,
                "global_step": global_step,
            }
        )
        if self.rollbacks > self.max_rollbacks:
            self.abort(
                sentinel,
                reason=f"divergence persisted after {self.max_rollbacks} rollback(s)",
            )

    def abort(self, sentinel: DivergenceSentinel, *, reason: str, **context: Any) -> None:
        """Writes the diagnostic dump and raises `DivergenceError`."""
        dump = {
            "reason": reason,
            "rollbacks": self.rollbacks,
            "max_rollbacks": self.max_rollbacks,
            "poisoned_windows": {str(k): v for k, v in self.poisoned.items()},
            "rollback_events": self.events,
            "sentinel_config": dataclasses.asdict(sentinel.config),
            "window_history": list(sentinel.history),
            **context,
        }
        self.diagnostics_fp.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_json(self.diagnostics_fp, dump, indent=2, default=str)
        raise DivergenceError(
            f"{reason}; diagnostics written to {self.diagnostics_fp}",
            diagnostics_fp=self.diagnostics_fp,
        )


def rollback_restore(
    ckpt_mgr,
    sentinel: DivergenceSentinel,
    controller: RollbackController,
    *,
    epoch: int,
    detection_progress: int,
    global_step: int,
    label: str = "training",
) -> tuple[dict, int, int, int]:
    """One bounded rollback: counts it (raising `DivergenceError` past M, or
    when nothing restores), restores the newest verifiable checkpoint,
    decodes its resume metadata and resets the sentinel. Returns
    ``(restored_state, restored_step, resume_epoch, resume_skip)``."""
    controller.request_rollback(sentinel, epoch=epoch, step_in_epoch=detection_progress, global_step=global_step)
    try:
        restored, restored_step = ckpt_mgr.restore_latest_verified(require_metadata=True)
    except FileNotFoundError:
        controller.abort(
            sentinel,
            reason=f"{label} diverged before any restorable checkpoint existed",
            epoch=epoch,
            global_step=global_step,
        )
    from .integrity import decode_resume_metadata

    resume_epoch, resume_skip = decode_resume_metadata(ckpt_mgr.metadata(restored_step))
    sentinel.reset_after_rollback()
    return restored, restored_step, resume_epoch, resume_skip


@dataclasses.dataclass
class EpochOutcome:
    """What `finish_epoch` decided: ``"proceed"`` (``tail_healthy`` gates the
    epoch-end save) or ``"rollback"`` (re-enter at the resume coordinates;
    the state is restored already). Preemption raises `Preempted`."""

    action: str
    tail_healthy: bool = True
    global_step: int = 0
    resume_epoch: int = 0
    resume_skip: int = 0
    stop: bool = False


def finish_epoch(
    *,
    health_mon: HealthMonitor,
    rollback_ctl: "RollbackController | None",
    ckpt_mgr,
    shutdown,
    state_dict_fn: Callable[[], dict],
    load_state: Callable[[dict], None],
    log_record: Callable[[dict], None],
    epoch: int,
    epoch_progress: int,
    global_step: int,
    accum: int,
    max_training_steps: int | None,
    label: str,
) -> EpochOutcome:
    """The post-epoch recovery tail (JAX's ``finish_epoch``).

    Vets the tail window, then:

    * rollback: restores through `rollback_restore` and ``load_state`` (in
      place), re-derives ``stop`` from the rewound step, logs the event and
      returns ``action="rollback"``; a shutdown that arrived meanwhile
      raises `Preempted` instead (the restored checkpoint is the resume
      point);
    * preemption: writes the final mid-epoch checkpoint if the tail vetted
      healthy (``state_dict_fn`` reads the live state), and raises
      `Preempted` with the step a relaunch restores;
    * neither: returns ``action="proceed"`` with the tail verdict.
    """
    tail_healthy = True
    if not health_mon.rollback_requested:
        tail_healthy = health_mon.inspect(step=global_step, epoch=epoch, progress=epoch_progress)

    if health_mon.rollback_requested:
        restored, restored_step, resume_epoch, resume_skip = rollback_restore(
            ckpt_mgr,
            health_mon.sentinel,
            rollback_ctl,
            epoch=epoch,
            detection_progress=health_mon.detection_progress,
            global_step=global_step,
            label=label,
        )
        load_state(restored)
        stop = max_training_steps is not None and restored_step // accum >= max_training_steps
        log_record(
            {
                "split": "reliability",
                "event": "rollback",
                "rollback": rollback_ctl.rollbacks,
                "restored_step": restored_step,
                "epoch": epoch,
                "poisoned_through": health_mon.detection_progress,
                "step": restored_step,
            }
        )
        print(
            f"Divergence rollback #{rollback_ctl.rollbacks} ({label}): restored step {restored_step}; "
            f"re-entering epoch {resume_epoch} past the poisoned window"
        )
        if shutdown.requested:
            ckpt_mgr.close()
            raise Preempted(f"preempted during divergence rollback at step {restored_step}", step=restored_step)
        return EpochOutcome(
            action="rollback", global_step=restored_step, resume_epoch=resume_epoch, resume_skip=resume_skip, stop=stop
        )

    if shutdown.requested:
        if tail_healthy:
            ckpt_mgr.save(
                global_step,
                state_dict_fn(),
                metadata={"epoch": epoch, "epoch_complete": False, "step_in_epoch": epoch_progress},
            )
            final_step = global_step
        else:
            print(
                f"Preemption drain ({label}): tail window failed divergence vetting; skipping the final save "
                "(resume falls back to the last vetted checkpoint)."
            )
            final_step = ckpt_mgr.latest_step()
        ckpt_mgr.close()
        if final_step is None:
            print(f"Preemption drain complete ({label}): no restorable checkpoint exists yet; a relaunch restarts.")
        else:
            print(f"Preemption drain complete ({label}): resume checkpoint at step {final_step}; exiting.")
        raise Preempted(f"graceful preemption at step {global_step}", step=final_step)

    return EpochOutcome(action="proceed", tail_healthy=tail_healthy)
