"""Hyperparameter sweep launcher: random search, TPE and ASHA early stopping.

Counterpart: the repository's ``scripts/launch_hp_sweep.py``, the same
sweep-config dialect (nested parameter groups with ``value`` / ``values`` /
``min``+``max`` [+ ``distribution: log_uniform_values``] leaves, collapsed to
dotted overrides by `collapse_cfg`) and the same draws for the same seed:
without ``--run`` it samples ``n_trials`` configurations and writes their
`scripts.pretrain` commands; with ``--run`` it runs them in-process
(``method: bayes`` proposes each from TPE, Tree-structured Parzen
Estimators, over the trials so far). With ``early_terminate: {type:
hyperband, min_iter, eta}`` the trials run as ASHA over epochs: rungs of
``min_iter * eta^k`` epochs, the top ``1/eta`` promoted after each. A rung
is a fresh `scripts.pretrain.main` that resumes from the trial's newest
resume checkpoint, its LR schedule pinned to the trial's full horizon
(`_full_horizon`), so a promoted trial ends bit for bit as the run it would
have been without early stopping. ``--device cpu`` is handed to every
trial.

Usage::

    python -m eventstreamgpt_tpu_torch.scripts.launch_hp_sweep \
        --config configs/hyperparameter_sweep_base.yaml n_trials=10 sweep_dir=./exp/sweep [--run] [--device cpu]
"""

from __future__ import annotations

import functools
import json
import math
import shlex
import sys
from pathlib import Path
from typing import Any

import numpy as np

from ..utils.config_tool import CONFIGS_DIR, deep_merge, load_yaml_with_defaults, parse_overrides, resolve_interpolations
from . import parse_cli

PRETRAIN_COMMAND = "python -m eventstreamgpt_tpu_torch.scripts.pretrain"

WANDB_SWEEP_KEYS = {"value", "values", "min", "max", "distribution"}


def collapse_cfg(k: str, v: dict[str, Any]) -> dict[str, Any]:
    """Collapses nested parameter groups to dotted keys.

    Examples:
        >>> collapse_cfg("bar", {"values": "vals"})
        {'bar': {'values': 'vals'}}
        >>> collapse_cfg("foo", {"bar": {"baz": {"values": "vals"}}, "biz": {"max": "MX"}})
        {'foo.bar.baz': {'values': 'vals'}, 'foo.biz': {'max': 'MX'}}
        >>> collapse_cfg("foo", {"bar": {"value": None}})
        {}
        >>> collapse_cfg("foo", None)
        Traceback (most recent call last):
            ...
        TypeError: Misconfigured @ foo: None (<class 'NoneType'>) is not a dict!
    """
    if type(v) is not dict:
        raise TypeError(f"Misconfigured @ {k}: {v} ({type(v)}) is not a dict!")
    if WANDB_SWEEP_KEYS.intersection(v.keys()):
        if set(v.keys()) == {"value"} and v["value"] is None:
            return {}
        return {k: v}

    out: dict[str, Any] = {}
    for kk, vv in v.items():
        out.update(collapse_cfg(f"{k}.{kk}" if k else kk, vv))
    return out


def sample_param(spec: dict[str, Any], rng: np.random.Generator) -> Any:
    """Draws one value from a W&B-dialect parameter spec."""
    if "value" in spec:
        v = spec["value"]
        return None if v == "null" else v
    if "values" in spec:
        return spec["values"][int(rng.integers(len(spec["values"])))]
    lo, hi = spec["min"], spec["max"]
    if spec.get("distribution") == "log_uniform_values":
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    if isinstance(lo, int) and isinstance(hi, int):
        return int(rng.integers(lo, hi + 1))
    return float(rng.uniform(lo, hi))


def sample_trial(parameters: dict[str, dict], rng: np.random.Generator) -> dict[str, Any]:
    """One random configuration as a dotted-key → value mapping."""
    return {k: sample_param(spec, rng) for k, spec in parameters.items()}


# ------------------------------------------------------------- bayes (TPE)
TPE_STARTUP_TRIALS = 4
TPE_GAMMA = 0.25
TPE_CANDIDATES = 24


def _tpe_numeric(spec, good_vals, bad_vals, rng):
    """Propose a numeric value maximizing the TPE density ratio l(x)/g(x).

    Kernel density over observed values (bandwidth = range / sqrt(n)), in log
    space for log-uniform specs; candidates are drawn from the good-KDE and
    scored against the bad-KDE — the standard Bergstra et al. (2011) TPE
    recipe with independent per-parameter models.
    """
    lo, hi = spec["min"], spec["max"]
    log_space = spec.get("distribution") == "log_uniform_values"
    tf = np.log if log_space else (lambda x: np.asarray(x, dtype=float))
    inv = np.exp if log_space else (lambda x: x)
    lo_t, hi_t = float(tf(lo)), float(tf(hi))
    span = hi_t - lo_t
    if span <= 0:
        # Degenerate (min == max) pins the parameter; legal in the dialect.
        return sample_param(spec, rng)

    # Both densities carry a uniform floor (a fraction of the uniform
    # density over the range): where neither side has observations — e.g.
    # at the boundaries, where clipping piles candidate mass — the ratio
    # damps toward 1 instead of exploding and dragging proposals to the
    # range edges.
    eps = 0.25 / span

    def bandwidth(n_obs):
        # Cap at span/4: with one observation an uncapped span-wide kernel
        # clips nearly every candidate onto the range boundaries.
        return float(np.clip(span / np.sqrt(n_obs), span * 1e-3, span / 4.0))

    def kde(obs, x):
        obs = np.asarray(obs, dtype=float)
        bw = bandwidth(len(obs))
        d = (x[:, None] - obs[None, :]) / bw
        return np.exp(-0.5 * d * d).sum(axis=1) / (len(obs) * bw) + eps

    g_obs = tf(np.asarray(good_vals, dtype=float))
    # Half the candidates come from the good KDE (exploitation), half
    # uniform over the range (exploration + no boundary pileup from clips).
    n_kde = TPE_CANDIDATES // 2
    centers = g_obs[rng.integers(len(g_obs), size=n_kde)]
    bw = bandwidth(len(g_obs))
    cands = np.concatenate(
        [
            np.clip(centers + rng.normal(0.0, bw, size=n_kde), lo_t, hi_t),
            rng.uniform(lo_t, hi_t, size=TPE_CANDIDATES - n_kde),
        ]
    )
    score = kde(g_obs, cands) / kde(tf(np.asarray(bad_vals, dtype=float)), cands)
    best = float(inv(cands[int(np.argmax(score))]))
    if isinstance(lo, int) and isinstance(hi, int) and not log_space:
        return int(round(np.clip(best, lo, hi)))
    return float(np.clip(best, lo, hi))


def _tpe_categorical(spec, good_vals, bad_vals, rng):
    """Propose the category maximizing smoothed good/bad frequency ratio."""
    choices = spec["values"]

    def freq(vals):
        counts = np.array([sum(1 for v in vals if v == c) for c in choices], dtype=float)
        return (counts + 1.0) / (counts.sum() + len(choices))

    ratio = freq(good_vals) / freq(bad_vals)
    return choices[int(np.argmax(ratio))]


def propose_tpe(
    parameters: dict[str, dict],
    history: list[tuple[dict[str, Any], float]],
    rng: np.random.Generator,
) -> dict[str, Any]:
    """One configuration proposed by Tree-structured Parzen Estimators.

    ``history`` is ``[(trial, loss), ...]`` with lower losses better (the
    caller negates maximize-goal metrics). Falls back to random sampling
    until ``TPE_STARTUP_TRIALS`` observations exist — the local stand-in for
    the reference sweep's W&B ``method: bayes`` service.
    """
    done = [(t, l) for t, l in history if l is not None and np.isfinite(l)]
    if len(done) < TPE_STARTUP_TRIALS:
        return sample_trial(parameters, rng)
    done.sort(key=lambda tl: tl[1])
    # n_good < len(done) always holds for len >= 2, so bad is never empty.
    n_good = max(int(np.ceil(TPE_GAMMA * len(done))), 1)
    good, bad = done[:n_good], done[n_good:]

    out = {}
    for k, spec in parameters.items():
        if "value" in spec:
            out[k] = sample_param(spec, rng)
            continue
        g = [t.get(k) for t, _ in good if t.get(k) is not None]
        b = [t.get(k) for t, _ in bad if t.get(k) is not None]
        if not g or not b:
            out[k] = sample_param(spec, rng)
        elif "values" in spec:
            out[k] = _tpe_categorical(spec, g, b, rng)
        else:
            out[k] = _tpe_numeric(spec, g, b, rng)
    return out


def _trial_args(trial: dict[str, Any], extra: dict[str, Any] | None = None) -> list[str]:
    merged = {**trial, **(extra or {})}
    return [
        f"{k}={json.dumps(v) if not isinstance(v, str) else v}"
        for k, v in merged.items()
        if v is not None
    ]


def _full_horizon(trial: dict[str, Any]) -> tuple[int, int]:
    """``(full max_epochs, full max_training_steps)`` of a trial.

    Every rung's LR schedule sees the trial's full horizon, else a promoted
    trial's warmup and decay would differ from its uninterrupted run. A
    trial's own ``optimization_config.max_training_steps`` is kept;
    otherwise the horizon is `models.config.OptimizationConfig.set_to_dataset`'s,
    ``ceil(len / batch) * max_epochs`` on the trial's train `TorchDataset`,
    or the packed-batch count (`TorchDataset.packed_batch_count`, with
    `training.pretrain.train`'s row length and seed) when the trial packs
    its batches or shards its context.
    """
    from ..data.config import PytorchDatasetConfig
    from ..data.torch_dataset import TorchDataset
    from ..models.config import OptimizationConfig, StructuredTransformerConfig

    oc_defaults = OptimizationConfig()
    max_epochs = int(trial.get("optimization_config.max_epochs", oc_defaults.max_epochs))

    explicit_steps = trial.get("optimization_config.max_training_steps")
    if explicit_steps is not None:
        return max_epochs, int(explicit_steps)

    batch_size = int(trial.get("optimization_config.batch_size", oc_defaults.batch_size))
    dc_kwargs = {k.split(".", 1)[1]: v for k, v in trial.items() if k.startswith("data_config.")}
    ds = TorchDataset(PytorchDatasetConfig(**dc_kwargs), "train")

    n_cp = int(trial.get("trainer_config.context_parallel_shards") or 1)
    if bool(trial.get("trainer_config.use_packed_batches")) or n_cp > 1:
        configured_msl = int(trial.get("config.max_seq_len") or StructuredTransformerConfig().max_seq_len)
        packed_L = int(trial.get("trainer_config.packed_seq_len") or max(configured_msl, ds.max_seq_len))
        steps_per_epoch = ds.packed_batch_count(batch_size, seq_len=packed_L, seed=int(trial.get("seed", 1)))
    else:
        steps_per_epoch = int(math.ceil(len(ds) / batch_size))
    return max_epochs, steps_per_epoch * max_epochs


def run_asha(
    trials: list[dict[str, Any]],
    cfg: dict[str, Any],
    sweep_dir: Path,
    pretrain_main,
) -> list[dict[str, Any]]:
    """ASHA over epochs: run rungs, keep top 1/eta, resume survivors."""
    et = cfg["early_terminate"]
    if et.get("type") != "hyperband":
        raise ValueError(f"Unsupported early_terminate type: {et.get('type')}")
    eta = int(et.get("eta", 3))
    min_iter = max(int(et.get("min_iter", 1)), 1)
    metric_name = cfg["metric"]["name"]
    # goal: minimize (default) or maximize — promotion must follow it.
    goal = cfg["metric"].get("goal", "minimize")
    if goal not in ("minimize", "maximize"):
        raise ValueError(f"Unsupported metric goal: {goal}")
    sign = 1.0 if goal == "minimize" else -1.0

    def rank_key(t):
        v = state[t][metric_name]
        # None and NaN (diverged trial) both rank last.
        return sign * v if v is not None and np.isfinite(v) else float("inf")

    state = [
        {
            "trial": t,
            **trial,
            metric_name: None,
            "epochs_trained": 0,
            "status": "alive",
            "rungs": [],
        }
        for t, trial in enumerate(trials)
    ]
    horizons = [_full_horizon(trial) for trial in trials]

    alive = list(range(len(trials)))
    rung = 0
    while alive:
        target_epochs = min_iter * eta**rung
        for t in alive:
            full_epochs, full_steps = horizons[t]
            run_to = min(target_epochs, full_epochs)
            print(f"--- ASHA rung {rung}: trial {t} -> epoch {run_to}/{full_epochs} ---")
            tuning_loss, _, _ = pretrain_main(
                _trial_args(
                    trials[t],
                    {
                        "optimization_config.max_epochs": run_to,
                        "optimization_config.max_training_steps": full_steps,
                        "do_resume_from_checkpoint": True,
                        "do_overwrite": True,
                    },
                )
            )
            state[t][metric_name] = tuning_loss
            state[t]["epochs_trained"] = run_to
            state[t]["rungs"].append({"rung": rung, "epochs": run_to, metric_name: tuning_loss})
            if run_to >= full_epochs:
                state[t]["status"] = "completed"

        alive = [t for t in alive if state[t]["status"] == "alive"]
        if not alive:
            break
        # Promote the top ceil(len/eta) by the metric; kill the rest.
        order = sorted(alive, key=rank_key)
        n_keep = max((len(order) + eta - 1) // eta, 1)
        for t in order[n_keep:]:
            state[t]["status"] = f"stopped_rung_{rung}"
        alive = order[:n_keep]
        rung += 1

    results = sorted(
        state,
        key=lambda r: (
            sign * r[metric_name]
            if r[metric_name] is not None and np.isfinite(r[metric_name])
            else float("inf")
        ),
    )
    (sweep_dir / "sweep_results.json").write_text(json.dumps(results, indent=2))
    print(f"Best trial: {results[0]}")
    return results


def main(argv: list[str] | None = None, device=None):
    """Without ``--run``: writes ``sweep_trials.json`` and ``sweep_commands.sh``
    and returns the commands; with it: runs the trials and returns the
    ranked results (``sweep_results.json``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    do_run = "--run" in argv
    if do_run:
        argv.remove("--run")
    yaml_fp, argv, device = parse_cli(argv, device)
    if yaml_fp is None:
        yaml_fp = CONFIGS_DIR / "hyperparameter_sweep_base.yaml"

    cfg = load_yaml_with_defaults(yaml_fp)
    deep_merge(cfg, parse_overrides(argv))
    cfg = resolve_interpolations(cfg)

    n_trials = int(cfg.get("n_trials", 10))
    seed = int(cfg.get("seed", 1))
    sweep_dir = Path(cfg.get("sweep_dir", "./sweep"))
    sweep_dir.mkdir(parents=True, exist_ok=True)

    parameters = collapse_cfg("", cfg["parameters"])
    rng = np.random.default_rng(seed)
    use_tpe = do_run and cfg.get("method") == "bayes" and not cfg.get("early_terminate")

    commands = []
    trials = []
    if not use_tpe:
        # TPE proposes trials adaptively inside the run loop — pre-sampled
        # configs would be written but never executed, which is worse than
        # writing nothing; the executed trials land in sweep_trials.json
        # after the run instead.
        for t in range(n_trials):
            trial = sample_trial(parameters, rng)
            trial["save_dir"] = str(sweep_dir / f"trial_{t}")
            trials.append(trial)
            args = " ".join(f"{k}={shlex.quote(json.dumps(v) if not isinstance(v, str) else v)}"
                            for k, v in trial.items() if v is not None)
            commands.append(f"{PRETRAIN_COMMAND} {args}" + (f" --device {device}" if device is not None else ""))

        (sweep_dir / "sweep_trials.json").write_text(json.dumps(trials, indent=2))
        (sweep_dir / "sweep_commands.sh").write_text("\n".join(commands) + "\n")
        print(f"Wrote {n_trials} trial commands to {sweep_dir / 'sweep_commands.sh'}")

    if do_run:
        from . import pretrain as pretrain_module

        pretrain_main = functools.partial(pretrain_module.main, device=device)

        if cfg.get("early_terminate"):
            # Rungs need batches of comparable trials, so ASHA keeps random
            # proposals; bayes (TPE) applies to the sequential path below.
            return run_asha(trials, cfg, sweep_dir, pretrain_main)

        metric_name = cfg["metric"]["name"]
        goal = cfg["metric"].get("goal", "minimize")
        sign = 1.0 if goal == "minimize" else -1.0
        history: list[tuple[dict[str, Any], float | None]] = []

        def rank(r):
            v = r.get(metric_name)
            # Diverged (NaN) trials rank last, like missing ones — nan would
            # otherwise poison the sort and could print as "Best trial".
            return sign * v if v is not None and np.isfinite(v) else float("inf")

        results = []
        for t in range(n_trials):
            if use_tpe:
                # Adaptive search (the W&B bayes analog): propose from TPE
                # fitted to the observed objective values so far.
                trial = propose_tpe(parameters, history, rng)
                trial["save_dir"] = str(sweep_dir / f"trial_{t}")
                trials.append(trial)
            else:
                trial = trials[t]
            print(f"--- sweep trial {t} ({cfg.get('method', 'random')}) ---")
            tuning_loss, _, _ = pretrain_main(_trial_args(trial))
            history.append((trial, sign * tuning_loss if tuning_loss is not None else None))
            results.append({"trial": t, metric_name: tuning_loss, **trial})
        if use_tpe:
            (sweep_dir / "sweep_trials.json").write_text(json.dumps(trials, indent=2))
        results.sort(key=rank)
        (sweep_dir / "sweep_results.json").write_text(json.dumps(results, indent=2))
        print(f"Best trial: {results[0]}")
        return results

    return commands


if __name__ == "__main__":
    main()
