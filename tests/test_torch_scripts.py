"""The port's entry points on the CPU, against the JAX package's scripts.

* The chain ``pretrain → finetune → zeroshot → get_embeddings →
  generate_trajectories`` through each module's ``main(..., device="cpu")``
  on the committed converted sample cohort at a tiny width writes the files
  JAX's chain (``tests/test_scripts.py``) writes, and
  ``pretrain_config.yaml`` reads back to the resolved config.
* The sweep launcher: `collapse_cfg`, `sample_trial`, `propose_tpe`, the
  written trials and commands, `run_asha`'s rung decisions and the TPE
  launcher, each with a stub objective, equal JAX's for the same seed and
  history; a real ASHA run's promoted trial equals its uninterrupted run
  bit for bit.
* The subsets preparer writes JAX's command lists, naming the port's
  entry points.
* ``python -m eventstreamgpt_tpu_torch.scripts.pretrain --device cpu``
  exits with 85 on SIGTERM after a verifiable checkpoint, and a relaunch
  ends equal to an uninterrupted run.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import eventstreamgpt_tpu_torch.scripts.pretrain as pretrain_module
import scripts.launch_hp_sweep as jax_sweep
import scripts.pretrain as jax_pretrain_module
import scripts.prepare_pretrain_subsets as jax_subsets
from eventstreamgpt_tpu_torch.data.synthetic import write_synthetic_cache
from eventstreamgpt_tpu_torch.reliability import EXIT_PREEMPTED, ReliableCheckpointManager
from eventstreamgpt_tpu_torch.scripts import (
    finetune,
    generate_trajectories,
    get_embeddings,
    launch_hp_sweep,
    parse_cli,
    prepare_pretrain_subsets,
    pretrain,
    zeroshot,
)
from eventstreamgpt_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parents[1]
SAMPLE = REPO / "sample_data" / "converted" / "sample"
TASK = "high_utilization"
TINY = ["config.hidden_size=16", "config.head_dim=8", "config.num_attention_heads=2", "config.num_hidden_layers=2",
        "config.intermediate_size=16", "data_config.max_seq_len=8", "data_config.min_seq_len=2"]  # fmt: skip
OPT = ["optimization_config.init_lr=1e-3", "optimization_config.max_epochs=1", "optimization_config.batch_size=32",
       "optimization_config.validation_batch_size=32", "optimization_config.lr_frac_warmup_steps=0.5"]  # fmt: skip


def weights(save_dir) -> dict:
    return torch.load(Path(save_dir) / "pretrained_weights" / "model.pt", map_location="cpu", weights_only=True)


def same_weights(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ the chain
@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    save = root / "pretrain"
    out = {"save": save}
    out["pretrain"] = pretrain.main(
        ["--config", str(REPO / "configs" / "pretrain_base.yaml"), "--device", "cpu", f"data_config.save_dir={SAMPLE}",
         *TINY, *OPT, "final_validation_metrics_config.do_skip_all_metrics=true", f"save_dir={save}",
         "do_overwrite=true"])  # fmt: skip
    out["finetune"] = finetune.main([f"load_from_model_dir={save}", f"task_df_name={TASK}", *OPT, "do_overwrite=true"],
                                    device="cpu")  # fmt: skip
    out["zeroshot"] = zeroshot.main(
        [f"load_from_model_dir={save}", f"task_df_name={TASK}", "data_config_overrides.seq_padding_side=left",
         "config_overrides.max_seq_len=12", "task_specific_params.num_samples=2",
         "optimization_config.validation_batch_size=16", f"save_dir={root / 'zeroshot'}", "--device", "cpu"])  # fmt: skip
    out["embeddings"] = get_embeddings.main([f"load_from_model_dir={save}", f"task_df_name={TASK}"], device="cpu")
    out["trajectories"] = generate_trajectories.main(
        [f"load_from_model_dir={save}", "task_specific_params.num_samples=2", "task_specific_params.max_new_events=4",
         "optimization_config.validation_batch_size=16", f"save_dir={root / 'trajectories'}"], device="cpu")  # fmt: skip
    return out


def test_pretrain_main_writes_jax_files(chain):
    save = chain["save"]
    tuning_loss, tuning_metrics, held_out_metrics = chain["pretrain"]
    assert math.isfinite(tuning_loss) and tuning_metrics["tuning_loss"] == tuning_loss
    for name in ("pretrained_weights", "pretrain_config.yaml", "config.json", "tuning_metrics.json",
                 "held_out_metrics.json", "train_log.jsonl"):  # fmt: skip
        assert (save / name).exists(), name


def test_pretrain_config_yaml_reads_back_to_the_resolved_config(chain):
    save = chain["save"]
    written = yaml_subset.load_file(save / "pretrain_config.yaml")
    with open(save / "pretrain_config.yaml") as f:
        assert yaml.safe_load(f) == written
    assert written["save_dir"] == str(save) and written["experiment_dir"] == "./experiments"
    assert written["config"] == {"hidden_size": 16, "head_dim": 8, "num_attention_heads": 2, "num_hidden_layers": 2,
                                 "intermediate_size": 16}  # fmt: skip
    assert written["optimization_config"]["init_lr"] == 1e-3 and written["optimization_config"]["weight_decay"] == 0.01
    assert written["trainer_config"]["checkpoint_every_n_steps"] == 100
    cfg = pretrain_module.load_config(pretrain_module.PretrainConfig, overrides=[], defaults=written)
    assert pretrain_module.resolved_config(cfg) == written


def test_finetune_main_writes_jax_files(chain):
    tuning_loss, _, _ = chain["finetune"]
    assert math.isfinite(tuning_loss)
    out = chain["save"] / "finetuning" / TASK
    assert (out / "held_out_metrics.json").exists() and (out / "tuning_metrics.json").exists()


def test_zeroshot_main_writes_metrics(chain, tmp_path):
    tuning, held_out = chain["zeroshot"]
    assert "tuning_frac_unpredictable" in tuning and "held_out_frac_unpredictable" in held_out
    written = json.loads((chain["save"].parent / "zeroshot" / "zero_shot_held_out_metrics.json").read_text())
    assert written == held_out


def test_get_embeddings_main_writes_a_row_a_subject(chain):
    paths = chain["embeddings"]
    assert sorted(paths) == ["held_out", "train", "tuning"]
    emb = np.load(paths["tuning"])
    assert emb.ndim == 2 and emb.shape[1] == 16 and np.isfinite(emb).all()


def test_generate_trajectories_main_writes_samples(chain):
    out = chain["trajectories"]
    for split in ("tuning", "held_out"):
        assert sorted(p.name for p in (out / split).iterdir()) == [f"sample_{i}_local_rank_0.npz" for i in range(2)]


def test_entry_point_without_device_is_the_card(tmp_path):
    """No ``--device``: the card, which this machine may lack; never a fallback."""
    args = [f"data_config.save_dir={SAMPLE}", *TINY, *OPT, f"save_dir={tmp_path}", "do_final_validation_on_metrics=false"]
    if torch.cuda.is_available():
        assert parse_cli(args)[2] is None
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            pretrain.main(args)
    with pytest.raises(ValueError, match="disagree"):
        parse_cli(["--device", "cpu"], device="cuda")
    assert parse_cli(["--config", "c.yaml", "a=1", "--device", "cpu"]) == ("c.yaml", ["a=1"], "cpu")


# ------------------------------------------------------------------ the sweep
SWEEP_PARAMS = {
    "config": {"hidden_size": {"value": 16}, "head_dim": {"min": 2, "max": 64},
               "seq_attention_types": {"values": [["global"], ["global", "local"]]},
               "resid_dropout": {"min": 0.0, "max": 0.5}},
    "optimization_config": {"init_lr": {"distribution": "log_uniform_values", "min": 1.0e-6, "max": 1.0e-2},
                            "batch_size": {"min": 8, "max": 128}, "patience": {"value": None}},
}  # fmt: skip


def test_collapse_and_sample_as_jax():
    ours, theirs = launch_hp_sweep.collapse_cfg("", SWEEP_PARAMS), jax_sweep.collapse_cfg("", SWEEP_PARAMS)
    assert ours == theirs and "optimization_config.patience" not in ours
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        assert launch_hp_sweep.sample_trial(ours, r1) == jax_sweep.sample_trial(theirs, r2)
    with pytest.raises(TypeError, match="Misconfigured"):
        launch_hp_sweep.collapse_cfg("foo", None)


@pytest.mark.parametrize("n_history", [0, 3, 4, 12, 30])
def test_propose_tpe_as_jax(n_history):
    params = launch_hp_sweep.collapse_cfg("", SWEEP_PARAMS)
    hist_rng = np.random.default_rng(n_history)
    history = []
    for i in range(n_history):
        t = launch_hp_sweep.sample_trial(params, hist_rng)
        history.append((t, float("nan") if i % 7 == 6 else (np.log10(t["optimization_config.init_lr"]) + 3) ** 2))
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(5):
        assert launch_hp_sweep.propose_tpe(params, history, r1) == jax_sweep.propose_tpe(params, history, r2)


def test_written_trials_and_commands_as_jax(tmp_path):
    ours = launch_hp_sweep.main([f"sweep_dir={tmp_path / 'a'}", "n_trials=3"])
    theirs = jax_sweep.main([f"sweep_dir={tmp_path / 'b'}", "n_trials=3"])
    trials_a = json.loads((tmp_path / "a" / "sweep_trials.json").read_text())
    trials_b = json.loads((tmp_path / "b" / "sweep_trials.json").read_text())
    assert [{k: v for k, v in t.items() if k != "save_dir"} for t in trials_a] == [
        {k: v for k, v in t.items() if k != "save_dir"} for t in trials_b]  # fmt: skip
    assert [c.replace("eventstreamgpt_tpu_torch.scripts", "scripts").replace(str(tmp_path / "a"), "D") for c in ours] == [
        c.replace(str(tmp_path / "b"), "D") for c in theirs]  # fmt: skip
    assert all(c.startswith("python -m eventstreamgpt_tpu_torch.scripts.pretrain ") for c in ours)
    for trial in trials_a:  # every sampled trial's overrides load into the port's PretrainConfig
        cfg = pretrain_module.load_config(pretrain_module.PretrainConfig, overrides=launch_hp_sweep._trial_args(trial))
        assert "head_dim" in cfg.config and 8 <= cfg.optimization_config.batch_size <= 128
        assert isinstance(cfg.build_model_config().resid_dropout, float)


def stub_objective(args, device=None):
    """A deterministic stand-in for `pretrain.main`: a function of the args."""
    kv = dict(a.split("=", 1) for a in args)
    lr = float(kv["optimization_config.init_lr"])
    return (np.log10(lr) + 3.0) ** 2 + 1.0 / int(kv["optimization_config.max_epochs"]), {}, {}


def test_run_asha_decisions_as_jax(tmp_path):
    cfg = {"early_terminate": {"type": "hyperband", "min_iter": 1, "eta": 2}, "metric": {"name": "tuning_loss"}}
    rng = np.random.default_rng(3)
    trials = [{"optimization_config.init_lr": float(10 ** rng.uniform(-5, -1)), "optimization_config.max_epochs": 4,
               "optimization_config.max_training_steps": 40, "save_dir": f"t{i}"} for i in range(5)]  # fmt: skip
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = launch_hp_sweep.run_asha(trials, cfg, tmp_path / "a", stub_objective)
    theirs = jax_sweep.run_asha(trials, cfg, tmp_path / "b", stub_objective)
    assert ours == theirs
    assert sorted(r["status"] for r in ours) == ["completed", "completed", "stopped_rung_0", "stopped_rung_0",
                                                 "stopped_rung_1"]  # fmt: skip


def test_tpe_launcher_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(pretrain_module, "main", stub_objective)
    monkeypatch.setattr(jax_pretrain_module, "main", lambda args: stub_objective(args))
    spec = {"program": "pretrain.py", "method": "bayes", "n_trials": 8, "seed": 3, "metric": {"name": "tuning_loss"},
            "parameters": {"optimization_config": {"init_lr": {"distribution": "log_uniform_values", "min": 1.0e-5,
                                                               "max": 1.0e-1}, "max_epochs": {"value": 2}}}}  # fmt: skip
    results = []
    for name, main in (("a", launch_hp_sweep.main), ("b", jax_sweep.main)):
        fp = tmp_path / f"{name}.yaml"
        fp.write_text(yaml_subset.dump({**spec, "sweep_dir": str(tmp_path / name)}))
        results.append([{k: v for k, v in r.items() if k != "save_dir"} for r in main(["--run", "--config", str(fp)])])
    assert results[0] == results[1] and len(results[0]) == 8


ASHA_SWEEP = """
program: pretrain.py
method: random
n_trials: 3
seed: 1
sweep_dir: "{sweep_dir}"
metric: {{goal: minimize, name: tuning_loss}}
early_terminate: {{type: hyperband, min_iter: 1, eta: 3}}
parameters:
  config:
    hidden_size: {{value: 16}}
    head_dim: {{value: 8}}
    num_attention_heads: {{value: 2}}
    num_hidden_layers: {{value: 1}}
    intermediate_size: {{value: 16}}
    resid_dropout: {{min: 0.0, max: 0.3}}
  optimization_config:
    init_lr: {{distribution: log_uniform_values, min: 1.0e-4, max: 1.0e-2}}
    max_epochs: {{value: 3}}
    batch_size: {{value: 32}}
    validation_batch_size: {{value: 32}}
    lr_frac_warmup_steps: {{value: 0.1}}
  data_config:
    save_dir: {{value: "{data_dir}"}}
    max_seq_len: {{value: 8}}
    min_seq_len: {{value: 2}}
  final_validation_metrics_config:
    do_skip_all_metrics: {{value: true}}
"""


def test_asha_promoted_trial_equals_its_uninterrupted_run(tmp_path):
    fp = tmp_path / "sweep.yaml"
    fp.write_text(ASHA_SWEEP.format(sweep_dir=tmp_path / "sweep", data_dir=SAMPLE))
    results = launch_hp_sweep.main(["--run", "--config", str(fp), "--device", "cpu"])
    stopped = [r for r in results if r["status"] != "completed"]
    (survivor,) = [r for r in results if r["status"] == "completed"]
    assert len(stopped) == 2 and all(r["status"] == "stopped_rung_0" and r["epochs_trained"] == 1 for r in stopped)
    assert survivor["epochs_trained"] == 3 and [g["epochs"] for g in survivor["rungs"]] == [1, 3]
    rung0 = {r["trial"]: r["rungs"][0]["tuning_loss"] for r in results}
    assert survivor["trial"] == min(rung0, key=rung0.get)

    trial = {k: v for k, v in survivor.items() if "." in k}
    args = launch_hp_sweep._trial_args(trial, {"optimization_config.max_epochs": 3,
                                               "optimization_config.max_training_steps": launch_hp_sweep._full_horizon(trial)[1],
                                               "save_dir": str(tmp_path / "uninterrupted")})  # fmt: skip
    ref_loss, _, _ = pretrain.main(args, device="cpu")
    assert ref_loss == survivor["tuning_loss"]
    assert same_weights(weights(survivor["save_dir"]), weights(tmp_path / "uninterrupted"))


# --------------------------------------------------------- the subsets preparer
def test_subsets_preparer_commands_as_jax(tmp_path):
    results = []
    for name, main in (("a", prepare_pretrain_subsets.main), ("b", jax_subsets.main)):
        initial = tmp_path / name / "initial"
        initial.mkdir(parents=True)
        (initial / "pretrain_config.yaml").write_text(yaml.safe_dump({"experiment_dir": str(tmp_path / name / "exp"),
                                                                      "seed": 1, "optimization_config": {"init_lr": 1e-05}}))  # fmt: skip
        commands = main([f"initial_model_path={initial}", "subset_sizes=[10, 20]", "seeds=2", "experiment_name=subsets",
                         "few_shot_commands.fine_tuning_task_names=[taskA]", "zero_shot_commands.fine_tuning_task_names=[taskA]",
                         "get_embeddings_commands.fine_tuning_task_names=[taskA]"])  # fmt: skip
        results.append({k: [c.replace(str(tmp_path / name), "D") for c in v] for k, v in commands.items()})
        source = tmp_path / name / "exp" / "subsets" / "subset_10" / "seed_1" / "pretrain_config_source.yaml"
        assert yaml.safe_load(source.read_text()) == yaml_subset.load_file(source)
        assert yaml_subset.load_file(source)["data_config"] == {"train_subset_size": 10, "train_subset_seed": 1}
        assert yaml_subset.load_file(source)["optimization_config"]["init_lr"] == 1e-05
    ours, theirs = results
    assert sorted(ours) == sorted(theirs) == ["finetune", "get_embeddings", "pretrain", "zeroshot"]
    assert len(ours["pretrain"]) == 4 and len(ours["finetune"]) == 4 * 8
    for k in ours:
        assert [c.replace("python -m eventstreamgpt_tpu_torch.scripts.", "python -m scripts.") for c in ours[k]] == theirs[k]


def test_written_commands_carry_the_device(tmp_path):
    """A caller's ``--device`` is passed on to every command the launcher and
    the preparer write (JAX's commands have no device to pass)."""
    commands = launch_hp_sweep.main([f"sweep_dir={tmp_path / 'sweep'}", "n_trials=2", "--device", "cpu"])
    initial = tmp_path / "initial"
    initial.mkdir()
    (initial / "pretrain_config.yaml").write_text(yaml_subset.dump({"experiment_dir": str(tmp_path / "exp")}))
    prepared = prepare_pretrain_subsets.main([f"initial_model_path={initial}", "subset_sizes=[10]", "seeds=1",
                                              "zero_shot_commands.fine_tuning_task_names=[taskA]"], device="cpu")  # fmt: skip
    lines = commands + [c for cmds in prepared.values() for c in cmds]
    assert len(lines) == 4 and all(c.startswith("python -m eventstreamgpt_tpu_torch.scripts.") for c in lines)
    assert all(c.endswith(" --device cpu") for c in lines)


# ---------------------------------------------------- SIGTERM and the exit code
def train_records(save_dir) -> dict:
    recs = {}
    for line in (Path(save_dir) / "train_log.jsonl").open():
        r = json.loads(line)
        if r["split"] == "train":
            recs.setdefault((r["epoch"], r["step"]), []).append(r["train_loss"])
    return recs


def test_sigterm_exits_85_and_a_relaunch_ends_as_an_uninterrupted_run(tmp_path):
    data = write_synthetic_cache(tmp_path / "cache", {"train": 24, "tuning": 8, "held_out": 8}, n_event_types=8,
                                 n_labs=32, n_meds=8, n_static=4, mean_seq_len=8, max_seq_len=16, seed=0)  # fmt: skip

    def config(save_dir) -> Path:
        cfg = {"seed": 1, "config": {"hidden_size": 16, "head_dim": 8, "num_attention_heads": 2, "num_hidden_layers": 1,
                                     "intermediate_size": 16},
               "optimization_config": {"init_lr": 1e-3, "max_epochs": 30, "batch_size": 4, "validation_batch_size": 8,
                                       "lr_frac_warmup_steps": 0.5, "patience": None},
               "data_config": {"save_dir": str(data), "max_seq_len": 8, "min_seq_len": 2},
               "pretraining_metrics_config": {"do_skip_all_metrics": True}, "experiment_dir": str(save_dir),
               "save_dir": str(save_dir), "do_final_validation_on_metrics": False,
               "trainer_config": {"log_every_n_steps": 1, "checkpoint_every_n_steps": 2, "max_checkpoints_to_keep": 10}}  # fmt: skip
        fp = tmp_path / f"{save_dir.name}.yaml"
        fp.write_text(yaml.safe_dump(cfg))
        return fp

    def launch(fp, log):
        return subprocess.Popen([sys.executable, "-m", "eventstreamgpt_tpu_torch.scripts.pretrain", "--config", str(fp),
                                 "--device", "cpu"], cwd=REPO, stdout=open(log, "w"), stderr=subprocess.STDOUT,
                                env={**os.environ, "PYTHONPATH": str(REPO)})  # fmt: skip

    save = tmp_path / "cli_run"
    fp = config(save)
    proc = launch(fp, tmp_path / "run1.log")
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"the run ended before SIGTERM: {(tmp_path / 'run1.log').read_text()[-2000:]}"
        if (save / "train_log.jsonl").exists() and (save / "train_log.jsonl").read_text().count("\n") >= 2:
            break
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=300)
    log1 = (tmp_path / "run1.log").read_text()
    assert rc == EXIT_PREEMPTED, (rc, log1[-2000:])
    assert f"exiting {EXIT_PREEMPTED} for reschedule" in log1

    mgr = ReliableCheckpointManager(save / "model_checkpoints")
    final_step = mgr.latest_step()
    assert final_step is not None and mgr._verify_status(final_step) == "verified"
    mgr.close()
    assert final_step >= max(s for _, s in train_records(save))

    proc2 = launch(fp, tmp_path / "run2.log")
    rc2 = proc2.wait(timeout=300)
    log2 = (tmp_path / "run2.log").read_text()
    assert rc2 == 0, log2[-2000:]
    assert f"Resumed from checkpoint at step {final_step}" in log2

    ref = tmp_path / "ref_run"
    pretrain.main(["--config", str(config(ref))], device="cpu")
    assert same_weights(weights(save), weights(ref))
    recs, ref_recs = train_records(save), train_records(ref)
    assert set(recs) == set(ref_recs) and all(loss == ref_recs[k][0] for k, v in recs.items() for loss in v)
