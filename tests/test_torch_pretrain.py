"""The port's `train(cfg)` against JAX's, and its recovery paths, on the CPU.

JAX's ``train(cfg)`` runs once (module fixture) on ``sample_data`` with a
tiny fp32 model and no dropout, checkpointing every 4 steps; its step-8
resume state (parameters, AdamW moments and count, step; restored with
orbax here) goes through `convert.train_state_from_jax` into a port
checkpoint, and the port's ``train(cfg, device="cpu")`` over the converted
cache resumes from it. From there both train the same batches, so the port
must match JAX's run: every later logged loss and tuning loss within 1e-5,
the final parameters within 1e-5 but for at most 0.1% of the elements
(within 1e-4; the tolerances of ``tests/test_torch_train.py``'s AdamW
steps), and the final tuning and held-out metrics (loss, loss parts,
classification; the sampled metrics are off) within 1e-5, under the same
keys; the port's ``config.json`` loads in both packages.

Port only, bit for bit against an uninterrupted port run: a mid-epoch
resume, a walk-back over a corrupted step, a scripted SIGTERM (``Preempted``,
then the relaunch), the host path against the resident one; a poisoned batch
rolls back and ends finite; early stopping stops where JAX's stops; gradient
accumulation against JAX's ``MultiSteps`` step; a restore writes in place;
each refusal names its ROADMAP item.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from eventstreamgpt_tpu.data import PytorchDatasetConfig as JaxDatasetConfig
from eventstreamgpt_tpu.models.config import MetricsConfig as JaxMetricsConfig
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.training import PretrainConfig as JaxPretrainConfig
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_train_step as jax_make_train_step
from eventstreamgpt_tpu.training import train as jax_train
from eventstreamgpt_tpu_torch.analysis import CompileGuard, RecompileError
from eventstreamgpt_tpu_torch.convert import export_params, train_state_from_jax
from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
from eventstreamgpt_tpu_torch.data.dl_cache import convert_dl_cache
from eventstreamgpt_tpu_torch.models.config import MetricsConfig, OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.reliability import Fault, FaultPlan, Preempted, corrupt_checkpoint_step, fault_plan
from eventstreamgpt_tpu_torch.reliability.integrity import ReliableCheckpointManager
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, load_pretrained, make_train_step
from eventstreamgpt_tpu_torch.training.pretrain import (
    PretrainConfig,
    TrainState,
    load_train_state,
    make_chunked_train_step,
    train,
    train_state_dict,
)

from .test_torch_train import CASES as _  # noqa: F401  (the shared fixtures' module)
from .test_torch_train import OPT, PROCESSED, SMALL, flat, port_model, to_torch

RESUME_AT, CKPT_EVERY = 8, 4
FINAL = {s: {"loss_parts": True, "classification": True} for s in ("tuning", "held_out")}
TOL = dict(rtol=1e-5, atol=1e-5)


def settings(save_dir, data_dir, *, max_epochs=2, patience=None, init_lr=1e-3, train_subset_size="FULL",
             train_subset_seed=None, **tc) -> dict:  # fmt: skip
    return dict(
        config=dict(SMALL),
        seed=1,
        save_dir=str(save_dir),
        optimization_config=dict(init_lr=init_lr, batch_size=8, validation_batch_size=8, max_epochs=max_epochs,
                                 lr_frac_warmup_steps=0.1, patience=patience),  # fmt: skip
        data_config=dict(save_dir=str(data_dir), max_seq_len=16, min_seq_len=2, train_subset_size=train_subset_size,
                         train_subset_seed=train_subset_seed),  # fmt: skip
        final_validation_metrics_config=dict(include_metrics=FINAL),
        trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": CKPT_EVERY,
                        "max_checkpoints_to_keep": 20, **tc},  # fmt: skip
    )


def jax_cfg(save_dir, **kw) -> JaxPretrainConfig:
    s = settings(save_dir, PROCESSED, **kw)
    return JaxPretrainConfig(
        **{k: v for k, v in s.items() if not k.endswith("_config")},
        optimization_config=JaxOptimizationConfig(**s["optimization_config"]),
        data_config=JaxDatasetConfig(**s["data_config"]),
        final_validation_metrics_config=JaxMetricsConfig(include_metrics=FINAL),
        trainer_config=s["trainer_config"],
    )


def port_cfg(save_dir, data_dir, **kw) -> PretrainConfig:
    return PretrainConfig(**settings(save_dir, data_dir, **kw))


def read_log(save_dir) -> list[dict]:
    return [json.loads(line) for line in (Path(save_dir) / "train_log.jsonl").open()]


def losses(save_dir, split="train") -> dict:
    key = "train_loss" if split == "train" else "tuning_loss"
    return {(r["epoch"], r["step"]): r[key] for r in read_log(save_dir) if r["split"] == split}


def assert_params_close(got: dict, want: dict) -> None:
    """test_torch_train's AdamW tolerance: every element within 1e-4, all but
    0.1% of them (over the whole model) within 1e-5."""
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())


def restore_jax(ckpt_dir, step) -> dict:
    return ocp.PyTreeCheckpointer().restore(Path(ckpt_dir) / str(step) / "default")


@pytest.fixture(scope="module")
def conv(tmp_path_factory):
    return convert_dl_cache(PROCESSED, tmp_path_factory.mktemp("pretrain_cache"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's run: its save_dir and its returned metrics."""
    save = tmp_path_factory.mktemp("jax_run")
    out = jax_train(jax_cfg(save))
    return save, out


def seed_from_jax(jax_dir, save_dir, step):
    """A port save_dir holding JAX's step-``step`` state as a port checkpoint."""
    r = restore_jax(Path(jax_dir) / "model_checkpoints", step)
    config = JaxConfig.from_json_file(Path(jax_dir) / "config.json")
    sd = train_state_from_jax(config, r["params"], r["opt_state"]["0"]["mu"], r["opt_state"]["0"]["nu"],
                              int(r["opt_state"]["0"]["count"]), int(r["step"]))  # fmt: skip
    meta = json.loads((Path(jax_dir) / "model_checkpoints" / f"metadata_{step}.json").read_text())
    ReliableCheckpointManager(Path(save_dir) / "model_checkpoints").save(step, sd, metadata=meta)


def test_resume_from_jax_matches_jax(jax_run, conv, tmp_path):
    jax_dir, (jloss, jtuning, jheld) = jax_run
    seed_from_jax(jax_dir, tmp_path, RESUME_AT)
    tloss, ttuning, theld = train(port_cfg(tmp_path, conv), device="cpu")

    want, got = losses(jax_dir), losses(tmp_path)
    later = sorted(k for k in want if k[1] > RESUME_AT)
    assert later and sorted(got) == later
    np.testing.assert_allclose([got[k] for k in later], [want[k] for k in later], **TOL)
    want_t, got_t = losses(jax_dir, "tuning"), losses(tmp_path, "tuning")
    assert sorted(got_t) == sorted(want_t)
    np.testing.assert_allclose([got_t[k] for k in sorted(want_t)], [want_t[k] for k in sorted(want_t)], **TOL)

    assert sorted(ttuning) == sorted(jtuning) and sorted(theld) == sorted(jheld)
    for k in jtuning:
        np.testing.assert_allclose(ttuning[k], jtuning[k], err_msg=k, **TOL)
    for k in jheld:
        np.testing.assert_allclose(theld[k], jheld[k], err_msg=k, **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)

    model, config = load_pretrained(tmp_path, device="cpu")
    jparams = ocp.PyTreeCheckpointer().restore(Path(jax_dir).resolve() / "pretrained_weights")
    assert_params_close(flat(export_params(model)["params"]), flat(jparams["params"]))

    # One config.json for both packages (JAX's Vocabulary re-sorts and
    # re-normalizes the frequencies it reads; the port keeps them as written).
    jconfig = JaxConfig.from_json_file(tmp_path / "config.json")
    back = StructuredTransformerConfig.from_dict(jconfig.to_dict()).to_dict()
    mine = config.to_dict()
    for d in (back, mine):
        for m in d["measurement_configs"].values():
            m["vocabulary"] = m["vocabulary"] and sorted(m["vocabulary"]["vocabulary"])
    assert back == mine
    assert JaxDatasetConfig.from_json_file(tmp_path / "data_config.json").max_seq_len == 16


@pytest.fixture(scope="module")
def reference(conv, tmp_path_factory):
    """An uninterrupted port run (resident tables): its save_dir and outputs."""
    save = tmp_path_factory.mktemp("port_reference")
    out = train(port_cfg(save, conv), device="cpu")
    return save, out


def final_params(save_dir) -> dict:
    model, _ = load_pretrained(save_dir, device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def assert_same_run(a_dir, a_out, b_dir, b_out, steps_after=0):
    assert a_out == b_out
    pa, pb = final_params(a_dir), final_params(b_dir)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    # A logging window (4 steps) wholly after the resume point matches.
    la, lb = losses(a_dir), losses(b_dir)
    whole = [k for k in lb if k[1] - 4 >= steps_after]
    assert whole and all(lb[k] == la[k] for k in whole)
    assert losses(b_dir, "tuning").items() <= losses(a_dir, "tuning").items() or steps_after > 0


def seed_from(ref_dir, save_dir, steps):
    save_dir = Path(save_dir)
    (save_dir / "model_checkpoints").mkdir(parents=True)
    for name in ("config.json", "data_config.json"):
        shutil.copy(Path(ref_dir) / name, save_dir / name)
    for step in steps:
        src = Path(ref_dir) / "model_checkpoints"
        shutil.copytree(src / str(step), save_dir / "model_checkpoints" / str(step))
        for side in ("metadata", "manifest"):
            shutil.copy(src / f"{side}_{step}.json", save_dir / "model_checkpoints")


def test_host_path_equals_resident_path(reference, conv, tmp_path):
    ref_dir, ref_out = reference
    out = train(port_cfg(tmp_path, conv, device_resident_data=False), device="cpu")
    assert_same_run(ref_dir, ref_out, tmp_path, out)
    assert losses(tmp_path) == losses(ref_dir) and losses(tmp_path, "tuning") == losses(ref_dir, "tuning")


def test_mid_epoch_resume_and_walk_back_equal_the_clean_run(reference, conv, tmp_path):
    ref_dir, ref_out = reference
    meta = json.loads((Path(ref_dir) / "model_checkpoints" / "metadata_16.json").read_text())
    assert meta == {"epoch": 1, "epoch_complete": False, "step_in_epoch": 4}
    seed_from(ref_dir, tmp_path / "resume", (8, 12, 16))
    assert_same_run(ref_dir, ref_out, tmp_path / "resume", train(port_cfg(tmp_path / "resume", conv), device="cpu"),
                    steps_after=16)  # fmt: skip
    seed_from(ref_dir, tmp_path / "walk", (8, 12, 16))
    corrupt_checkpoint_step(tmp_path / "walk" / "model_checkpoints", 16)
    with pytest.warns(RuntimeWarning, match="walking back"):
        out = train(port_cfg(tmp_path / "walk", conv), device="cpu")
    assert_same_run(ref_dir, ref_out, tmp_path / "walk", out, steps_after=12)


def test_sigterm_preempts_and_the_relaunch_equals_the_clean_run(reference, conv, tmp_path):
    ref_dir, ref_out = reference
    plan = FaultPlan([Fault(kind="sigterm", step=6)])
    with fault_plan(plan), pytest.raises(Preempted) as info:
        train(port_cfg(tmp_path, conv, device_resident_data=False), device="cpu")
    assert info.value.step == 6 and plan.fired == [{"kind": "sigterm", "step": 6}]
    out = train(port_cfg(tmp_path, conv, device_resident_data=False), device="cpu")
    assert_same_run(ref_dir, ref_out, tmp_path, out, steps_after=6)


def test_poisoned_batch_rolls_back(conv, tmp_path):
    plan = FaultPlan([Fault(kind="nan_batch", epoch=1, batch_index=5)])
    with fault_plan(plan):
        _, tuning, _ = train(port_cfg(tmp_path, conv, device_resident_data=False), device="cpu")
    assert plan.fired == [{"kind": "nan_batch", "epoch": 1, "batch_index": 5}]
    log = read_log(tmp_path)
    events = [r for r in log if r["split"] == "reliability"]
    assert len(events) == 1 and events[0]["restored_step"] == 16
    after = log[log.index(events[0]) + 1 :]
    assert all(np.isfinite(r.get("train_loss", r.get("tuning_loss", 0.0))) for r in after)
    assert np.isfinite(tuning["tuning_loss"])


def test_early_stopping_stops_where_jax_stops(conv, tmp_path, monkeypatch):
    """The same scripted tuning losses (5, 4, 4.5, 4.2, 3) at patience 2 stop both after epoch 3 of 5."""
    import eventstreamgpt_tpu.training.pretrain as jax_pretrain
    import eventstreamgpt_tpu_torch.training.pretrain as port_pretrain

    def scripted(*args, **kw):
        scripted.calls += 1
        return {"tuning_loss": (5.0, 4.0, 4.5, 4.2, 3.0)[scripted.calls - 1]}

    kw = dict(max_epochs=5, patience=2, train_subset_size=16, train_subset_seed=1)
    for module, run, cfg in ((jax_pretrain, jax_train, jax_cfg(tmp_path / "jax", **kw)),
                             (port_pretrain, lambda c: train(c, device="cpu"), port_cfg(tmp_path / "port", conv, **kw))):  # fmt: skip
        scripted.calls = 0
        monkeypatch.setattr(module, "evaluate", scripted)
        cfg.do_final_validation_on_metrics = False
        assert run(cfg) == (None, None, None)
    assert sorted(losses(tmp_path / "port", "tuning")) == sorted(losses(tmp_path / "jax", "tuning"))
    assert [e for e, _ in sorted(losses(tmp_path / "port", "tuning"))] == [0, 1, 2, 3]


def test_restore_writes_in_place():
    config = StructuredTransformerConfig.from_dict(
        JaxConfig(**SMALL, vocab_sizes_by_measurement={"event_type": 4}, vocab_offsets_by_measurement={"event_type": 1},
                  measurements_idxmap={"event_type": 1},
                  measurements_per_generative_mode={"single_label_classification": ["event_type"]}).to_dict()
    )  # fmt: skip
    model = build_model(config)
    optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT, gradient_accumulation=2))
    state = TrainState()
    optimizer.accumulator.bind(list(model.parameters()))
    sd = train_state_dict(model, optimizer, scheduler, state)
    sd["adam"] = {f: {n: torch.full_like(p, 0.5) if f != "step" else torch.tensor(3.0)
                      for n, p in model.named_parameters()} for f in ("step", "exp_avg", "exp_avg_sq")}  # fmt: skip
    sd.update(step=7, scheduler_step=3)
    load_train_state(sd, model, optimizer, scheduler, state)  # before any step: the state is made
    ptrs = [p.data_ptr() for p in model.parameters()] + [t.data_ptr() for st in optimizer.state.values()
                                                          for t in st.values()]  # fmt: skip
    sd["params"] = {k: v + 1 for k, v in sd["params"].items()}
    load_train_state(sd, model, optimizer, scheduler, state)
    assert ptrs == [p.data_ptr() for p in model.parameters()] + [
        t.data_ptr() for st in optimizer.state.values() for t in st.values()
    ]
    assert state.step == 7 and scheduler.last_epoch == 3
    assert torch.equal(next(iter(model.state_dict().values())), next(iter(sd["params"].values())))


def test_gradient_accumulation_matches_multisteps(tmp_path):
    """4 loop steps at k=2 against optax.MultiSteps: 2 updates, the same losses and parameters."""
    from eventstreamgpt_tpu.data import JaxDataset
    from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel

    ds = JaxDataset(JaxDatasetConfig(save_dir=PROCESSED, max_seq_len=16, min_seq_len=2), "train")
    config = JaxConfig(**SMALL)
    config.set_to_dataset(ds)
    batches = list(ds.batches(4, shuffle=True, seed=0))[:4]
    jmodel = JaxModel(config)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), batches[0])
    oc = dict(OPT, gradient_accumulation=2)
    tx, _ = jax_build_optimizer(JaxOptimizationConfig(**oc))
    jparams = jax.tree_util.tree_map(jnp.array, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(jparams))
    jstep = jax_make_train_step(jmodel, tx)
    jlosses = []
    for b in batches:
        state, loss = jstep(state, b, jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    tmodel = port_model(config, params)
    optimizer, scheduler = build_optimizer(tmodel, OptimizationConfig(**oc))
    step = make_train_step(tmodel, optimizer, scheduler, device="cpu")
    tlosses = [float(step(to_torch(b), 0)) for b in batches]
    assert step.state.step == 4 and scheduler.last_epoch == 2
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert_params_close(flat(export_params(tmodel)["params"]), flat(jax.tree_util.tree_map(np.asarray, state.params)["params"]))


def test_chunked_accumulation_equals_single_steps(conv):
    """The chunked step's accumulation phases follow the global step: a 3-step
    chunk then a 1-step chunk equal four single steps bit for bit."""
    from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset

    ds = TorchDataset(PytorchDatasetConfig(save_dir=conv, max_seq_len=16), "train")
    config = StructuredTransformerConfig(**SMALL, precision="fp32")
    config.set_to_dataset(ds)
    dd = DeviceDataset(ds, device="cpu")
    oc = OptimizationConfig(**OPT, gradient_accumulation=2)

    def fresh():
        model = build_model(config)
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.02)
        return (model, *build_optimizer(model, oc))

    cm, co, cs = fresh()
    chunk = make_chunked_train_step(cm, co, cs, dd, device="cpu")
    plans = [p for p, _ in dd.plan_chunks(4, 3, seed=0)][:2]
    chunk_losses = torch.cat([chunk(plans[0], 1), chunk({k: v[:1] for k, v in plans[1].items()}, 1)])
    sm, so, ss = fresh()
    single = make_train_step(sm, so, ss, device="cpu")
    single_losses = torch.stack([single(b, 1) for b in list(dd.batches(4, seed=0))[:4]])
    assert torch.equal(chunk_losses, single_losses)
    assert all(torch.equal(a, b) for a, b in zip(cm.parameters(), sm.parameters()))
    assert cs.last_epoch == ss.last_epoch == 2 and chunk.state.step == single.state.step == 4


@pytest.mark.parametrize(
    "change, item",
    [
        (dict(trainer_config={"tensor_parallel_shards": 2}), "item 7"),
        (dict(trainer_config={"fsdp_shards": 2}), "item 7"),
        (dict(trainer_config={"context_parallel_shards": 2}), "item 7"),
        (dict(trainer_config={"profile_dir": "profiles"}), "profile_train"),
    ],
)
def test_refusals_name_their_item(conv, tmp_path, change, item):
    s = settings(tmp_path, conv)
    for key, value in change.items():
        s[key] = {**s[key], **value}
    with pytest.raises(ValueError, match=item):
        train(PretrainConfig(**s), device="cpu")


def test_train_takes_task_data_as_jax_does(conv, tmp_path):
    """JAX's `train` runs on a task's windows (its dataset restricts each
    subject to them; the generative model reads no labels), and so does the
    port's: one epoch on the sample cohort's ``high_utilization`` task gives
    finite final losses."""
    s = settings(tmp_path, conv, max_epochs=1)
    s["data_config"] = {**s["data_config"], "task_df_name": "high_utilization"}
    loss, tuning, held_out = train(PretrainConfig(**s), device="cpu")
    assert np.isfinite(loss) and np.isfinite(held_out["held_out_loss"])


def test_train_defaults_to_the_card(conv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(port_cfg(tmp_path, conv))


class GuardedStep:
    """A step's ``stats()``: programs made (each warmed up once) and captures."""

    programs = captures = 0

    def stats(self):
        return {"graph_programs": self.programs, "graph_captures": self.captures}


def test_capture_guard_counts_captures():
    step = GuardedStep()
    guard = CompileGuard(watch=[step], label="test step")
    guard.check()  # unarmed: nothing to check
    guard.arm()
    guard.check()
    step.programs += 1  # a new program's warm-up, then its capture
    step.captures += 1
    assert guard.compiles == 1
    with pytest.raises(RecompileError, match="test step"):
        guard.check()
    assert dataclasses.is_dataclass(TrainState())


def test_capture_guard_allows_the_capture_of_a_program_warmed_up_before_arm():
    """An epoch of one chunk warms its key up in epoch 0 and captures it in
    epoch 1 (JAX compiled it in epoch 0): not a new program."""
    step = GuardedStep()
    step.programs = 1  # epoch 0: the key's warm-up
    guard = CompileGuard(watch=[step], label="test step").arm()
    step.captures = 1  # epoch 1: its capture
    guard.check()
    step.programs, step.captures = 2, 2  # a drifted shape: a new program, captured
    with pytest.raises(RecompileError, match="1 new capture"):
        guard.check()


def test_prefetch_keeps_order_surfaces_errors_and_stops():
    """The prefetch thread yields ``(placed, stats)`` in order, raises a
    worker's error at the consumer, and stops on close (all joins bounded)."""
    import itertools

    from eventstreamgpt_tpu_torch.data.prefetch import prefetch_to_device

    assert list(prefetch_to_device(range(50), lambda x: 2 * x, host_stats_fn=lambda x: -x)) == [
        (2 * i, -i) for i in range(50)
    ]

    def failing():
        yield 1
        raise ValueError("boom")

    it = prefetch_to_device(failing(), lambda x: x)
    assert next(it) == (1, None)
    with pytest.raises(ValueError, match="boom"):
        next(it)
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    endless = prefetch_to_device(itertools.count(), lambda x: x)
    assert next(endless) == (0, None)
    endless.close(join_timeout=5)
    assert not endless._thread.is_alive()
