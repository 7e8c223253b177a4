"""The port's stream classifier, the pretrained-encoder graft and fine-tuning's `train(cfg)` against the JAX package, on the CPU.

The data is the in-repo sample cohort's ``high_utilization`` task
(``sample_data/processed/sample`` on the JAX side); a 4-class task is
the same batch with integer labels drawn from a seed. Models are
``test_torch_train.py``'s ``SMALL`` widths in fp32 with no dropout, JAX's
weights carried over by `load_jax_params`. Both models get the same event
``time``, accumulated in float64 and rounded once to fp32. Logits are held
within ``LOGITS`` (atol 1e-4): the windows' times reach ~2.6e4 minutes,
where the two packages' fp32 products of time and frequency inside the
sinusoidal time encoding round apart by an ulp of the product, which
moves a late event's encoding by up to ~7e-5 and a logit by up to ~4e-5
(with the same times divided by 100 every logit agrees within 1e-6). The
NA encoder runs JAX's plain dep-graph route in the forward and AdamW
checks and its Pallas kernel in interpret mode in the gradient checks.

* (1) `ESTForStreamClassification` against JAX's for each pooling, CI and
  NA, binary and 4-class: loss within ``TOL`` (1e-5), logits within ``LOGITS``;
* (2) fill rows flagged off by ``valid_mask`` change nothing (the loss of
  the valid rows alone, in both packages);
* (3) gradients within ``test_torch_train.py``'s envelope (1e-4 of each
  tensor's largest gradient plus 1e-6), and three AdamW steps through
  `make_train_step` against JAX's ``make_train_step`` (CI binary and NA
  4-class: losses within 1e-5, parameters within 1e-5 but for at most 0.1%
  of the elements, all within 1e-4);
* (4) `init_from_pretrained_encoder` grafts the encoder bit for bit,
  leaves the logit layer fresh (flax ``Dense``'s law: lecun normal, zero
  bias) and keeps the fresh init, with JAX's warning, where a shape differs
  or a name is missing; the converter takes JAX's fine-tuning tree both ways.

For `train(cfg)` a small fp32 CI generative model (``SMALL``, no dropout)
is initialised once by JAX and written as a JAX pretraining directory over
``sample_data/processed/sample`` and, converted
(`convert.checkpoint_from_jax`), as a port one over
``sample_data/converted/sample``. JAX's fine-tuning ``train(cfg)`` runs once
(module fixture) on the cohort's ``high_utilization`` task: batches of 8,
2 epochs of 12 steps, ``last`` pooling, a checkpoint every 4 steps.

* (5) Its step-8 resume state (orbax, as numpy) goes through
  `convert.train_state_from_jax` into a port checkpoint, and the port's
  ``train(cfg, device="cpu")`` resumes from it. This holds `train` to JAX's
  run although the two draw their fresh logit layers from different
  generators: every later logged loss and both tuning losses within 1e-5,
  the final parameters within ``test_torch_train.py``'s AdamW envelope and
  both metrics files (loss, accuracy, AUROC, AUPRC) within 1e-5, under the
  same keys.
* (6) Port only, bit for bit against an uninterrupted port run: the host
  path equals the resident path; a mid-epoch resume from the run's own
  checkpoints equals it; scripted tuning losses stop both packages' runs
  at the same epoch (patience 2).
* (7) `train` defaults to the card and raises without one.

A freshly built model holds no uninitialised memory (the repair of the
embedding tables, which ``torch.empty`` once left as they were).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import eventstreamgpt_tpu.training.fine_tuning as jax_fine_tuning
import eventstreamgpt_tpu_torch.training.fine_tuning as port_fine_tuning
from eventstreamgpt_tpu.data import JaxDataset
from eventstreamgpt_tpu.data import PytorchDatasetConfig as JaxDatasetConfig
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.fine_tuning_model import ESTForStreamClassification as JaxClassifier
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import save_pretrained as jax_save_pretrained
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_train_step as jax_make_train_step
from eventstreamgpt_tpu_torch.convert import (
    checkpoint_from_jax,
    export_params,
    init_params_from_seed,
    load_jax_params,
    model_for_tree,
    port_name,
    train_state_from_jax,
)
from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.fine_tuning_model import ESTForStreamClassification, lecun_normal_
from eventstreamgpt_tpu_torch.training import (
    build_model,
    build_optimizer,
    load_pretrained,
    make_train_step,
    save_pretrained,
    train_steps,
)
from eventstreamgpt_tpu_torch.training.fine_tuning import (
    FinetuneConfig,
    StreamClassificationMetrics,
    init_from_pretrained_encoder,
    new_classifier,
    train,
)

from .test_torch_pretrain import assert_params_close, seed_from_jax
from .test_torch_train import OPT, SMALL, TOL, flat, to_torch

ROOT = Path(__file__).resolve().parents[1]
PROCESSED = ROOT / "sample_data" / "processed" / "sample"
CONVERTED = ROOT / "sample_data" / "converted" / "sample"
TASK = "high_utilization"
DATA = dict(max_seq_len=16, min_seq_len=2, task_df_name=TASK, seq_padding_side="right",
            subsequence_sampling_strategy="to_end")  # fmt: skip
NA = dict(
    structured_event_processing_mode="nested_attention",
    dep_graph_attention_types="global",
    do_full_block_in_seq_attention=False,
    do_full_block_in_dep_graph_attention=True,
    measurements_per_dep_graph_level=[[], ["event_type"], ["department", "HR", "temp"]],
)
MULTICLASS = dict(id2label={0: "a", 1: "b", 2: "c", 3: "d"}, label2id={"a": 0, "b": 1, "c": 2, "d": 3}, num_labels=4)
POOLINGS = ("cls", "last", "max", "mean")
B = 6
LOGITS = dict(rtol=1e-5, atol=1e-4)
PRETRAIN_DATA = dict(max_seq_len=16, min_seq_len=2)
RESUME_AT, CKPT_EVERY = 8, 4
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_config(mode: str, task: str, pooling: str = "last", **overrides) -> JaxConfig:
    ds = JaxDataset(JaxDatasetConfig(save_dir=PROCESSED, **DATA), "train")
    config = JaxConfig(**SMALL, **(NA if mode == "na" else {}), task_specific_params={"pooling_method": pooling},
                       **overrides)  # fmt: skip
    config.set_to_dataset(ds)
    if task == "multiclass":
        for k, v in MULTICLASS.items():
            setattr(config, k, v)
    return config


def sample_batch(task: str):
    """``B`` task windows of the train split, right-padded, with a ``valid_mask``
    (all rows valid) and each event's ``time`` accumulated in float64, as fp32."""
    ds = JaxDataset(JaxDatasetConfig(save_dir=PROCESSED, **DATA), "train")
    batch = next(ds.batches(B, shuffle=False))
    labels = batch.stream_labels[TASK]
    if task == "multiclass":
        labels = jnp.asarray(np.random.default_rng(3).integers(0, 4, B), jnp.int32)
    td = np.where(np.asarray(batch.event_mask), np.asarray(batch.time_delta, np.float64), 0.0)
    time = np.concatenate([np.zeros((B, 1)), np.cumsum(td, axis=1)[:, :-1]], axis=1).astype(np.float32)
    return batch.replace(stream_labels={TASK: labels}, valid_mask=jnp.ones(B, bool), time=jnp.asarray(time))


@pytest.fixture(scope="module")
def built():
    """{(mode, task): (jax config, flax params, jax batch)}, each built once."""
    out = {}
    for mode in ("ci", "na"):
        for task in ("binary", "multiclass"):
            config, batch = jax_config(mode, task), sample_batch(task)
            out[mode, task] = (config, jax.jit(JaxClassifier(config).init)(jax.random.PRNGKey(1), batch), batch)
    return out


def port_classifier(config, params, **overrides) -> ESTForStreamClassification:
    tcfg = StructuredTransformerConfig.from_dict({**config.to_dict(), **overrides})
    model = model_for_tree(tcfg, params)
    assert isinstance(model, ESTForStreamClassification)
    return load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))


def with_pooling(config, pooling: str) -> JaxConfig:
    return JaxConfig.from_dict({**config.to_dict(), "task_specific_params": {"pooling_method": pooling}})


# ------------------------------------------------------------------ (1), (2)
@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("mode", ["ci", "na"])
def test_classifier_matches_jax(built, mode, task, pooling):
    config, params, jbatch = built[mode, task]
    jcfg = with_pooling(config, pooling)
    want = JaxClassifier(jcfg).apply(params, jbatch)
    model = port_classifier(jcfg, params)
    assert model.pooling_method == pooling and model.is_binary == (task == "binary")
    with torch.no_grad():
        got = model(to_torch(jbatch))
    assert got.preds.dtype == torch.float32 and tuple(got.preds.shape) == np.asarray(want.preds).shape
    assert tuple(got.preds.shape) == ((B,) if task == "binary" else (B, 4))
    np.testing.assert_allclose(got.preds.numpy(), np.asarray(want.preds), **LOGITS)
    np.testing.assert_allclose(float(got.loss), float(want.loss), **TOL)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("mode", ["ci", "na"])
def test_fill_rows_change_nothing(built, mode, task):
    config, params, jbatch = built[mode, task]
    model = port_classifier(config, params)
    keep = 4
    valid = np.arange(B) < keep
    filled = jbatch.replace(valid_mask=jnp.asarray(valid))
    # Fill rows carry another subject's events and the other label: the loss must not see them.
    flip = np.asarray(filled.stream_labels[TASK])
    flip = np.where(valid, flip, 1 - flip if task == "binary" else (flip + 1) % 4).astype(flip.dtype)
    filled = filled.replace(stream_labels={TASK: jnp.asarray(flip)})
    alone = jax.tree_util.tree_map(lambda x: x[:keep] if getattr(x, "ndim", 0) >= 1 else x, jbatch)
    with torch.no_grad():
        got_filled = float(model(to_torch(filled)).loss)
        got_alone = float(model(to_torch(alone)).loss)
    want_filled = float(JaxClassifier(config).apply(params, filled).loss)
    np.testing.assert_allclose(got_filled, got_alone, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_filled, want_filled, **TOL)
    with torch.no_grad():
        none_valid = model(to_torch(jbatch.replace(valid_mask=None))).loss
        all_valid = model(to_torch(jbatch)).loss
    assert float(none_valid) == float(all_valid)  # no valid_mask: every row counts


# ------------------------------------------------------------------ (3)
def interpreted(config, mode: str) -> JaxConfig:
    """The NA config with JAX's dep-graph kernel in interpret mode (a CI config as it is)."""
    if mode != "na":
        return config
    return JaxConfig.from_dict({**config.to_dict(), "dep_graph_attention_impl": "pallas_interpret"})


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("mode", ["ci", "na"])
def test_gradients_match_jax(built, mode, task):
    config, params, jbatch = built[mode, task]
    jcfg = interpreted(config, mode)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JaxClassifier(jcfg).apply(p, jbatch).loss))(params)
    model = port_classifier(config, params)
    out = model(to_torch(jbatch))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(jloss), **TOL)
    tparams = dict(model.named_parameters())
    assert len(tparams) == len(flat(jgrads["params"]))
    for path, g in flat(jgrads["params"]).items():
        name, transpose = port_name(path)
        tg = tparams[name].grad
        tg = np.zeros_like(g.T if transpose else g) if tg is None else tg.numpy()
        err = np.abs((tg.T if transpose else tg) - g).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-6, (name, err, np.abs(g).max())
    assert np.abs(flat(jgrads["params"])[("logit_layer", "kernel")]).max() > 0


@pytest.mark.parametrize("mode, task", [("ci", "binary"), ("na", "multiclass")])
def test_three_adamw_steps_match_jax(built, mode, task):
    config, params, jbatch = built[mode, task]
    tx, _ = jax_build_optimizer(JaxOptimizationConfig(**OPT))
    jparams = jax.tree_util.tree_map(jnp.array, params)  # the step donates its state
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(jparams))
    jstep = jax_make_train_step(JaxClassifier(config), tx)
    jlosses = []
    for _ in range(3):
        state, loss = jstep(state, jbatch, jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    model = port_classifier(config, params)
    optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
    step = make_train_step(model, optimizer, scheduler, device="cpu")
    tlosses = train_steps(step, [to_torch(jbatch)] * 3, seed=0)
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert tlosses[1] == tlosses[0] and tlosses[2] != tlosses[1]  # update 0 has rate 0 (warmup)
    want, got = flat(jax.device_get(state.params)), flat(export_params(model))
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())


# ------------------------------------------------------------------ (4)
def port_config(mode: str, **overrides) -> StructuredTransformerConfig:
    return StructuredTransformerConfig.from_dict({**jax_config(mode, "binary").to_dict(), **overrides})


@pytest.mark.parametrize("mode", ["ci", "na"])
def test_graft_takes_the_encoder_and_keeps_a_fresh_head(mode, tmp_path, capsys):
    config = port_config(mode)
    pretrained = init_params_from_seed(build_model(config), seed=5)  # a generative save_dir: heads included
    save_pretrained(tmp_path, pretrained, config)
    fresh = new_classifier(config, seed=7)
    head = {k: v.clone() for k, v in fresh.logit_layer.state_dict().items()}
    init_from_pretrained_encoder(fresh, tmp_path)
    assert capsys.readouterr().out == ""  # the generative heads are skipped silently
    want = pretrained.state_dict()
    for name, t in fresh.state_dict().items():
        if name.startswith("encoder."):
            assert torch.equal(t, want[name]), name
    assert all(torch.equal(t, head[k]) for k, t in fresh.logit_layer.state_dict().items())
    assert torch.equal(head["bias"], torch.zeros(1))
    # The logit layer is flax Dense's draw: lecun normal (a normal truncated at 2 sigma, variance 1 / fan_in).
    big = lecun_normal_(torch.empty(256, 512), seed=7).numpy()
    assert np.abs(big).max() <= 2 / 0.87962566103423978 / np.sqrt(512) + 1e-7
    np.testing.assert_allclose(big.std(), 1 / np.sqrt(512), rtol=0.02)
    np.testing.assert_array_equal(fresh.logit_layer.weight.detach().numpy(),
                                  lecun_normal_(torch.empty(1, config.hidden_size), seed=7).numpy())  # fmt: skip


def test_graft_keeps_the_fresh_init_where_a_shape_differs_or_a_name_is_missing(tmp_path, capsys):
    config = port_config("ci")
    pretrained = init_params_from_seed(build_model(port_config("ci", intermediate_size=48)), seed=5)
    state = pretrained.state_dict()
    del state["encoder.ln_f.bias"]
    save_pretrained(tmp_path, state)
    fresh = new_classifier(config, seed=7)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    init_from_pretrained_encoder(fresh, tmp_path)
    out = capsys.readouterr().out
    assert "WARNING: shape mismatch at encoder.h0.mlp.c_fc.weight; keeping fresh init" in out
    assert "WARNING: encoder.ln_f.bias missing from pretrained weights; keeping fresh init" in out
    after = fresh.state_dict()
    for name in ("encoder.h0.mlp.c_fc.weight", "encoder.h1.mlp.c_proj.weight", "encoder.ln_f.bias"):
        assert torch.equal(after[name], before[name]), name
    assert torch.equal(after["encoder.h0.attn.attention.q_proj.weight"], state["encoder.h0.attn.attention.q_proj.weight"])


def test_converter_takes_the_fine_tuning_tree(built):
    config, params, _ = built["ci", "binary"]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = port_classifier(config, params)
    back = flat(export_params(model)["params"])
    want = flat(np_params["params"])
    assert sorted(back) == sorted(want) and ("logit_layer", "kernel") in want
    assert all(np.array_equal(back[k], want[k]) for k in want)
    zeros = jax.tree_util.tree_map(np.zeros_like, np_params)
    sd = train_state_from_jax(config, np_params, zeros, zeros, count=3, step=3)
    assert sd["params"].keys() == dict(model.named_parameters()).keys()
    assert torch.equal(sd["params"]["logit_layer.weight"], model.logit_layer.weight.detach())
    bad = {"params": {**np_params["params"], "extra": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="no port parameter"):
        load_jax_params(ESTForStreamClassification(model.config), bad)


# ------------------------------------------------------------------ (5)-(7) train(cfg)
def write_pretrained(root: Path) -> tuple[Path, Path]:
    """``(jax_dir, port_dir)``: the same JAX-initialised CI generative
    weights as a JAX pretraining directory and as the port's."""
    ds = JaxDataset(JaxDatasetConfig(save_dir=PROCESSED, **PRETRAIN_DATA), "train")
    config = JaxConfig(**SMALL)
    config.set_to_dataset(ds)
    params = jax.jit(JaxModel(config).init)(jax.random.PRNGKey(0), next(ds.batches(4, shuffle=False)))
    jax_dir, port_dir = root / "jax", root / "port"
    jax_save_pretrained(jax_dir, params, config)
    JaxDatasetConfig(save_dir=PROCESSED, **PRETRAIN_DATA).to_json_file(jax_dir / "data_config.json")
    checkpoint_from_jax(jax.tree_util.tree_map(np.asarray, params), config, port_dir)
    PytorchDatasetConfig(save_dir=CONVERTED, **PRETRAIN_DATA).to_json_file(port_dir / "data_config.json")
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """The CI model's JAX and port pretraining directories (`write_pretrained`)."""
    return write_pretrained(tmp_path_factory.mktemp("ft_pretrained"))


def settings(save_dir, *, max_epochs=2, patience=None, **overrides) -> dict:
    return dict(
        task_df_name=TASK,
        seed=1,
        save_dir=Path(save_dir),
        optimization_config=dict(init_lr=1e-3, batch_size=8, validation_batch_size=8, max_epochs=max_epochs,
                                 lr_frac_warmup_steps=0.1, patience=patience),  # fmt: skip
        trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": CKPT_EVERY, "max_checkpoints_to_keep": 20},
        **overrides,
    )


def jax_cfg(pretrained_dir, save_dir, **kw):
    s = settings(save_dir, **kw)
    s["optimization_config"] = JaxOptimizationConfig(**s["optimization_config"])
    return jax_fine_tuning.FinetuneConfig(load_from_model_dir=pretrained_dir, **s)


def port_cfg(pretrained_dir, save_dir, trainer_config=None, **kw) -> FinetuneConfig:
    s = settings(save_dir, **kw)
    s["trainer_config"].update(trainer_config or {})
    return FinetuneConfig(load_from_model_dir=pretrained_dir, **s)


def read_log(save_dir) -> list[dict]:
    return [json.loads(line) for line in (Path(save_dir) / "train_log.jsonl").open()]


def losses(save_dir, split="train") -> dict:
    key = "train_loss" if split == "train" else "tuning_loss"
    return {(r["epoch"], r["step"]): r[key] for r in read_log(save_dir) if r["split"] == split}


def metrics_files(save_dir) -> dict:
    return {s: json.loads((Path(save_dir) / f"{s}_metrics.json").read_text()) for s in ("tuning", "held_out")}


def final_weights(save_dir) -> dict:
    config = StructuredTransformerConfig.from_json_file(Path(save_dir) / "config.json")
    model, _ = load_pretrained(save_dir, model=ESTForStreamClassification(config), device="cpu")
    return model


@pytest.fixture(scope="module")
def jax_run(pretrained, tmp_path_factory):
    """JAX's fine-tuning run: its save_dir and its returned metrics."""
    save = tmp_path_factory.mktemp("jax_ft")
    return save, jax_fine_tuning.train(jax_cfg(pretrained[0], save))


def test_resume_from_jax_matches_jax(pretrained, jax_run, tmp_path):
    jax_dir, (jloss, jtuning, jheld) = jax_run
    seed_from_jax(jax_dir, tmp_path, RESUME_AT)
    tloss, ttuning, theld = train(port_cfg(pretrained[1], tmp_path), device="cpu")

    want, got = losses(jax_dir), losses(tmp_path)
    later = sorted(k for k in want if k[1] > RESUME_AT)
    assert later and sorted(got) == later
    np.testing.assert_allclose([got[k] for k in later], [want[k] for k in later], **TRAIN_TOL)
    want_t, got_t = losses(jax_dir, "tuning"), losses(tmp_path, "tuning")
    assert sorted(got_t) == sorted(want_t) == [(0, 12), (1, 24)]
    np.testing.assert_allclose([got_t[k] for k in sorted(want_t)], [want_t[k] for k in sorted(want_t)], **TRAIN_TOL)

    assert sorted(ttuning) == sorted(jtuning) == ["tuning_AUPRC", "tuning_AUROC", "tuning_accuracy", "tuning_loss"]
    assert sorted(theld) == sorted(jheld)
    for want_m, got_m in ((jtuning, ttuning), (jheld, theld)):
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], err_msg=k, **TRAIN_TOL)
    np.testing.assert_allclose(tloss, jloss, **TRAIN_TOL)
    assert metrics_files(tmp_path) == {"tuning": ttuning, "held_out": theld}
    assert metrics_files(jax_dir) == {"tuning": jtuning, "held_out": jheld}

    jparams = ocp.PyTreeCheckpointer().restore(Path(jax_dir).resolve() / "pretrained_weights")
    got_p = flat(export_params(final_weights(tmp_path))["params"])
    assert ("logit_layer", "kernel") in got_p
    assert_params_close(got_p, flat(jparams["params"]))
    # One config.json for both packages: the task's fields as JAX set them.
    jconfig = JaxConfig.from_json_file(tmp_path / "config.json")
    assert (jconfig.finetuning_task, jconfig.num_labels, jconfig.problem_type) == (TASK, 2, "single_label_classification")
    assert jconfig.id2label == {0: False, 1: True}


@pytest.fixture(scope="module")
def reference(pretrained, tmp_path_factory):
    """An uninterrupted port run (resident tables): its save_dir and outputs."""
    save = tmp_path_factory.mktemp("port_ft_reference")
    return save, train(port_cfg(pretrained[1], save), device="cpu")


def assert_same_run(a_dir, a_out, b_dir, b_out, steps_after=0):
    assert a_out == b_out
    pa, pb = final_weights(a_dir).state_dict(), final_weights(b_dir).state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    la, lb = losses(a_dir), losses(b_dir)
    whole = [k for k in lb if k[1] - 4 >= steps_after]
    assert whole and all(lb[k] == la[k] for k in whole)


def test_host_path_equals_resident_path(pretrained, reference, tmp_path):
    ref_dir, ref_out = reference
    out = train(port_cfg(pretrained[1], tmp_path, trainer_config={"device_resident_data": False}), device="cpu")
    assert_same_run(ref_dir, ref_out, tmp_path, out)
    assert losses(tmp_path) == losses(ref_dir) and losses(tmp_path, "tuning") == losses(ref_dir, "tuning")
    assert metrics_files(tmp_path) == metrics_files(ref_dir)
    epochs = [r for r in read_log(tmp_path) if r["split"] == "tuning"]
    assert all({"steps_s", "eval_s", "checkpoint_s", "graph_captures"} <= set(r) for r in epochs)
    assert [r for r in read_log(tmp_path) if r["split"] == "final"][0]["validation_s"] >= 0


def test_mid_epoch_resume_equals_the_clean_run(pretrained, reference, tmp_path):
    ref_dir, ref_out = reference
    meta = json.loads((Path(ref_dir) / "model_checkpoints" / "metadata_16.json").read_text())
    assert meta == {"epoch": 1, "epoch_complete": False, "step_in_epoch": 4}
    (tmp_path / "model_checkpoints").mkdir()
    for name in ("config.json", "data_config.json"):
        shutil.copy(Path(ref_dir) / name, tmp_path / name)
    src = Path(ref_dir) / "model_checkpoints"
    for step in (12, 16):
        shutil.copytree(src / str(step), tmp_path / "model_checkpoints" / str(step))
        for side in ("metadata", "manifest"):
            shutil.copy(src / f"{side}_{step}.json", tmp_path / "model_checkpoints")
    out = train(port_cfg(pretrained[1], tmp_path), device="cpu")
    assert_same_run(ref_dir, ref_out, tmp_path, out, steps_after=16)
    assert losses(tmp_path, "tuning") == {(1, 24): losses(ref_dir, "tuning")[1, 24]}


def test_early_stopping_stops_where_jax_stops(pretrained, tmp_path, monkeypatch):
    """The same scripted tuning losses (5, 4, 4.5, 4.2, 3) at patience 2 stop both after epoch 3 of 5."""

    class Scripted(StreamClassificationMetrics):
        calls = 0

        def update(self, *args, **kw):
            pass

        def compute(self):
            Scripted.calls += 1
            return {"tuning_loss": (5.0, 4.0, 4.5, 4.2, 3.0)[Scripted.calls - 1]}

    kw = dict(max_epochs=5, patience=2, do_final_validation_on_metrics=False,
              data_config_overrides={"train_subset_size": 16, "train_subset_seed": 1})  # fmt: skip
    for module, run, cfg in (
        (jax_fine_tuning, jax_fine_tuning.train, jax_cfg(pretrained[0], tmp_path / "jax", **kw)),
        (port_fine_tuning, lambda c: train(c, device="cpu"), port_cfg(pretrained[1], tmp_path / "port", **kw)),
    ):
        Scripted.calls = 0
        monkeypatch.setattr(module, "StreamClassificationMetrics", Scripted)
        assert run(cfg) == (None, None, None)
    assert sorted(losses(tmp_path / "port", "tuning")) == sorted(losses(tmp_path / "jax", "tuning"))
    assert [e for e, _ in sorted(losses(tmp_path / "port", "tuning"))] == [0, 1, 2, 3]


def test_train_defaults_to_the_card(pretrained, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(port_cfg(pretrained[1], tmp_path))


# ------------------------------------------------------------------ repair
@pytest.mark.parametrize("kind", ["ci", "na", "split_embedding", "classifier"])
def test_a_fresh_model_holds_no_uninitialised_memory(kind, monkeypatch):
    """Every parameter of a freshly built model is drawn (the embedding tables
    from flax's normal(0.02), as the Linear layers from torch's law): none is
    left as uninitialised memory, which can hold NaN. Uninitialised memory is
    simulated by a ``torch.empty`` that returns NaN while the model is built
    (a restore test once compared such a NaN with itself and failed by chance)."""
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config

    overrides = {"na": NA_OVERRIDES, "split_embedding": dict(categorical_embedding_dim=8, numerical_embedding_dim=4)}
    config = serving_config(precision="fp32", sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64,
                            **overrides.get(kind, {}))  # fmt: skip
    if kind == "classifier":
        config.finetuning_task, config.id2label, config.num_labels = "task", {0: False, 1: True}, 2
    empty = torch.empty

    def nan_empty(*args, **kw):
        t = empty(*args, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)
    model = ESTForStreamClassification(config) if kind == "classifier" else build_model(config)
    monkeypatch.undo()
    bad = [n for n, p in model.named_parameters() if not torch.isfinite(p).all()]
    assert not bad, bad
