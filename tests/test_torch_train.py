"""The PyTorch port's CI training step against the JAX one, on the CPU.

Four batches, each through both packages with the JAX weights carried over
by `load_jax_params` and every dropout at 0, in fp32:

* ``entry``: the repository entry point's ``__graft_entry__._make_model_and_batch()``
  model and batch (multi-label and multivariate-regression ``lab``, so the
  indexed regression head and its gather, kernel C's plain version, run);
* ``entry_packed``: the same batch with two packed segments a row
  (``segment_ids``: attention within a segment, no TTE gap across one, a
  segment's first event predicted from zeros);
* ``sample_data``: one `JaxDataset` batch over a copy of
  ``sample_data/processed/sample`` (univariate regression, a functional
  time-dependent measurement, statics);
* ``synthetic_dl``: one `JaxDataset` batch over a small DL cache written by
  ``write_synthetic_dataset`` (multivariate-regression ``lab``).

Checked: the total loss and every per-head loss within 1e-5, every
gradient within 1e-4 of its tensor's largest gradient plus 1e-6, three AdamW steps (warmup 1, weight
decay 0.01) against JAX's ``make_train_step`` (losses within 1e-5;
exported parameters within 1e-5 but for at most 0.1% of the elements,
which stay within 1e-4), and the bf16 forward loss within 2e-2 relative.
Beside them: the learning-rate schedule and AdamW against optax, parameter
export, dropout's statistics and a step's reproducibility, the CUDA
default of `make_train_step`, and `build_model` on a nested-attention config
(its JAX parity is `tests/test_torch_na_model.py`).
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_train_step as jax_make_train_step
from eventstreamgpt_tpu.training.optimizer import polynomial_decay_with_warmup as jax_schedule
from eventstreamgpt_tpu_torch.convert import export_params, load_jax_params, port_name
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.ops.tensor_ops import dropout
from eventstreamgpt_tpu_torch.training import (
    build_model,
    build_optimizer,
    make_train_step,
    polynomial_decay_with_warmup,
    train_steps,
)

PROCESSED = Path(__file__).resolve().parent.parent / "sample_data" / "processed" / "sample"
NO_DROPOUT = dict(attention_dropout=0.0, input_dropout=0.0, resid_dropout=0.0)
SMALL = dict(
    hidden_size=32,
    head_dim=8,
    num_attention_heads=4,
    num_hidden_layers=2,
    intermediate_size=32,
    seq_attention_types=["local", "global"],
    seq_window_size=4,
    TTE_generation_layer_type="log_normal_mixture",
    TTE_lognormal_generation_num_components=2,
    **NO_DROPOUT,
)
OPT = dict(init_lr=1e-3, lr_num_warmup_steps=1, lr_frac_warmup_steps=None, max_training_steps=10, weight_decay=0.01)
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = ("entry", "entry_packed", "sample_data", "synthetic_dl")


def to_torch(batch) -> EventStreamBatch:
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: torch.from_numpy(np.array(x)) for k, x in v.items()}
        return torch.from_numpy(np.array(v))

    return EventStreamBatch(**{f.name: conv(getattr(batch, f.name)) for f in dataclasses.fields(EventStreamBatch)})


def dataset_case(save_dir):
    ds = JaxDataset(PytorchDatasetConfig(save_dir=save_dir, max_seq_len=16, min_seq_len=2), "train")
    config = JaxConfig(**SMALL)
    config.set_to_dataset(ds)
    return config, next(ds.batches(4, shuffle=False))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{name: (jax config, jax model, flax params, jax batch)} built once."""
    out = {}
    model, batch = __graft_entry__._make_model_and_batch(**NO_DROPOUT)
    out["entry"] = (model.config, batch)
    # Two subjects packed into each row from event 6 on, with padding between.
    seg = np.where(np.arange(batch.event_mask.shape[1]) < 6, 0, 1)[None].repeat(batch.event_mask.shape[0], 0)
    mask = np.asarray(batch.event_mask).copy()
    mask[:, 5] = False
    out["entry_packed"] = (model.config, batch.replace(segment_ids=jnp.asarray(seg), event_mask=jnp.asarray(mask)))
    sample = tmp_path_factory.mktemp("sample_data_copy") / "sample"
    shutil.copytree(PROCESSED, sample)
    out["sample_data"] = dataset_case(sample)
    synth = tmp_path_factory.mktemp("synthetic_dl")
    write_synthetic_dataset(
        synth, {"train": 8, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=10, max_seq_len=24, seed=0,
    )  # fmt: skip
    out["synthetic_dl"] = dataset_case(synth)
    built = {}
    for name, (config, batch) in out.items():
        jmodel = JaxModel(config)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), batch)
        built[name] = (config, jmodel, params, batch)
    return built


def port_model(config, params, **overrides):
    tcfg = StructuredTransformerConfig.from_dict({**config.to_dict(), **overrides})
    return load_jax_params(build_model(tcfg), jax.tree_util.tree_map(np.asarray, params))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def head_losses(losses) -> dict:
    out = {"tte": losses.time_to_event}
    for kind in ("classification", "regression"):
        out.update({f"{kind}:{m}": v for m, v in (getattr(losses, kind) or {}).items()})
    return {k: float(v) for k, v in out.items()}


@pytest.mark.parametrize("case", CASES)
def test_losses_and_gradients_match_jax(cases, case):
    config, jmodel, params, jbatch = cases[case]

    def loss_fn(p):
        out = jmodel.apply(p, jbatch)
        return out.loss, out.losses

    (jloss, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tmodel = port_model(config, params)
    out = tmodel(to_torch(jbatch), is_generation=False)
    out.loss.backward()

    np.testing.assert_allclose(out.loss.item(), float(jloss), **TOL)
    want, got = head_losses(jlosses), head_losses(out.losses)
    assert sorted(got) == sorted(want)
    if case != "sample_data":
        assert "regression:lab" in got  # the indexed head (kernel C's path) is on
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)

    tparams = dict(tmodel.named_parameters())
    for path, g in flat(jgrads["params"]).items():
        name, transpose = port_name(path)
        tg = tparams[name].grad
        tg = np.zeros_like(g.T if transpose else g) if tg is None else tg.numpy()
        # rtol 1e-4 of the tensor's largest gradient: fp32 sums run in other
        # orders, and the cumulative event time (thousands of minutes, ulps of
        # 1e-4) carries that into the sinusoids.
        err = np.abs((tg.T if transpose else tg) - g).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-6, (name, err, np.abs(g).max())


@pytest.mark.parametrize("case", CASES)
def test_three_adamw_steps_match_jax(cases, case):
    config, jmodel, params, jbatch = cases[case]
    tx, _ = jax_build_optimizer(JaxOptimizationConfig(**OPT))
    jparams = jax.tree_util.tree_map(jnp.array, params)  # the step donates its state
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(jparams))
    jstep = jax_make_train_step(jmodel, tx)
    jlosses = []
    for _ in range(3):
        state, loss = jstep(state, jbatch, jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    tmodel = port_model(config, params)
    optimizer, scheduler = build_optimizer(tmodel, OptimizationConfig(**OPT))
    step = make_train_step(tmodel, optimizer, scheduler, device="cpu")
    tlosses = train_steps(step, [to_torch(jbatch)] * 3, seed=0)
    assert step.state.step == 3

    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert tlosses[1] == tlosses[0] and tlosses[2] != tlosses[1]  # update 0 has rate 0 (warmup)
    want, got = flat(jax.device_get(state.params)), flat(export_params(tmodel))
    assert sorted(got) == sorted(want)
    # Adam divides each element's gradient by its own magnitude, so where a
    # gradient is within fp32 noise of zero those noise bits set the update's
    # size: up to 0.1% of the elements may miss 1e-5, and none 1e-4.
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())


@pytest.mark.parametrize("case", CASES)
def test_bf16_forward_loss_matches_jax(cases, case):
    config, _, params, jbatch = cases[case]
    jcfg = JaxConfig.from_dict({**config.to_dict(), "precision": "bf16"})
    jloss = float(jax.jit(lambda p: JaxModel(jcfg).apply(p, jbatch).loss)(params))
    tmodel = port_model(config, params, precision="bf16")
    with torch.no_grad():
        tloss = float(tmodel(to_torch(jbatch), is_generation=False).loss)
    assert tmodel.encoder.h0.mlp.c_fc.weight.dtype == torch.float32  # fp32 master weights
    np.testing.assert_allclose(tloss, jloss, rtol=2e-2)


def test_schedule_matches_optax_schedule():
    init, end, warmup, total = 1e-3, 1e-6, 10, 100
    jax_fn = jax_schedule(init, end, warmup, total, power=1.5)
    port_fn = polynomial_decay_with_warmup(init, end, warmup, total, power=1.5)
    for step in (0, 5, warmup, 55, total - 1, total, total + 7):
        # fp32 in optax: within 1e-6 of init_lr, absolute
        np.testing.assert_allclose(port_fn(step), float(jax_fn(step)), rtol=1e-6, atol=1e-6 * init, err_msg=str(step))


def test_adamw_matches_optax():
    """AdamW with the scheduled rate and decay on every parameter, 3 steps, 1e-6."""
    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()} for _ in range(3)]
    tx, _ = jax_build_optimizer(JaxOptimizationConfig(**OPT))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    optimizer, scheduler = build_optimizer(module, OptimizationConfig(**OPT))
    for g in grads:
        for k, v in g.items():
            getattr(module, k).grad = torch.from_numpy(v)
        optimizer.step()
        scheduler.step()
    for k in init:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    assert not np.allclose(init["b"], np.asarray(jp["b"]))


def test_export_params_inverts_load(cases):
    config, _, params, _ = cases["entry"]
    want, got = flat(jax.device_get(params)), flat(export_params(port_model(config, params)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_optimizer_refuses_accumulation_and_unset_steps():
    module = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="gradient_accumulation"):
        build_optimizer(module, OptimizationConfig(**OPT, gradient_accumulation=0))
    assert build_optimizer(module, OptimizationConfig(**OPT, gradient_accumulation=2))[0].accumulator.k == 2
    with pytest.raises(ValueError, match="set_to_dataset"):
        build_optimizer(module, OptimizationConfig(init_lr=1e-3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_statistics(dtype):
    x = torch.full((200_000,), 3.0, dtype=dtype)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert y.dtype == dtype
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.equal(y[kept], (x / 0.9)[kept])  # 1/keep_prob scaling, in x's dtype
    assert torch.equal(dropout(x, 0.1, None), x)  # deterministic mode
    assert torch.equal(dropout(x, 0.0, torch.Generator()), x)
    again = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_train_step_dropout_is_on_and_reproducible(cases):
    config, _, params, jbatch = cases["entry"]
    batch = to_torch(jbatch)
    rates = dict(attention_dropout=0.1, input_dropout=0.1, resid_dropout=0.1)

    def run(seed, n=2):
        model = port_model(config, params, **rates)
        optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
        step = make_train_step(model, optimizer, scheduler, device="cpu")
        return train_steps(step, [batch] * n, seed), export_params(model)

    with torch.no_grad():
        model = port_model(config, params, **rates)
        eval_loss = float(model(batch, is_generation=False).loss)
        assert float(model(batch, is_generation=False).loss) == eval_loss
        assert float(port_model(config, params)(batch, is_generation=False).loss) == eval_loss
        assert float(model(batch, is_generation=False, dropout=torch.Generator().manual_seed(3)).loss) != eval_loss
    (l0, p0), (l1, p1), (l2, _) = run(0), run(0), run(1)
    assert l0 == l1  # same (seed, step): bitwise the same step
    for k, v in flat(p0).items():
        assert np.array_equal(v, flat(p1)[k]), k
    assert l2[0] != l0[0]


def test_make_train_step_defaults_to_cuda(cases):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where no CUDA device is available")
    config, _, params, _ = cases["entry"]
    model = port_model(config, params)
    optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, optimizer, scheduler)


def test_build_model_refuses_nested_attention():
    """`build_model` builds the NA model, whose encoder takes the engine's
    bucket-padded prefill (``last_event_index``: each row's dep-graph
    history seeded from that event, ``tests/test_torch_na_engine.py``), and
    under scan and remat builds the same modules (the NA caches and the
    per-level walk are ported: ``tests/test_torch_generate.py``; remat and
    scan: ``tests/test_torch_remat_scan.py``)."""
    na = dict(SMALL, structured_event_processing_mode="nested_attention", measurements_per_dep_graph_level=[[], ["a"]])
    config = StructuredTransformerConfig(measurements_idxmap={"a": 1}, **na)
    model = build_model(config)
    assert isinstance(model, NAPPTForGenerativeSequenceModeling)
    batch = EventStreamBatch(event_mask=torch.ones(1, 2, dtype=torch.bool), time_delta=torch.ones(1, 2))
    full = batch.replace(dynamic_indices=torch.zeros(1, 2, 1, dtype=torch.int32),
                         dynamic_measurement_indices=torch.zeros(1, 2, 1, dtype=torch.int32),
                         dynamic_values=torch.zeros(1, 2, 1), dynamic_values_mask=torch.zeros(1, 2, 1, dtype=torch.bool))  # fmt: skip
    with torch.no_grad():
        first, last = (model.encoder(full, use_cache=True, last_event_index=torch.tensor([i])).past_key_values
                       for i in (0, 1))  # fmt: skip
        default = model.encoder(full, use_cache=True).past_key_values
    for a, b, c in zip(first.dep_graph_past, last.dep_graph_past, default.dep_graph_past):
        assert torch.equal(b.key, c.key) and torch.equal(b.value, c.value) and a.length == b.length == 1
        assert not torch.equal(a.key, b.key)  # event 0's history, not event 1's
    with pytest.raises(ValueError, match="is_generation"):
        model.output_layer(batch, torch.zeros(1, 2, 2, 32), is_generation=False, dep_graph_el_generation_target=1)
    for knob in (dict(scan_layers=True), dict(gradient_checkpointing="block")):
        knobbed = build_model(StructuredTransformerConfig(measurements_idxmap={"a": 1}, **na, **knob))
        assert isinstance(knobbed, NAPPTForGenerativeSequenceModeling)
        assert sorted(dict(knobbed.named_parameters())) == sorted(dict(model.named_parameters()))
