"""Remat and scan-over-layers in the port against the JAX package, on the CPU.

Small models (hidden 32, 2 or 4 layers, 16-event batches of
``__graft_entry__._make_model_and_batch``), CI and NA:

* `scan_period` equals JAX's on alternating, uniform and aperiodic stacks;
* JAX's scanned tree (``stack_layer_params`` of its unrolled init) loads into
  a ``scan_layers=True`` port model (1 and 2 groups): the loss equals JAX's
  scanned and unrolled losses within ``tests/test_torch_train.py``'s ``TOL``
  and every gradient JAX's scanned gradient (unstacked) within 1e-4 of its
  tensor's largest; `export_params` of the port model is JAX's stacked tree
  bit for bit;
* every remat policy, with dropout 0.1 from one generator seed, gives the
  port's ``"none"`` loss and gradients bit for bit (CI, NA, and the packed CI
  model whose global layer runs the flash path and local layer the band);
  ``save_attention`` runs each attention once, the recomputing policies
  twice; JAX's scanned, rematted loss and gradients (``block`` with 1
  group, ``save_attention`` with 2) match the port's within the
  tolerances above;
* a scanned JAX resume state (stacked AdamW moments) converts to the
  unrolled one's tensors bit for bit and resumes the same step;
* JAX's Pallas ``flash_attention`` in interpret mode at head_dim 128 matches
  the port's plain version;
* an NA engine with a spec draft over a scanned model refuses with JAX's
  words, and a CI engine over a scanned checkpoint serves the unrolled
  engine's events bit for bit.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash_attention
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__
import eventstreamgpt_tpu_torch.models.transformer as transformer_module
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.transformer import scan_period as jax_scan_period
from eventstreamgpt_tpu.models.transformer import stack_layer_params, unstack_layer_params
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_train_step as jax_make_train_step
from eventstreamgpt_tpu_torch.convert import (
    export_params,
    init_params_from_seed,
    load_jax_params,
    port_name,
    train_state_from_jax,
)
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.remat import POLICIES
from eventstreamgpt_tpu_torch.models.transformer import scan_period
from eventstreamgpt_tpu_torch.ops.flash_attention import flash_attention_reference
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer
from eventstreamgpt_tpu_torch.training.pretrain import TrainState, load_train_state, train_state_dict

from .test_torch_train import OPT, TOL, flat, to_torch

# JAX's NA model on its einsum dep-graph route (the port routes by device
# either way; `tests/test_torch_na_model.py` holds the Pallas route).
NA_IMPL = dict(dep_graph_fused_attention=False)
DROPOUT = dict(attention_dropout=0.1, input_dropout=0.1, resid_dropout=0.1)
NO_DROPOUT = dict(attention_dropout=0.0, input_dropout=0.0, resid_dropout=0.0)


@functools.lru_cache(maxsize=None)
def _jax_case(na: bool, layers: int, overrides: tuple):
    kw = dict(NA_IMPL) if na else {}
    model, batch = __graft_entry__._make_model_and_batch(na=na, **kw, **dict(overrides))
    config = JaxConfig.from_dict({**model.config.to_dict(), "num_hidden_layers": layers})
    model = type(model)(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), batch)
    return config, model, params, batch


def jax_case(na: bool, layers: int = 2, **overrides):
    """``(jax config, jax model, flax params, jax batch)`` of the entry point's
    small model, ``layers`` deep (built once a set of arguments)."""
    return _jax_case(na, layers, tuple(sorted(overrides.items())))


def port_of(config, params, **overrides):
    tcfg = StructuredTransformerConfig.from_dict({**config.to_dict(), **overrides})
    return load_jax_params(build_model(tcfg), jax.tree_util.tree_map(np.asarray, params))


def jax_loss_and_grads(jmodel, params, batch):
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(p, batch).loss))(params)
    return float(loss), grads


def check_grads(tmodel, jgrads):
    """Each port gradient against the flax gradient tree (unrolled names), within 1e-4 of its largest."""
    tparams = dict(tmodel.named_parameters())
    tree = jax.tree_util.tree_map(np.asarray, jgrads)["params"]
    for path, g in flat(unstack_layer_params(tree, tmodel.config)).items():
        name, transpose = port_name(path)
        tg = tparams[name].grad
        tg = np.zeros_like(g.T if transpose else g) if tg is None else tg.numpy()
        err = np.abs((tg.T if transpose else tg) - g).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-6, (name, err, np.abs(g).max())


# ------------------------------------------------------------------ scan_period
@pytest.mark.parametrize(
    "layers, seq, dep",
    [
        (4, ["local", "global"], None),  # alternating: period 2
        (3, ["global"], None),  # uniform: period 1
        (3, [[["global"], 1], [["local"], 2]], None),  # aperiodic: one group of 3
        (6, ["local", "global"], "global"),  # NA lists
        (4, ["global"], [[["global"], 2], [["local"], 2]]),  # the dep-graph list sets the period
    ],
)
def test_scan_period_matches_jax(layers, seq, dep):
    kw = dict(num_hidden_layers=layers, seq_attention_types=seq)
    if dep is not None:
        kw.update(structured_event_processing_mode="nested_attention", dep_graph_attention_types=dep,
                  measurements_per_dep_graph_level=[[], ["a"]], measurements_idxmap={"a": 1})  # fmt: skip
    assert scan_period(StructuredTransformerConfig(**kw)) == jax_scan_period(JaxConfig(**kw))


# ------------------------------------------------------------------ scanned trees
@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
@pytest.mark.parametrize("layers, policy", [(2, "block"), (4, "save_attention")], ids=["one_group", "two_groups"])
def test_jax_scanned_rematted_tree_loads_and_matches(na, layers, policy):
    """JAX's scanned stack under a remat policy (JAX rematerializes the NA
    stack under scan only) against the port model of its tree, and the
    unrolled JAX model's loss."""
    config, jmodel, params, batch = jax_case(na, layers, **NO_DROPOUT)
    scfg = JaxConfig.from_dict({**config.to_dict(), "scan_layers": True, "gradient_checkpointing": policy})
    assert scan_period(StructuredTransformerConfig.from_dict(scfg.to_dict())) == (2, layers // 2)
    stacked = stack_layer_params(params, scfg)
    sjmodel = type(jmodel)(scfg)
    assert "h_scan" in stacked["params"]["encoder"]
    jloss = float(jax.jit(lambda p: jmodel.apply(p, batch).loss)(params))
    sloss, sgrads = jax_loss_and_grads(sjmodel, stacked, batch)

    tmodel = port_of(scfg, stacked)
    assert tmodel.config.scan_layers and tmodel.config.gradient_checkpointing == policy
    out = tmodel(to_torch(batch), is_generation=False)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), sloss, **TOL)
    np.testing.assert_allclose(out.loss.item(), jloss, **TOL)
    check_grads(tmodel, sgrads)

    want = flat(jax.tree_util.tree_map(np.asarray, stacked))
    got = flat(export_params(tmodel))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_scanned_tree_that_fits_neither_layout_raises():
    config, _, params, _ = jax_case(False, 2, **NO_DROPOUT)
    scfg = JaxConfig.from_dict({**config.to_dict(), "scan_layers": True})
    stacked = jax.tree_util.tree_map(np.asarray, stack_layer_params(params, scfg))
    bad = copy.deepcopy(stacked)
    bad["params"]["encoder"]["h_scan"]["b2"] = bad["params"]["encoder"]["h_scan"]["b1"]  # a third pattern position
    with pytest.raises(ValueError, match="has no port parameter|unfilled"):
        port_of(scfg, bad)


# ------------------------------------------------------------------ remat
def remat_model(kind: str, policy: str, scan: bool = False):
    """The port's small model of ``kind`` (``ci``, ``na``, ``packed``: CI under
    ``pallas_flash`` with a local window of 4 and rows of 128) under ``policy``."""
    if kind == "packed":
        _, batch = __graft_entry__._make_model_and_batch(seq_len=128, **NO_DROPOUT)
        config, _, params, _ = jax_case(False, 2, **NO_DROPOUT)
        overrides = dict(attention_implementation="pallas_flash", seq_window_size=4, max_seq_len=128,
                         input_dropout=0.1, resid_dropout=0.1)  # fmt: skip
    else:
        config, _, params, batch = jax_case(kind == "na", 2, **NO_DROPOUT)
        overrides = dict(DROPOUT)
    model = port_of(config, params, gradient_checkpointing=policy, scan_layers=scan, **overrides)
    return model, to_torch(batch)


def loss_and_grads(model, batch, seed=3):
    loss = model(batch, is_generation=False, dropout=torch.Generator().manual_seed(seed)).loss
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def plain_runs():
    """The ``"none"`` run of each kind, once."""
    return {kind: loss_and_grads(*remat_model(kind, "none")) for kind in ("ci", "na", "packed")}


@pytest.mark.parametrize("policy", [p for p in POLICIES if p != "none"])
@pytest.mark.parametrize("kind", ["ci", "na", "packed"])
def test_every_policy_equals_none_bit_for_bit_with_dropout(plain_runs, kind, policy):
    loss, grads = loss_and_grads(*remat_model(kind, policy))
    want_loss, want = plain_runs[kind]
    assert torch.equal(loss, want_loss)
    assert sorted(grads) == sorted(want)
    for n in want:
        assert torch.equal(grads[n], want[n]), n


@pytest.mark.parametrize("policy", POLICIES)
def test_attention_runs_once_under_save_attention_and_twice_when_recomputed(monkeypatch, policy):
    """The packed model's flash and band calls in one forward and backward:
    once a layer without remat or under ``save_attention``, twice under a
    policy that recomputes the block."""
    calls = {"flash": 0, "band": 0}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return wrapped

    monkeypatch.setattr(transformer_module, "flash_attention", counted("flash", transformer_module.flash_attention))
    monkeypatch.setattr(transformer_module, "band_local_attention",
                        counted("band", transformer_module.band_local_attention))  # fmt: skip
    model, batch = remat_model("packed", policy)
    loss_and_grads(model, batch)
    n = 1 if policy in ("none", "save_attention") else 2
    assert calls == {"flash": n, "band": n}


def test_scanned_model_under_remat_equals_unrolled(plain_runs):
    """``scan_layers`` with a policy is the unrolled model under it: the same modules, bit for bit."""
    loss, grads = loss_and_grads(*remat_model("ci", "dots_no_batch", scan=True))
    want_loss, want = plain_runs["ci"]
    assert torch.equal(loss, want_loss) and all(torch.equal(grads[n], want[n]) for n in want)


# ------------------------------------------------------------------ a scanned resume state
def test_scanned_jax_train_state_resumes_as_the_unrolled_one():
    config, jmodel, params, batch = jax_case(False, 4, **NO_DROPOUT)
    tx, _ = jax_build_optimizer(JaxOptimizationConfig(**OPT))
    jparams = jax.tree_util.tree_map(jnp.array, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(jparams))
    jstep = jax_make_train_step(jmodel, tx)
    for _ in range(2):
        state, _ = jstep(state, batch, jax.random.PRNGKey(0))
    adam = state.opt_state[0]
    host = jax.tree_util.tree_map(np.asarray, (state.params, adam.mu, adam.nu))
    scfg = JaxConfig.from_dict({**config.to_dict(), "scan_layers": True})
    count, step = int(adam.count), int(state.step)
    unrolled = train_state_from_jax(config, *host, count, step)
    scanned = train_state_from_jax(scfg, *(stack_layer_params(t, scfg) for t in host), count, step)
    for part in ("params",):
        assert all(torch.equal(scanned[part][n], unrolled[part][n]) for n in unrolled[part])
    for field in ("exp_avg", "exp_avg_sq", "step"):
        assert all(torch.equal(scanned["adam"][field][n], unrolled["adam"][field][n]) for n in unrolled["adam"][field])

    after = []
    for cfg, sd in ((config, unrolled), (scfg, scanned)):
        tcfg = StructuredTransformerConfig.from_dict(cfg.to_dict())
        model = build_model(tcfg)
        optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
        load_train_state(sd, model, optimizer, scheduler, TrainState())
        optimizer.zero_grad()
        model(to_torch(batch), is_generation=False).loss.backward()
        optimizer.step()
        after.append(train_state_dict(model, optimizer, scheduler, TrainState(step=step + 1)))
    assert all(torch.equal(after[0]["params"][n], after[1]["params"][n]) for n in after[0]["params"])
    jstate, _ = jstep(state, batch, jax.random.PRNGKey(0))
    want = flat(jax.tree_util.tree_map(np.asarray, stack_layer_params(jax.device_get(jstate.params), scfg)))
    got = flat(export_params(model))  # the scanned model: the stacked tree
    assert sorted(got) == sorted(want)
    # ``tests/test_torch_train.py``'s rule for AdamW steps against JAX's.
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())


# ------------------------------------------------------------------ kernel E's head_dim 128
def test_jax_flash_attention_at_head_dim_128_matches_the_plain_version():
    """JAX's TPU flash kernel in interpret mode (causal, segment ids, unscaled
    logits) at D = 128 against `flash_attention_reference`, fp32."""
    from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds

    rng = np.random.default_rng(0)
    B, H, S, D = 1, 2, 128, 128
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32) * s for s in (0.3, 0.3, 1.0))
    seg = np.repeat(np.arange(4), S // 4)[None].astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   segment_ids=SegmentIds(jnp.asarray(seg), jnp.asarray(seg)), causal=True,
                                   sm_scale=1.0, block_sizes=None)  # fmt: skip
    got = flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ serving a scanned checkpoint
def test_na_spec_engine_refuses_a_scanned_model():
    config, _, params, batch = jax_case(True, 2, **NO_DROPOUT)
    model = port_of(config, params, scan_layers=True)
    dcfg, draft = truncated_draft(model.config, model, 1)
    with pytest.raises(ValueError, match="NA speculative decoding requires the unrolled layer stack"):
        GenerationEngine(model, model.config, template=to_torch(batch), n_slots=2, max_len=24,
                         spec=SpecConfig(model=draft, config=dcfg, k=2), device="cpu")  # fmt: skip
    with pytest.raises(NotImplementedError, match="require the unrolled layer stack"):
        model.encoder(to_torch(batch), return_contextualized=True)


def test_ci_engine_over_a_scanned_checkpoint_serves_the_unrolled_events(tmp_path):
    from eventstreamgpt_tpu_torch.convert import checkpoint_from_jax
    from eventstreamgpt_tpu_torch.training import load_pretrained

    config, _, params, batch = jax_case(False, 4, **NO_DROPOUT)
    scfg = JaxConfig.from_dict({**config.to_dict(), "scan_layers": True})
    checkpoint_from_jax(jax.tree_util.tree_map(np.asarray, stack_layer_params(params, scfg)), scfg, tmp_path / "s")
    checkpoint_from_jax(jax.tree_util.tree_map(np.asarray, params), config, tmp_path / "u")
    prompt = to_torch(batch).slice((slice(0, 1), slice(0, 8)))
    events = []
    for d in ("s", "u"):
        model, cfg = load_pretrained(tmp_path / d, device="cpu")
        assert cfg.scan_layers == (d == "s")
        engine = GenerationEngine(model, cfg, template=prompt, n_slots=2, max_len=16, min_bucket=4, decode_chunk=2,
                                  device="cpu")  # fmt: skip
        res = engine.run([Request(prompt=prompt, max_new_events=4, request_id=i) for i in range(3)])
        assert all(r.error is None for r in res)
        events.append([(r.batch.dynamic_indices, r.batch.time_delta, r.batch.dynamic_values) for r in res])
    for a, b in zip(*events):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_scanned_and_remat_models_build_from_a_config_json(tmp_path):
    """``config.json`` with ``scan_layers`` and a policy round-trips (JAX reads it) and builds."""
    for na in (False, True):
        config, _, params, _ = jax_case(na, 2, **NO_DROPOUT)
        tcfg = StructuredTransformerConfig.from_dict({**config.to_dict(), "scan_layers": True,
                                                      "gradient_checkpointing": "save_attention"})  # fmt: skip
        tcfg.to_json_file(tmp_path / "config.json", do_overwrite=True)
        back = JaxConfig.from_json_file(tmp_path / "config.json")
        assert back.scan_layers and back.gradient_checkpointing == "save_attention"
        model = build_model(StructuredTransformerConfig.from_json_file(tmp_path / "config.json"))
        assert model.config.scan_layers and init_params_from_seed(model, 0) is model


# ------------------------------------------------------------------ the training programs under remat and scan
SMALL_WIDTHS = dict(sizes=(5, 40, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4)


@pytest.mark.parametrize("policy", ["block", "save_attention"])
def test_chunked_step_under_remat_and_scan_equals_the_plain_chunks(policy):
    """Two chunks of 2 collate-and-train steps over resident tables, dropout
    0.1: under ``policy`` with ``scan_layers`` they equal the plain chunks
    bit for bit (health vectors, weights, AdamW state)."""
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
    from eventstreamgpt_tpu_torch.data.synthetic import (
        serving_config,
        synthetic_csr,
        synthetic_training_batches,
        training_config,
    )
    from eventstreamgpt_tpu_torch.data.torch_dataset import CSRDataset
    from eventstreamgpt_tpu_torch.training import make_chunked_train_step

    vocab = serving_config(precision="fp32", **SMALL_WIDTHS)
    batch = next(synthetic_training_batches(np.random.default_rng(0), vocab, 4, 16, mean_seq_len=12))
    csr = synthetic_csr(np.random.default_rng(0), vocab, 12, mean_seq_len=12)
    dd = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=16)), device="cpu")
    chunks = [plans for plans, _ in dd.plan_chunks(2, 2, seed=1)][:2]
    out = []
    for kw in ({}, dict(gradient_checkpointing=policy, scan_layers=True)):
        config = training_config([batch], precision="fp32", **SMALL_WIDTHS, **kw)
        model = init_params_from_seed(build_model(config), seed=0)
        optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
        step = make_chunked_train_step(model, optimizer, scheduler, dd, with_health=True, device="cpu")
        healths = torch.cat([step(plans, 7)[1] for plans in chunks])
        state = [t for st in optimizer.state.values() for _, t in sorted(st.items())]
        out.append((healths, [p.detach().clone() for p in model.parameters()], state))
    assert config.resid_dropout == 0.1 and torch.isfinite(out[0][0]).all()
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1] + out[0][2], out[1][1] + out[1][2]):
        assert torch.equal(a, b)


def test_train_cfg_under_remat_and_scan_equals_the_plain_run(tmp_path):
    """`train(cfg)` on the sample cohort with dropout 0.1, under ``block``
    with ``scan_layers``, writes the plain run's weights bit for bit, and
    its ``config.json`` keeps both knobs."""
    from pathlib import Path

    from eventstreamgpt_tpu_torch.training.pretrain import PretrainConfig
    from eventstreamgpt_tpu_torch.training.pretrain import train as pretrain

    from .test_torch_train import SMALL

    converted = Path(__file__).resolve().parents[1] / "sample_data" / "converted" / "sample"
    weights = []
    for name, kw in (("plain", {}), ("remat", dict(gradient_checkpointing="block", scan_layers=True))):
        pretrain(PretrainConfig(
            config=dict(SMALL, input_dropout=0.1, resid_dropout=0.1, attention_dropout=0.1, **kw), seed=1,
            save_dir=str(tmp_path / name),
            optimization_config=dict(init_lr=1e-3, batch_size=8, validation_batch_size=8, max_epochs=1,
                                     lr_frac_warmup_steps=0.1),
            data_config=dict(save_dir=str(converted), max_seq_len=16, min_seq_len=2),
            trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": 100},
            do_final_validation_on_metrics=False,
        ), device="cpu")  # fmt: skip
        weights.append(torch.load(tmp_path / name / "pretrained_weights" / "model.pt", weights_only=True))
    saved = StructuredTransformerConfig.from_json_file(tmp_path / "remat" / "config.json")
    assert saved.gradient_checkpointing == "block" and saved.scan_layers
    assert sorted(weights[0]) == sorted(weights[1])
    assert all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0])
