"""The PyTorch port's nested-attention (NA) model against the JAX one, on the CPU.

Three batches, each through both packages with the JAX weights carried over
by `load_jax_params`, every dropout at 0, in fp32, JAX reaching the TPU
dep-graph kernel in interpret mode (``dep_graph_attention_impl="pallas_interpret"``)
and the port kernel D's plain version:

* ``entry``: ``__graft_entry__._make_model_and_batch(na=True)`` (levels
  ``[[], ["event_type"], ["lab"]]``, multi-label and indexed-regression ``lab``);
* ``entry_packed``: the same batch with two packed segments a row
  (``segment_ids``: sequence attention within a segment, no history across one);
* ``synthetic_dl``: one `JaxDataset` batch over a small DL cache written by
  ``write_synthetic_dataset``, with ``bench.py``'s NA levels
  ``[[], ["event_type"], ["lab", "med"]]`` and statics.

Checked, with the CI train test's tolerances (``tests/test_torch_train.py``):
the total loss and every per-measurement loss within 1e-5, every parameter
gradient within 1e-4 of its tensor's largest gradient plus 1e-6, three AdamW
steps (losses within 1e-5, exported parameters within 1e-5 but for at most
0.1% of the elements, none beyond 1e-4; an element whose starting gradient
is within fp32 noise of 0 moves by up to the learning rate a step either
way, so those are held within 3 x init_lr), and the bf16 forward loss within
2e-2 relative. Beside them: the grouped (dep-graph) embedding in joint and
split modes, forward and table gradients within 1e-6; JAX's einsum
dep-graph route (``dep_graph_fused_attention=False``, which selects nothing
in the port) against the port, with the gradient test's tolerances; the flax
tree round trip through `load_jax_params` and `export_params`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu.data.types import EventStreamBatch as JaxBatch
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.embedding import DataEmbeddingLayer as JaxEmbedding
from eventstreamgpt_tpu.models.na_model import NAPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_train_step as jax_make_train_step
from eventstreamgpt_tpu_torch.convert import export_params, load_jax_params, port_name
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.embedding import DataEmbeddingLayer
from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step, train_steps

from .test_torch_train import NO_DROPOUT, OPT, SMALL, TOL, flat, head_losses, to_torch

NA = dict(
    structured_event_processing_mode="nested_attention",
    dep_graph_attention_types="global",
    do_full_block_in_seq_attention=False,
    do_full_block_in_dep_graph_attention=True,
    dep_graph_attention_impl="pallas_interpret",
)
BENCH_LEVELS = [[], ["event_type"], ["lab", "med"]]
CASES = ("entry", "entry_packed", "synthetic_dl")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{name: (jax config, jax model, flax params, jax batch)} built once."""
    out = {}
    model, batch = __graft_entry__._make_model_and_batch(na=True, dep_graph_attention_impl="pallas_interpret", **NO_DROPOUT)
    out["entry"] = (model.config, batch)
    seg = np.where(np.arange(batch.event_mask.shape[1]) < 6, 0, 1)[None].repeat(batch.event_mask.shape[0], 0)
    mask = np.asarray(batch.event_mask).copy()
    mask[:, 5] = False
    out["entry_packed"] = (model.config, batch.replace(segment_ids=jnp.asarray(seg), event_mask=jnp.asarray(mask)))
    synth = tmp_path_factory.mktemp("synthetic_dl_na")
    write_synthetic_dataset(
        synth, {"train": 8, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=10, max_seq_len=24, seed=0,
    )  # fmt: skip
    ds = JaxDataset(PytorchDatasetConfig(save_dir=synth, max_seq_len=16, min_seq_len=2), "train")
    config = JaxConfig(**SMALL, **NA, measurements_per_dep_graph_level=BENCH_LEVELS)
    config.set_to_dataset(ds)
    out["synthetic_dl"] = (config, next(ds.batches(4, shuffle=False)))
    built = {}
    for name, (config, batch) in out.items():
        jmodel = JaxModel(config)
        built[name] = (config, jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(1), batch), batch)
    return built


def port_model(config, params, **overrides) -> NAPPTForGenerativeSequenceModeling:
    tcfg = StructuredTransformerConfig.from_dict({**config.to_dict(), **overrides})
    model = build_model(tcfg)
    assert isinstance(model, NAPPTForGenerativeSequenceModeling)
    return load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))


def check_losses_and_gradients(case, jmodel, params, jbatch, tmodel):
    """The port's loss, per-measurement losses and parameter gradients against JAX's."""

    def loss_fn(p):
        out = jmodel.apply(p, jbatch)
        return out.loss, out.losses

    (jloss, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = tmodel(to_torch(jbatch), is_generation=False)
    out.loss.backward()

    np.testing.assert_allclose(out.loss.item(), float(jloss), **TOL)
    want, got = head_losses(jlosses), head_losses(out.losses)
    assert sorted(got) == sorted(want)
    assert "regression:lab" in got  # the indexed head (kernel C's path) is on
    if case == "synthetic_dl":
        assert {"classification:event_type", "classification:lab", "classification:med"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)

    tparams = dict(tmodel.named_parameters())
    for path, g in flat(jgrads["params"]).items():
        name, transpose = port_name(path)
        tg = tparams[name].grad
        tg = np.zeros_like(g.T if transpose else g) if tg is None else tg.numpy()
        err = np.abs((tg.T if transpose else tg) - g).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-6, (name, err, np.abs(g).max())


@pytest.mark.parametrize("case", CASES)
def test_losses_and_gradients_match_jax(cases, case):
    config, jmodel, params, jbatch = cases[case]
    check_losses_and_gradients(case, jmodel, params, jbatch, port_model(config, params))


@pytest.mark.parametrize("case", ["synthetic_dl"])
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
    tmodel(to_torch(jbatch), is_generation=False).loss.backward()
    noise = {}  # elements whose starting gradient is within fp32 noise of 0
    for path, g in flat(export_grads(tmodel)).items():
        noise[path] = np.abs(g) <= 1e-5 * np.abs(g).max()
    optimizer, scheduler = build_optimizer(tmodel, OptimizationConfig(**OPT))
    step = make_train_step(tmodel, optimizer, scheduler, device="cpu")
    tlosses = train_steps(step, [to_torch(jbatch)] * 3, seed=0)

    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    want, got = flat(jax.device_get(state.params)), flat(export_params(tmodel))
    assert sorted(got) == sorted(want)
    # The CI test's rule on every element with a real gradient. Where the
    # gradient is within fp32 noise of 0 (1e-5 of its tensor's largest), the
    # noise sets the sign of Adam's update, which moves the element by up
    # to the learning rate each step either way: within 3 x init_lr.
    diff = np.concatenate([np.abs(got[k] - want[k])[~noise[k]] for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())
    noisy = np.concatenate([np.abs(got[k] - want[k])[noise[k]] for k in want])
    assert (noisy <= 3 * OPT["init_lr"]).all(), noisy.max()


def export_grads(model) -> dict:
    """The model's gradients as a flax-shaped tree (`export_params` on a copy holding them)."""
    copy = NAPPTForGenerativeSequenceModeling(model.config)
    with torch.no_grad():
        for p, q in zip(copy.parameters(), model.parameters()):
            p.copy_(q.grad)
    return export_params(copy)


@pytest.mark.parametrize("case", ["entry", "synthetic_dl"])
def test_bf16_forward_loss_matches_jax(cases, case):
    config, _, params, jbatch = cases[case]
    jcfg = JaxConfig.from_dict({**config.to_dict(), "precision": "bf16"})
    jloss = float(jax.jit(lambda p: JaxModel(jcfg).apply(p, jbatch).loss)(params))
    tmodel = port_model(config, params, precision="bf16")
    with torch.no_grad():
        tloss = float(tmodel(to_torch(jbatch), is_generation=False).loss)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-2)


@pytest.mark.parametrize("case", ["entry", "synthetic_dl"])
def test_jax_einsum_dep_graph_route_matches_port(cases, case):
    """JAX's unfused einsum dep-graph route against the port, which accepts
    ``dep_graph_fused_attention=False`` and routes by device all the same."""
    config, _, params, jbatch = cases[case]
    jmodel = JaxModel(JaxConfig.from_dict({**config.to_dict(), "dep_graph_fused_attention": False}))
    tmodel = port_model(config, params, dep_graph_fused_attention=False)
    assert tmodel.config.dep_graph_fused_attention is False
    check_losses_and_gradients(case, jmodel, params, jbatch, tmodel)


def test_generation_outputs_cover_every_level(cases):
    config, jmodel, params, jbatch = cases["synthetic_dl"]
    jout = jax.jit(lambda p: jmodel.apply(p, jbatch, is_generation=True))(params)
    with torch.no_grad():
        tout = port_model(config, params)(to_torch(jbatch), is_generation=True)
    assert tout.loss is None
    assert sorted(tout.preds.classification) == sorted(jout.preds.classification)
    assert sorted(tout.preds.regression) == sorted(jout.preds.regression)
    # 1e-4: the cumulative event time (thousands of minutes) carries fp32 noise into the sinusoids.
    np.testing.assert_allclose(
        tout.preds.time_to_event.locs.numpy(), np.asarray(jout.preds.time_to_event.locs), rtol=1e-4, atol=1e-4
    )


def test_export_params_inverts_load(cases):
    config, _, params, _ = cases["synthetic_dl"]
    want, got = flat(jax.device_get(params)), flat(export_params(port_model(config, params)))
    assert sorted(got) == sorted(want)
    assert ("params", "encoder", "h1", "block", "dep_graph_block", "mlp", "c_fc", "kernel") in got
    assert ("params", "encoder", "input_layer", "data_embedding_layer", "embed_table") in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_step_with_dropout_is_reproducible(cases):
    config, _, params, jbatch = cases["entry"]
    rates = dict(attention_dropout=0.1, input_dropout=0.1, resid_dropout=0.1)

    def run(seed):
        model = port_model(config, params, **rates)
        optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
        return train_steps(make_train_step(model, optimizer, scheduler, device="cpu"), [to_torch(jbatch)] * 2, seed)

    with torch.no_grad():
        model = port_model(config, params, **rates)
        eval_loss = float(model(to_torch(jbatch), is_generation=False).loss)
        dropped = float(model(to_torch(jbatch), is_generation=False, dropout=torch.Generator().manual_seed(3)).loss)
    assert dropped != eval_loss
    assert run(0) == run(0) != run(1)


def embedding_inputs(seed=0, B=3, L=5, M=7, n_meas=4, vocab=20):
    rng = np.random.default_rng(seed)
    meas = rng.integers(0, n_meas + 1, size=(B, L, M))
    idx = np.where(meas == 0, 0, rng.integers(1, vocab, size=(B, L, M)))
    vals = rng.normal(size=(B, L, M)).astype(np.float32)
    return dict(
        event_mask=rng.random((B, L)) < 0.8,
        dynamic_indices=idx,
        dynamic_measurement_indices=meas,
        dynamic_values=vals,
        dynamic_values_mask=(meas > 0) & (rng.random((B, L, M)) < 0.6),
        static_indices=rng.integers(1, vocab, size=(B, 2)),
        static_measurement_indices=np.full((B, 2), 1),
    )


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "normalized"])
@pytest.mark.parametrize("mode", ["joint", "split"])
def test_grouped_embedding_matches_jax(mode, normalize):
    """The dep-graph grouped embedding and its table gradients, 1e-6."""
    groups = ((), (1,), (2, (3, "categorical_only")), ((3, "numerical_only"), 4))
    kw = dict(
        n_total_embeddings=20, out_dim=6, split_by_measurement_indices=groups,
        do_normalize_by_measurement_index=normalize, static_weight=0.3, dynamic_weight=0.7,
        categorical_weight=0.4, numerical_weight=0.6,
    )  # fmt: skip
    if mode == "split":
        kw.update(categorical_embedding_dim=5, numerical_embedding_dim=3)
    arrays = embedding_inputs()
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jlayer = JaxEmbedding(**kw)
    params = jlayer.init(jax.random.PRNGKey(0), jbatch)
    cot = np.random.default_rng(1).normal(size=(3, 5, len(groups), 6)).astype(np.float32)
    jout = jax.jit(lambda p: jlayer.apply(p, jbatch))(params)
    (jgrads,) = jax.jit(lambda p: jax.vjp(lambda q: jlayer.apply(q, jbatch), p)[1](jnp.asarray(cot)))(params)

    layer = load_jax_params(DataEmbeddingLayer(**kw), jax.tree_util.tree_map(np.asarray, params))
    out = layer(EventStreamBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}))
    assert out.shape == (3, 5, len(groups), 6)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    tparams = dict(layer.named_parameters())
    for path, g in flat(jgrads["params"]).items():
        name, transpose = port_name(path)
        tg = tparams[name].grad.numpy()
        np.testing.assert_allclose(tg.T if transpose else tg, g, rtol=1e-6, atol=1e-6, err_msg=name)
