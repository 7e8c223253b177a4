"""The PyTorch port's chunked train step (`make_chunked_train_step`), on the CPU.

The data is a small DL cache written by ``write_synthetic_dataset``: a
`JaxDataset` over it with the JAX package's `DeviceDataset`, and the port's
`CSRDataset` over that dataset's ``data`` (numpy arrays) with the port's
`DeviceDataset`. Three models at a small width (``tests/test_torch_train.py``'s
``SMALL``): the CI model on padded rows of 16 events, the nested-attention
model (``bench.py``'s three dep-graph levels) on the same rows, and the CI
model under ``pallas_flash`` on packed rows of 32 events.

* K steps a chunk equal K single steps (`make_train_step`) on the same plans
  collated by `DeviceDataset.batches` / ``packed_batches``, bit for bit, with
  dropout on: every loss (and ``[loss, grad norm]``), every parameter, every
  AdamW state tensor, ``state.step``, the scheduler's step and the learning
  rate after the chunks (a trailing short chunk included).
* The port's chunked step equals JAX's ``make_chunked_train_step`` on the same
  weights (`load_jax_params`) and the same plans, dropout off (threefry
  streams cannot be reproduced), within ``tests/test_torch_train.py``'s
  tolerances: losses within 1e-5; parameters within 1e-5 but for at most 0.1%
  of the elements, none beyond 1e-4.
* ``_plan_event_count`` equals JAX's, on whole and sliced chunks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.data import DeviceDataset as JaxDeviceDataset
from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import build_model as jax_build_model
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_chunked_train_step as jax_make_chunked_train_step
from eventstreamgpt_tpu.training.pretrain import _plan_event_count as jax_plan_event_count
from eventstreamgpt_tpu_torch.convert import export_params, init_params_from_seed, load_jax_params
from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_chunked_train_step, make_train_step
from eventstreamgpt_tpu_torch.training.pretrain import _plan_event_count

from .test_torch_device_dataset import port_dataset
from .test_torch_train import OPT, SMALL, TOL, flat

NA = dict(
    structured_event_processing_mode="nested_attention",
    measurements_per_dep_graph_level=[[], ["event_type"], ["lab", "med"]],
    dep_graph_attention_types="global",
    do_full_block_in_seq_attention=False,
    do_full_block_in_dep_graph_attention=True,
)
MODELS = {
    "ci": (False, {}),
    "na": (False, NA),
    "packed": (True, dict(attention_implementation="pallas_flash", head_dim=16, num_attention_heads=2)),
}
PADDED_LEN, PACKED_LEN, BATCH = 16, 32, 2
DROPOUT = dict(input_dropout=0.1, resid_dropout=0.1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{packed: (JaxDataset, JAX DeviceDataset, port DeviceDataset)}."""
    path = tmp_path_factory.mktemp("chunked_dl")
    write_synthetic_dataset(
        path, {"train": 16, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=12, max_seq_len=30, seed=0,
    )  # fmt: skip
    out = {}
    for packed, L in ((False, PADDED_LEN), (True, PACKED_LEN)):
        jds = JaxDataset(PytorchDatasetConfig(save_dir=path, max_seq_len=L, min_seq_len=2), "train")
        out[packed] = (jds, JaxDeviceDataset(jds), DeviceDataset(port_dataset(jds), device="cpu"))
    return out


def plan_stream(dd, packed, k):
    """One epoch's chunks of ``k`` steps and, for the single steps, its batches."""
    if packed:
        return list(dd.packed_plan_chunks(BATCH, k, seq_len=PACKED_LEN, seed=1)), list(
            dd.packed_batches(BATCH, seq_len=PACKED_LEN, seed=1)
        )
    return list(dd.plan_chunks(BATCH, k, seed=1)), list(dd.batches(BATCH, seed=1))


def jax_config(name, jds, **overrides):
    packed, extra = MODELS[name]
    config = JaxConfig(**{**SMALL, **extra, **overrides})
    config.set_to_dataset(jds)
    if packed:
        config.max_seq_len = PACKED_LEN
    return config


def optimizer_state(optimizer) -> list:
    return [t for st in optimizer.state.values() for _, t in sorted(st.items())]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chunk_equals_single_steps_bitwise_with_dropout(data, name):
    packed = MODELS[name][0]
    jds, _, dd = data[packed]
    k = 2 if packed else 3
    chunks, batches = plan_stream(dd, packed, k)
    n = sum(len(next(iter(p.values()))) for p, _ in chunks)
    assert len(batches) >= n >= 2 and n % k == (0 if packed else 2)  # padded: a trailing short chunk
    batches = batches[:n]  # the packed chunks drop a short last batch
    config = StructuredTransformerConfig.from_dict(jax_config(name, jds, **DROPOUT).to_dict())
    assert config.resid_dropout == 0.1

    def fresh():
        model = init_params_from_seed(build_model(config), seed=0)
        return model, *build_optimizer(model, OptimizationConfig(**OPT))

    m1, o1, s1 = fresh()
    chunk_step = make_chunked_train_step(m1, o1, s1, dd, packed=packed, with_health=True, device="cpu")
    losses, healths = zip(*(chunk_step(plans, 7) for plans, _ in chunks))
    m2, o2, s2 = fresh()
    step = make_train_step(m2, o2, s2, with_health=True, device="cpu")
    single = [step(b, 7)[1] for b in batches]

    assert torch.isfinite(torch.stack(single)).all()
    assert torch.equal(torch.cat(healths), torch.stack(single))
    assert torch.equal(torch.cat(losses), torch.stack(single)[:, 0])
    for (name1, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), name1
    assert all(torch.equal(a, b) for a, b in zip(optimizer_state(o1), optimizer_state(o2)))
    assert chunk_step.state.step == step.state.step == n
    assert s1.last_epoch == s2.last_epoch == n and o1.param_groups[0]["lr"] == o2.param_groups[0]["lr"]
    s = chunk_step.stats()
    assert (s["cuda_graph"], s["chunk_keys"]) == (False, len({len(next(iter(p.values()))) for p, _ in chunks}))


def test_chunk_dropout_depends_on_seed_and_step(data):
    """Each step of a chunk draws its own stream: a different seed, or the
    same plans one step later, give other losses."""
    jds, _, dd = data[False]
    chunks, _ = plan_stream(dd, False, 3)
    config = StructuredTransformerConfig.from_dict(jax_config("ci", jds, **DROPOUT).to_dict())

    def run(seed):
        model = init_params_from_seed(build_model(config), seed=0)
        step = make_chunked_train_step(model, *build_optimizer(model, OptimizationConfig(**OPT)), dd, device="cpu")
        return step(chunks[0][0], seed)

    a, b = run(7), run(8)
    assert torch.equal(a, run(7)) and not torch.equal(a, b)
    assert a[0] != a[1]  # steps 0 and 1 differ in batch, rate 0 (warmup) and dropout stream


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chunk_matches_jax_chunked_step(data, name):
    packed = MODELS[name][0]
    jds, jdd, dd = data[packed]
    config = jax_config(name, jds)
    jmodel = jax_build_model(config)
    chunks, _ = plan_stream(jdd, packed, 2)
    init = next(jds.packed_batches(BATCH, seq_len=PACKED_LEN, seed=1) if packed else jds.batches(BATCH, seed=1))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), init)

    tx, _ = jax_build_optimizer(JaxOptimizationConfig(**OPT))
    jparams = jax.tree_util.tree_map(jnp.array, params)  # the step donates its state
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(jparams))
    jstep = jax_make_chunked_train_step(jmodel, tx, jdd, packed=packed)
    jlosses = []
    for plans, _ in chunks:
        state, losses = jstep(state, jdd.arrays, plans, jax.random.PRNGKey(0))
        jlosses += np.asarray(losses).tolist()

    tmodel = load_jax_params(
        build_model(StructuredTransformerConfig.from_dict(config.to_dict())), jax.tree_util.tree_map(np.asarray, params)
    )
    optimizer, scheduler = build_optimizer(tmodel, OptimizationConfig(**OPT))
    tstep = make_chunked_train_step(tmodel, optimizer, scheduler, dd, packed=packed, device="cpu")
    tlosses = torch.cat([tstep(plans, 0) for plans, _ in chunks]).tolist()

    assert len(tlosses) == len(jlosses) >= 4 and int(state.step) == tstep.state.step
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    want, got = flat(jax.device_get(state.params)), flat(export_params(tmodel))
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_plan_event_count_matches_jax(data, packed):
    jds, jdd, dd = data[packed]
    chunks, _ = plan_stream(dd, packed, 3)
    for plans, n_events in chunks:
        assert _plan_event_count(plans, dd.dataset) == jax_plan_event_count(plans, jds) == n_events
        head = {k: v[:1] for k, v in plans.items()}
        assert _plan_event_count(head, dd.dataset) == jax_plan_event_count(head, jds)
    if not packed:  # fill rows count nothing
        plans, _ = next(dd.plan_chunks(5, 1, shuffle=False, drop_last=False, skip_batches=3))
        assert not plans["valid_mask"].all()
        assert _plan_event_count(plans, dd.dataset) == jax_plan_event_count(plans, jds)


def test_chunk_refuses_plans_and_tables_it_cannot_run(data):
    jds, _, dd = data[False]
    config = StructuredTransformerConfig.from_dict(jax_config("ci", jds).to_dict())
    model = init_params_from_seed(build_model(config), seed=0)
    optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
    step = make_chunked_train_step(model, optimizer, scheduler, dd, device="cpu")
    plans, _ = next(data[True][2].packed_plan_chunks(BATCH, 2, seq_len=PACKED_LEN, seed=1))
    with pytest.raises(ValueError, match="plan chunk has the fields"):
        step(plans, 0)
    with pytest.raises(ValueError, match="tables are on"):
        make_chunked_train_step(model, optimizer, scheduler, dd, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_chunked_train_step(model, optimizer, scheduler, dd)
