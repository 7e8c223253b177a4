"""The port's packed long-context CI train step against the JAX one, on the CPU.

The JAX CI model under ``attention_implementation="pallas_flash"`` with
attention dropout 0 (``bench.py``'s packed model at a small width: hidden 64,
2 heads of 32, layers local/global, fp32) and the port on the same weights
(`load_jax_params`) and the same packed batch: two rows of 256 events from
``JaxDataset.packed_batches`` over a DL cache written by
``write_synthetic_dataset``. On the CPU, JAX takes the einsum path on the
global layer (its kernels need a TPU backend) and the band on a local layer
of window 32; the port takes kernel E's plain version and the band. With a
local window of 160 JAX takes the windowed einsum and the port kernel F's
plain version.

Both models get the same event ``time``, computed in float64 with each
segment's reset and rounded once to fp32: a packed row's cumulative time
runs on across its subjects to ~1e4 minutes, where XLA's and torch's fp32
cumulative sums (taken in different orders) differ by ulps of ~1e-3
minutes, which the sinusoids carry into every gradient (ROADMAP.md Queue
3). `test_packed_time_matches_jax` holds the port's own ``time_from_deltas``
to JAX's within those ulps.

Checked, with the tolerances of ``tests/test_torch_train.py``: the loss and
every per-head loss within 1e-5, every gradient within 1e-4 of its tensor's
largest gradient plus 1e-6, and three AdamW steps (losses within 1e-5;
parameters within 1e-5 but for at most 0.1% of the elements, none beyond
1e-4). Beside them: which route each layer took, the flax tree of a
``pallas_flash`` model filling the port's with no leaf left, and the port's
own invariant from ``tests/test_packed_attention.py``: a packed row gives
each subject the encodings it gets alone in a padded row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventstreamgpt_tpu_torch.models.transformer as transformer_module
from eventstreamgpt_tpu.data import JaxDataset, PytorchDatasetConfig
from eventstreamgpt_tpu.data.synthetic import write_synthetic_dataset
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.transformer import time_from_deltas as jax_time_from_deltas
from eventstreamgpt_tpu.training import TrainState as JaxTrainState
from eventstreamgpt_tpu.training import build_optimizer as jax_build_optimizer
from eventstreamgpt_tpu.training import make_train_step as jax_make_train_step
from eventstreamgpt_tpu_torch.convert import export_params, init_params_from_seed, load_jax_params, port_name
from eventstreamgpt_tpu_torch.data.synthetic import serving_config
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig, StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.transformer import (
    ConditionallyIndependentPointProcessTransformer,
    time_from_deltas,
)
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step, train_steps

from .test_torch_train import OPT, SMALL, TOL, flat, head_losses, to_torch

SEQ_LEN = 256
PACKED = dict(
    SMALL, hidden_size=64, head_dim=32, num_attention_heads=2, intermediate_size=64,
    attention_implementation="pallas_flash",
)  # fmt: skip
WINDOWS = (32, 160)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{window: (jax config, jax model, flax params, jax packed batch)}."""
    path = tmp_path_factory.mktemp("packed_dl")
    write_synthetic_dataset(
        path, {"train": 16, "tuning": 4, "held_out": 4}, n_event_types=6, n_labs=40, n_meds=8,
        mean_seq_len=60, max_seq_len=200, seed=0,
    )  # fmt: skip
    ds = JaxDataset(PytorchDatasetConfig(save_dir=path, max_seq_len=SEQ_LEN, min_seq_len=2), "train")
    batch = next(ds.packed_batches(2, seq_len=SEQ_LEN, seed=1))
    assert batch.event_mask.shape == (2, SEQ_LEN) and np.asarray(batch.segment_ids).max() >= 2
    assert not np.asarray(batch.event_mask).all()  # padding at a row's end, too
    batch = batch.replace(time=jnp.asarray(segment_time(batch)))
    out = {}
    for window in WINDOWS:
        config = JaxConfig(**{**PACKED, "seq_window_size": window})
        config.set_to_dataset(ds)
        config.max_seq_len = SEQ_LEN
        jmodel = JaxModel(config)
        out[window] = (config, jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(1), batch), batch)
    return out


def segment_time(batch) -> np.ndarray:
    """Each event's minutes since its segment's first event, in float64, as fp32."""
    td = np.where(np.asarray(batch.event_mask), np.asarray(batch.time_delta, np.float64), 0.0)
    seg = np.asarray(batch.segment_ids)
    t = np.zeros_like(td)
    for b in range(td.shape[0]):
        for i in range(1, td.shape[1]):
            t[b, i] = 0.0 if seg[b, i] != seg[b, i - 1] else t[b, i - 1] + td[b, i - 1]
    return t.astype(np.float32)


def test_packed_time_matches_jax(cases):
    """Without ``time``, each package takes it from the deltas: equal within
    4 fp32 ulps of the row's cumulative time."""
    _, _, _, jbatch = cases[32]
    jbatch = jbatch.replace(time=None)
    want = np.asarray(jax_time_from_deltas(jbatch))
    got = time_from_deltas(to_torch(jbatch)).numpy()
    total = np.asarray(jbatch.time_delta).sum(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 4 * np.spacing(total.astype(np.float32))).all()
    np.testing.assert_allclose(got, segment_time(jbatch), atol=float(4 * np.spacing(np.float32(total.max()))))


def port_model(config, params):
    tcfg = StructuredTransformerConfig.from_dict(config.to_dict())
    assert tcfg.attention_implementation == "pallas_flash" and tcfg.attention_dropout == 0.0
    return load_jax_params(build_model(tcfg), jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture
def routes(monkeypatch):
    """Records each attention call the port's layers make: ``("flash", window)`` or ``("band", window)``."""
    seen = []
    flash, band = transformer_module.flash_attention, transformer_module.band_local_attention

    def spy_flash(q, k, v, seg, window=None):
        seen.append(("flash", window))
        return flash(q, k, v, seg, window)

    def spy_band(q, k, v, seg, window, chunk_size=None):
        seen.append(("band", window))
        return band(q, k, v, seg, window, chunk_size)

    monkeypatch.setattr(transformer_module, "flash_attention", spy_flash)
    monkeypatch.setattr(transformer_module, "band_local_attention", spy_band)
    return seen


@pytest.mark.parametrize("window", WINDOWS)
def test_losses_and_gradients_match_jax(cases, routes, window):
    config, jmodel, params, jbatch = cases[window]

    def loss_fn(p):
        out = jmodel.apply(p, jbatch)
        return out.loss, out.losses

    (jloss, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tmodel = port_model(config, params)
    out = tmodel(to_torch(jbatch), is_generation=False)
    out.loss.backward()
    # Layer 0 is local, layer 1 global (kernel E's route).
    assert routes == [("band" if window <= 128 else "flash", window), ("flash", None)]

    np.testing.assert_allclose(out.loss.item(), float(jloss), **TOL)
    want, got = head_losses(jlosses), head_losses(out.losses)
    assert sorted(got) == sorted(want) and "regression:lab" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    tparams = dict(tmodel.named_parameters())
    for path, g in flat(jgrads["params"]).items():
        name, transpose = port_name(path)
        tg = tparams[name].grad
        tg = np.zeros_like(g.T if transpose else g) if tg is None else tg.numpy()
        err = np.abs((tg.T if transpose else tg) - g).max()
        assert err <= 1e-4 * np.abs(g).max() + 1e-6, (name, err, np.abs(g).max())


@pytest.mark.parametrize("window", WINDOWS)
def test_three_adamw_steps_match_jax(cases, window):
    config, jmodel, params, jbatch = cases[window]
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
    tlosses = train_steps(make_train_step(tmodel, optimizer, scheduler, device="cpu"), [to_torch(jbatch)] * 3, 0)

    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    want, got = flat(jax.device_get(state.params)), flat(export_params(tmodel))
    assert sorted(got) == sorted(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-4, (int((diff > 1e-5).sum()), diff.size, diff.max())


def test_pallas_flash_params_fill_the_port_model(cases):
    """`load_jax_params` fills a ``pallas_flash`` port model from a JAX
    ``pallas_flash`` tree, no leaf left over and no parameter left unfilled
    (it raises on either); the export gives the same tree back."""
    config, _, params, _ = cases[160]
    model = port_model(config, params)
    want, got = flat(jax.device_get(params)), flat(export_params(model))
    assert sorted(got) == sorted(want)
    assert ("params", "encoder", "h1", "attn", "attention", "q_proj", "kernel") in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def subject(rng, L, M=4, vocab=(5, 40)) -> dict:
    meas = np.full((L, M), 2)
    meas[:, 0] = 1
    idx = np.where(meas == 1, rng.integers(2, 1 + vocab[0], size=(L, M)), rng.integers(7, 6 + vocab[1], size=(L, M)))
    return dict(
        # Short gaps: a packed row's cumulative time runs on across subjects,
        # and its fp32 rounding (Queue 3 of ROADMAP.md) should stay below the tolerance.
        time_delta=rng.uniform(0.05, 0.2, size=L).astype(np.float32),
        dynamic_indices=idx,
        dynamic_measurement_indices=meas,
        dynamic_values=rng.normal(size=(L, M)).astype(np.float32),
        dynamic_values_mask=(meas == 2) & (rng.random((L, M)) < 0.5),
    )


def rows(subjects, L, packed: bool) -> EventStreamBatch:
    """One subject per right-padded row, or all of them packed into one row."""
    B, M = (1 if packed else len(subjects)), subjects[0]["dynamic_indices"].shape[1]
    out = dict(
        event_mask=np.zeros((B, L), bool),
        time_delta=np.zeros((B, L), np.float32),
        dynamic_indices=np.zeros((B, L, M), np.int64),
        dynamic_measurement_indices=np.zeros((B, L, M), np.int64),
        dynamic_values=np.zeros((B, L, M), np.float32),
        dynamic_values_mask=np.zeros((B, L, M), bool),
    )
    seg = np.zeros((B, L), np.int64)
    pos = 0
    for i, s in enumerate(subjects):
        n = len(s["time_delta"])
        b, lo = (0, pos) if packed else (i, 0)
        out["event_mask"][b, lo : lo + n] = True
        for k, v in s.items():
            out[k][b, lo : lo + n] = v
        seg[b, lo:] = i
        pos += n
    batch = EventStreamBatch(**{k: torch.from_numpy(v) for k, v in out.items()})
    return batch.replace(segment_ids=torch.from_numpy(seg)) if packed else batch


@pytest.mark.parametrize("window", WINDOWS)
def test_packed_row_matches_padded_rows(window):
    """The port's gold invariant of packing, on its pallas_flash routes: each
    subject's encodings in one packed row of 256 equal those it gets alone
    in a padded row of 128 (kernel E's and F's plain versions, and the band)."""
    config = serving_config(precision="fp32", sizes=(5, 40, 6, 3), **{**PACKED, "seq_window_size": window})
    encoder = init_params_from_seed(ConditionallyIndependentPointProcessTransformer(config), seed=0, std=0.1)
    rng = np.random.default_rng(window)
    subjects = [subject(rng, n) for n in (70, 100, 50)]
    with torch.no_grad():
        pad = encoder(rows(subjects, 128, packed=False)).last_hidden_state
        pack = encoder(rows(subjects, 256, packed=True)).last_hidden_state
    pos = 0
    for i, s in enumerate(subjects):
        n = len(s["time_delta"])
        torch.testing.assert_close(pack[0, pos : pos + n], pad[i, :n], rtol=2e-4, atol=2e-5)
        pos += n
