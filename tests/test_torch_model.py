"""The PyTorch port's CI model forward against the JAX model.

Weights carry across with `eventstreamgpt_tpu_torch.convert.load_jax_params`;
both sides run fp32 on the CPU on the same numpy-made batch. Every head's
distribution parameters agree within 1e-5: uncached, prefill into a cache,
and one cached step on both cache layouts (shared cursor and per-row
cursors). This is where a wrong gelu form, LayerNorm formula or attention
logit scaling shows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.models.transformer import init_kv_caches as jax_init_kv_caches
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.models.transformer import init_kv_caches

from .test_generation import BASE_KWARGS, MEASUREMENT_CONFIGS, make_prompt

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN = 8


def to_torch(batch) -> EventStreamBatch:
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(EventStreamBatch)}
    return EventStreamBatch(**{k: None if v is None else torch.from_numpy(np.array(v)) for k, v in fields.items()})


def jax_config(**overrides):
    kw = dict(BASE_KWARGS)
    kw.update(overrides)
    return JaxConfig(measurement_configs=dict(MEASUREMENT_CONFIGS), **kw)


def build_pair(jcfg, seed=0):
    prompt = make_prompt(B=4, L=5)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), prompt)
    tcfg = StructuredTransformerConfig.from_dict(jcfg.to_dict())
    tmodel = CIPPTForGenerativeSequenceModeling(tcfg)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel, prompt


def flat_preds(preds):
    """{name: np.ndarray} over every distribution parameter of a preds container."""
    out = {}

    def add(prefix, dist):
        if dist is None:
            return
        for f in dataclasses.fields(dist):
            v = getattr(dist, f.name)
            if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
                out[f"{prefix}.{f.name}"] = np.asarray(v.detach() if torch.is_tensor(v) else v)

    for kind in ("classification", "regression"):
        for m, (obs, dist) in (getattr(preds, kind) or {}).items():
            add(f"{kind}:{m}:obs", obs)
            add(f"{kind}:{m}", dist)
    add("tte", preds.time_to_event)
    return out


def assert_preds_close(jpreds, tpreds):
    a, b = flat_preds(jpreds), flat_preds(tpreds)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)


CONFIGS = {
    "global_exponential": {},
    "local_lognormal_relu": dict(
        seq_attention_types=["local", "global"],
        seq_window_size=2,
        TTE_generation_layer_type="log_normal_mixture",
        TTE_lognormal_generation_num_components=3,
        mean_log_inter_event_time_min=1.5,
        std_log_inter_event_time_min=0.7,
        activation_function="relu",
    ),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_uncached_forward_matches_jax(name):
    jmodel, params, tmodel, prompt = build_pair(jax_config(**CONFIGS[name]))
    jout = jmodel.apply(params, prompt, is_generation=True)
    with torch.no_grad():
        tout = tmodel(to_torch(prompt), is_generation=True)
    assert_preds_close(jout.preds, tout.preds)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared_cursor", "per_row_cursor"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_then_cached_step_matches_jax(name, per_row):
    jcfg = jax_config(**CONFIGS[name])
    jmodel, params, tmodel, prompt = build_pair(jcfg)
    B, n_pre = prompt.batch_size, 4
    # Mask one row's last prompt event so the cache mask path is exercised.
    prompt = prompt.replace(event_mask=prompt.event_mask.at[1, n_pre - 1].set(False))
    head = prompt.slice((slice(None), slice(0, n_pre)))
    step = prompt.slice((slice(None), slice(n_pre, n_pre + 1)))

    jpre = jmodel.apply(
        params, head, past=jax_init_kv_caches(jcfg, B, max_len=MAX_LEN), use_cache=True, is_generation=True
    )
    tcfg = tmodel.config
    with torch.no_grad():
        tpre = tmodel(to_torch(head), past=init_kv_caches(tcfg, B, MAX_LEN, "cpu"), use_cache=True)
    assert_preds_close(jpre.preds, tpre.preds)
    for jc, tc in zip(jpre.past_key_values, tpre.past_key_values):
        np.testing.assert_allclose(tc.key.numpy(), np.asarray(jc.key), **TOL)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))

    jpast, tpast = jpre.past_key_values, tpre.past_key_values
    if per_row:
        jpast = tuple(c.replace(length=jnp.full((B,), n_pre, jnp.int32)) for c in jpast)
        tpast = tuple(dataclasses.replace(c, length=torch.full((B,), n_pre, dtype=torch.int32)) for c in tpast)
    # The cached step reads absolute time like the engine's one-event view.
    jstep = step.replace(time=jnp.asarray(np.asarray(prompt.time_delta)[:, :n_pre].sum(-1, keepdims=True)))
    jout = jmodel.apply(params, jstep, past=jpast, use_cache=True, is_generation=True)
    with torch.no_grad():
        tout = tmodel(to_torch(jstep), past=tpast, use_cache=True)
    assert_preds_close(jout.preds, tout.preds)
    for jc, tc in zip(jout.past_key_values, tout.past_key_values):
        np.testing.assert_allclose(tc.value.numpy(), np.asarray(jc.value), **TOL)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
