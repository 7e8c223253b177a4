"""The PyTorch port's quantized decode cache (int8 / fp8) against the JAX package's.

* `ops.kv_quant`: ``quantize_kv`` gives JAX's int8 codes and scales exactly
  and its fp8 codes bit for bit (compared as bytes), zero rows scale 1, the
  cache-dtype names resolve alike and ``kv_cache_bytes_per_slot`` agrees.
* Non-finite keys (a slot the health sentinel later quarantines): both
  packages give the same int8 codes and scales, and the same fp8 codes but
  one: where a NaN leaves the scale at 1 and another element exceeds e4m3's
  range, JAX's cast gives NaN and torch's (like the kernel's
  ``__NV_SATFINITE``) saturates to 448.
* The model's two cache branches (shared cursor at prefill, per-row cursors
  at decode) on int8 and fp8 caches: predictions within 1e-5, scales within
  1e-5 relative, codes equal (fp32, the same weights and batch).
* The greedy fp32 engine with ``kv_cache_dtype`` "int8" and "fp8" against the
  JAX engine with the same setting: integers and structure exact, floats
  within 1e-4; ``slots_report`` counts the same bytes a slot per dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.transformer import init_kv_caches as jax_init_kv_caches
from eventstreamgpt_tpu.ops import kv_quant as jkq
from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu_torch.models.transformer import init_kv_caches
from eventstreamgpt_tpu_torch.ops import kv_quant as tkq
from eventstreamgpt_tpu_torch.serving import GenerationEngine

from .test_torch_engine import CLOSE, ENGINE, EXACT, build, by_id, port_requests, prompt_rows, to_torch
from .test_torch_model import assert_preds_close, build_pair, jax_config

DTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jkq.FP8_DTYPE, tkq.FP8_DTYPE)}


def codes(x) -> np.ndarray:
    """Codes as comparable integers: int8 as they are, fp8 as their bytes."""
    if torch.is_tensor(x):
        return x.view(torch.uint8).numpy() if x.dtype == tkq.FP8_DTYPE else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == np.dtype(jkq.FP8_DTYPE) else x


def quantize_both(x: np.ndarray, name: str):
    jdt, tdt = DTYPES[name]
    jq, js = jkq.quantize_kv(jnp.asarray(x), jdt)
    tq, ts = tkq.quantize_kv(torch.from_numpy(x), tdt)
    return (codes(jq), np.asarray(js)), (codes(tq), ts.numpy())


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantize_matches_jax_bit_for_bit(name):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 4, 16, 64)) * rng.uniform(0.01, 30, size=(3, 4, 16, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero row: scale 1, zero codes
    x[0, 0, 1, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: ties round half to even
    x[0, 0, 1, 4:] = 0.0
    x[1, 1, 2, :] = 1e-30  # tiny values: fp8 subnormals
    x[1, 1, 2, 0] = 2e-30
    (jq, js), (tq, ts) = quantize_both(x, name)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert ts[0, 0, 0] == 1.0 and (tq[0, 0, 0] == 0).all()
    if name == "int8":
        assert tq[0, 0, 1, :4].tolist() == [127, 0, 2, -2]
    tdt = DTYPES[name][1]
    deq = tkq.dequantize_kv(tkq.quantize_kv(torch.from_numpy(x), tdt)[0], torch.from_numpy(ts), torch.float32)
    jdeq = jkq.dequantize_kv(jkq.quantize_kv(jnp.asarray(x), DTYPES[name][0])[0], jnp.asarray(js), jnp.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


def test_cache_dtype_names_and_bytes_match_jax():
    for name in (None, "auto", "fp32", "f32", "float32", "bf16", "bfloat16", "int8", "fp8"):
        for compute in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            jdt, jq = jkq.resolve_cache_dtype(name, compute[0])
            tdt, tq = tkq.resolve_cache_dtype(name, compute[1])
            assert tq == jq and tkq.cache_dtype_name(tdt) == jkq.cache_dtype_name(jdt), name
            assert tkq.is_quantized_dtype(tdt) == jkq.is_quantized_dtype(jdt)
    assert tkq.CACHE_DTYPES == jkq.CACHE_DTYPES
    for geometry in ((2, 4, 256, 64), (12, 8, 1024, 128), (3, 2, 7, 5)):
        for name in jkq.CACHE_DTYPES:
            assert tkq.kv_cache_bytes_per_slot(*geometry, name) == jkq.kv_cache_bytes_per_slot(*geometry, name)
    for bad in ("int4", "fp16"):
        for module, compute in ((jkq, jnp.float32), (tkq, torch.float32)):
            with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
                module.resolve_cache_dtype(bad, compute)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_nonfinite_keys_quantize_as_pinned(name):
    """Rows a quantized slot can hold before the health sentinel quarantines
    it: an inf key makes the scale inf (the other codes 0, the inf one
    0 in int8 and NaN in fp8); a NaN key leaves the scale at 1 (``NaN > 0``
    is false) and the row's codes at ``x`` itself, NaN giving int8 code 0
    and fp8 NaN. Both packages agree on all of it but one code: a value past
    fp8's range in a NaN row, which JAX's cast makes NaN and torch's (and the
    card's ``__NV_SATFINITE``) 448."""
    x = np.zeros((4, 8), np.float32)
    x[0] = [np.inf, 1, 2, 3, 4, 5, 6, 7]
    x[1] = [-np.inf, np.inf, 2, 3, 4, 5, 6, 7]
    x[2] = [np.nan, 1, 2, 3, 4, 5, 6, 100]
    x[3] = [np.nan, 1, 2, 3, 4, 5, 6, 500]
    (jq, js), (tq, ts) = quantize_both(x, name)
    np.testing.assert_array_equal(ts, js)
    assert np.isinf(ts[:2]).all() and (ts[2:] == 1.0).all()
    if name == "int8":
        np.testing.assert_array_equal(tq, jq)
        assert tq[:2].tolist() == [[0] * 8] * 2 and tq[2].tolist() == [0, 1, 2, 3, 4, 5, 6, 100]
        assert tq[3, -1] == 127
    else:
        def is_nan(b):  # e4m3fn's NaN: exponent and mantissa all ones, either sign
            return (int(b) & 0x7F) == 0x7F

        np.testing.assert_array_equal(tq[:3], jq[:3])
        assert is_nan(tq[0, 0]) and is_nan(tq[1, 0]) and is_nan(tq[1, 1]) and is_nan(tq[2, 0])
        np.testing.assert_array_equal(tq[3, :-1], jq[3, :-1])
        assert is_nan(jq[3, -1]) and torch.tensor(tq[3, -1]).view(tkq.FP8_DTYPE).float().item() == 448.0


@pytest.mark.parametrize("per_row", [False, True], ids=["shared_cursor", "per_row_cursor"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_model_cache_branches_match_jax(name, per_row):
    """Prefill into a quantized cache (the shared-cursor branch quantizes the
    chunk on write), then one cached step on either cursor layout (the
    per-row branch quantizes at each row's cursor): predictions, codes,
    scales and masks as JAX's (as ``tests/test_kv_quant.py`` pins JAX's own
    branches against each other)."""
    jcfg = jax_config()
    jmodel, params, tmodel, prompt = build_pair(jcfg)
    B, n_pre, max_len = prompt.batch_size, 4, 8
    prompt = prompt.replace(event_mask=prompt.event_mask.at[1, n_pre - 1].set(False))
    head = prompt.slice((slice(None), slice(0, n_pre)))
    step = prompt.slice((slice(None), slice(n_pre, n_pre + 1)))
    jpre = jmodel.apply(params, head, past=jax_init_kv_caches(jcfg, B, max_len=max_len, cache_dtype=name),
                        use_cache=True, is_generation=True)  # fmt: skip
    with torch.no_grad():
        tpre = tmodel(to_torch(head), past=init_kv_caches(tmodel.config, B, max_len, "cpu", cache_dtype=name),
                      use_cache=True)  # fmt: skip
    assert_preds_close(jpre.preds, tpre.preds)

    def same_caches(jcaches, tcaches):
        for jc, tc in zip(jcaches, tcaches):
            assert tc.key.dtype == DTYPES[name][1] and tc.key_scale.shape == tc.key.shape[:-1]
            for a, b in ((tc.key, jc.key), (tc.value, jc.value)):
                np.testing.assert_array_equal(codes(a), codes(b))
            for a, b in ((tc.key_scale, jc.key_scale), (tc.value_scale, jc.value_scale)):
                # amax of keys that differ from XLA's by fp32 ulps (the products' order)
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=0)
            np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))

    same_caches(jpre.past_key_values, tpre.past_key_values)
    jpast, tpast = jpre.past_key_values, tpre.past_key_values
    if per_row:
        jpast = tuple(c.replace(length=jnp.full((B,), n_pre, jnp.int32)) for c in jpast)
        tpast = tuple(dataclasses.replace(c, length=torch.full((B,), n_pre, dtype=torch.int32)) for c in tpast)
    jstep = step.replace(time=jnp.asarray(np.asarray(prompt.time_delta)[:, :n_pre].sum(-1, keepdims=True)))
    jout = jmodel.apply(params, jstep, past=jpast, use_cache=True, is_generation=True)
    with torch.no_grad():
        tout = tmodel(to_torch(jstep), past=tpast, use_cache=True)
    assert_preds_close(jout.preds, tout.preds)
    same_caches(jout.past_key_values, tout.past_key_values)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_greedy_quantized_engine_matches_jax_engine(name):
    jcfg, jmodel, params, tcfg, tmodel, prompt = build("local_lognormal")
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True, kv_cache_dtype=name, **ENGINE)
    jres = by_id(jeng.run([JaxRequest(prompt=p, max_new_events=b, request_id=i)
                           for i, (p, _, b) in enumerate(prompt_rows(prompt))]))  # fmt: skip
    teng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), greedy=True, kv_cache_dtype=name,
                            device="cpu", **ENGINE)  # fmt: skip
    tres = by_id(teng.run(port_requests(prompt)))
    assert sorted(jres) == sorted(tres) == list(range(5))
    for i, j in jres.items():
        t = tres[i]
        assert t.error is None and j.error is None
        for f in ("admission_index", "prompt_len", "n_events", "n_generated"):
            assert getattr(t, f) == getattr(j, f), (i, f)
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(
                getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), rtol=1e-4, atol=1e-4, err_msg=f
            )
    assert teng.key_cache.dtype == DTYPES[name][1] and teng.key_scale.dtype == torch.float32
    s = teng.stats()
    assert s["kv_cache_dtype"] == name
    planes = 2 * teng.key_cache.numel()  # one byte a code
    assert s["kv_cache_bytes"] == planes + 2 * 4 * teng.key_scale.numel()

    # Capacity: the same bytes a slot per dtype as the JAX report at this geometry and budget.
    jrep, trep = jeng.slots_report(hbm_gb=0.5), teng.slots_report(hbm_gb=0.5)
    assert trep["kv_cache_dtype"] == jrep["kv_cache_dtype"] == name
    assert sorted(trep["per_dtype"]) == sorted(jrep["per_dtype"])
    for d in jrep["per_dtype"]:
        assert trep["per_dtype"][d]["kv_bytes_per_slot"] == jrep["per_dtype"][d]["kv_bytes_per_slot"], d
        assert trep["per_dtype"][d]["max_slots"] > 0
    assert trep["per_dtype"][name]["max_slots"] > trep["per_dtype"]["fp32"]["max_slots"]
    with pytest.raises(ValueError, match="hbm_gb"):
        teng.slots_report()


def test_float_cache_dtype_other_than_compute_raises():
    _, _, _, tcfg, tmodel, prompt = build()
    with pytest.raises(ValueError, match="compute dtype only"):
        GenerationEngine(tmodel, tcfg, template=to_torch(prompt), kv_cache_dtype="bf16", device="cpu", **ENGINE)
    eng = GenerationEngine(tmodel, tcfg, template=to_torch(prompt), kv_cache_dtype="fp32", device="cpu", **ENGINE)
    assert eng.key_scale is None and eng.stats()["kv_cache_dtype"] == "fp32"
