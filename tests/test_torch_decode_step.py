"""Kernel B (the fused CI decode step) of the PyTorch port against the JAX kernel.

The JAX side runs ``decode_stack_step(impl="pallas_interpret")``; the port's
side is the plain PyTorch version the wrapper runs on CPU tensors. Two
layers with windows ``(2, 0)``, a ``(B, H, M, D)`` cache with mixed cursors
(one at the end of the buffer, which writes nothing), fp32: ``h`` within
1e-5, cache positions other than the cursor exact, mask and length exact.
The quantized variant (int8 and fp8 codes with scale tables) is held the
same way on the same codes and scales, its cursor codes and scales as
stated in its test. The CUDA kernel itself is checked on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.ops import kv_quant as jkq
from eventstreamgpt_tpu.ops.pallas_decode_step import decode_stack_step as jax_decode_stack_step
from eventstreamgpt_tpu.ops.pallas_decode_step import stack_layer_weights as jax_stack_layer_weights
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.ops import decode_step as tds
from eventstreamgpt_tpu_torch.ops import kv_quant as tkq
from eventstreamgpt_tpu_torch.ops.decode_step import (
    decode_stack_step,
    decode_stack_step_reference,
    stack_layer_weights,
)

from .test_generation import BASE_KWARGS, MEASUREMENT_CONFIGS, make_prompt

TOL = dict(rtol=1e-5, atol=1e-5)
B, M = 5, 8
START = np.array([0, 3, 5, 7, 8], np.int32)  # 8 == M: the write falls off the buffer
WINDOWS = (2, 0)


@pytest.fixture(scope="module")
def case():
    kw = dict(BASE_KWARGS, seq_attention_types=["local", "global"], seq_window_size=2, hidden_size=32, head_dim=8)
    jcfg = JaxConfig(measurement_configs=dict(MEASUREMENT_CONFIGS), **kw)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(1), make_prompt(B=2, L=3))
    tmodel = CIPPTForGenerativeSequenceModeling(StructuredTransformerConfig.from_dict(jcfg.to_dict()))
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(0)
    L, H, D, E = jcfg.num_hidden_layers, jcfg.num_attention_heads, jcfg.head_dim, jcfg.hidden_size
    inputs = dict(
        kc=rng.normal(size=(L, B, H, M, D)).astype(np.float32),
        vc=rng.normal(size=(L, B, H, M, D)).astype(np.float32),
        h0=rng.normal(size=(B, E)).astype(np.float32),
        em=np.array([True, True, False, True, True]),
        mask=(np.arange(M)[None, :] < START[:, None]) & (rng.random((B, M)) < 0.8),
    )
    return jcfg, params, tmodel, inputs


def run_jax(jcfg, params, x, start=START):
    weights = jax_stack_layer_weights(params["params"]["encoder"], jcfg.num_hidden_layers)
    out = jax_decode_stack_step(
        weights, jnp.asarray(x["kc"]), jnp.asarray(x["vc"]), None, None, jnp.asarray(x["h0"]),
        jnp.asarray(start), jnp.asarray(x["em"]), jnp.asarray(x["mask"]),
        windows=WINDOWS, activation=jcfg.activation_function,
        layer_norm_eps=float(jcfg.layer_norm_epsilon), impl="pallas_interpret",
    )  # fmt: skip
    h, kc, vc, _, _, mask, length = (None if a is None else np.asarray(a) for a in out)
    return h, kc, vc, mask, length


def run_port(tmodel, x, fn=decode_stack_step_reference, device="cpu", dtype=torch.float32, start=START):
    cfg = tmodel.config
    weights = {k: v.to(device) for k, v in stack_layer_weights(tmodel.encoder.blocks(), dtype).items()}
    kc = torch.from_numpy(x["kc"]).to(device, dtype)
    vc = torch.from_numpy(x["vc"]).to(device, dtype)
    out = fn(
        weights, kc, vc, torch.from_numpy(x["h0"]).to(device, dtype), torch.from_numpy(start).to(device),
        torch.from_numpy(x["em"]).to(device), torch.from_numpy(x["mask"]).to(device),
        windows=WINDOWS, activation=cfg.activation_function, layer_norm_eps=cfg.layer_norm_epsilon,
    )  # fmt: skip
    h, kc2, vc2, ks, vs, mask, length = out
    assert kc2 is kc and vc2 is vc and ks is None and vs is None  # the cache is updated in place
    return tuple(t.float().cpu().numpy() for t in (h, kc, vc, mask, length))


def cursor_onehot(start=START):
    return (np.arange(M)[None, :] == start[:, None])[None, :, None, :, None]  # (1, B, 1, M, 1)


def test_plain_version_matches_pallas_kernel(case):
    jcfg, params, tmodel, x = case
    want = run_jax(jcfg, params, x)
    got = run_port(tmodel, x)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    at = np.broadcast_to(cursor_onehot(), x["kc"].shape)
    for i in (1, 2):
        np.testing.assert_array_equal(got[i][~at], want[i][~at])  # untouched positions: exact
        np.testing.assert_allclose(got[i][at], want[i][at], **TOL)  # the written keys/values
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])


def test_rows_without_live_positions_match_pallas_kernel(case):
    """The rows whose attention averages V over the whole buffer in JAX
    (masked scores are finfo(float32).min, not -inf): a cursor at 0 whose
    event bit is 0 (no live position on any layer) and a cursor whose local
    window holds only padding; beside them a cursor at M (writes nothing,
    attends to m < M) and an ordinary row."""
    jcfg, params, tmodel, x = case
    start = np.array([0, 5, 8, 6, 3], np.int32)
    em = np.array([False, False, True, True, False])
    mask = x["mask"].copy()
    mask[:, :] = np.arange(M)[None, :] < start[:, None]
    mask[1, 5 - WINDOWS[0] + 1 :] = False  # the window [4, 5] holds only padding
    mask[2] = True
    y = dict(x, em=em, mask=mask)
    want = run_jax(jcfg, params, y, start)
    got = run_port(tmodel, y, start=start)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    at = np.broadcast_to(cursor_onehot(start), x["kc"].shape)
    for i in (1, 2):
        np.testing.assert_array_equal(got[i][~at], want[i][~at])
        np.testing.assert_allclose(got[i][at], want[i][at], **TOL)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])


def test_wrapper_takes_plain_version_on_cpu(case):
    _, _, tmodel, x = case
    a, b = run_port(tmodel, x, fn=decode_stack_step), run_port(tmodel, x)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_inactive_rows_keep_mask_and_length(case):
    _, _, tmodel, x = case
    active = np.array([True, False, True, False, True])
    cfg = tmodel.config
    weights = stack_layer_weights(tmodel.encoder.blocks(), torch.float32)
    args = [torch.from_numpy(x[k]) for k in ("h0", "em", "mask")]
    start, mask = torch.from_numpy(START), torch.from_numpy(x["mask"])
    kw = dict(windows=WINDOWS, activation=cfg.activation_function, layer_norm_eps=cfg.layer_norm_epsilon)

    def run(**extra):
        kc, vc = torch.from_numpy(x["kc"]).clone(), torch.from_numpy(x["vc"]).clone()
        return decode_stack_step(weights, kc, vc, args[0], start, args[1], args[2], **kw, **extra)

    full, gated = run(), run(active=torch.from_numpy(active))
    for u, v in zip(full[:3], gated[:3]):  # h and the caches do not depend on `active`
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    act = torch.from_numpy(active)
    torch.testing.assert_close(gated[5], torch.where(act[:, None], full[5], mask), rtol=0, atol=0)
    torch.testing.assert_close(gated[6], torch.where(act, full[6], start), rtol=0, atol=0)


def test_unsupported_activation_raises(case):
    _, _, tmodel, x = case
    with pytest.raises(ValueError, match="supports"):
        decode_stack_step_reference(
            stack_layer_weights(tmodel.encoder.blocks(), torch.float32), torch.zeros(2, 1, 1, 2, 1),
            torch.zeros(2, 1, 1, 2, 1), torch.zeros(1, 1), torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), torch.zeros(1, 2, dtype=torch.bool),
            windows=(0, 0), activation="silu", layer_norm_eps=1e-5,
        )  # fmt: skip


QUANT = {"int8": (jnp.int8, torch.int8), "fp8": (jkq.FP8_DTYPE, tkq.FP8_DTYPE)}


def quantized_inputs(x, name):
    """The case's caches as codes and scales (JAX's `quantize_kv`), in numpy."""
    jdt = QUANT[name][0]
    out = {}
    for c in ("kc", "vc"):
        q, s = jkq.quantize_kv(jnp.asarray(x[c]), jdt)
        out[c], out[c + "_scale"] = np.asarray(q), np.asarray(s)
    return out


def as_codes(a) -> np.ndarray:
    return a.view(np.uint8) if a.dtype == np.dtype(jkq.FP8_DTYPE) else a


def run_quant(jcfg, params, tmodel, x, name, start=START):
    """JAX's kernel in interpret mode and the port's plain version on the
    same codes and scales; the port's side also returns the float keys and
    values it quantized at the cursor (captured from `quantize_kv`)."""
    q = quantized_inputs(x, name)
    weights = jax_stack_layer_weights(params["params"]["encoder"], jcfg.num_hidden_layers)
    kw = dict(windows=WINDOWS, activation=jcfg.activation_function, layer_norm_eps=float(jcfg.layer_norm_epsilon))
    jout = jax_decode_stack_step(
        weights, *(jnp.asarray(q[k]) for k in ("kc", "vc", "kc_scale", "vc_scale")), jnp.asarray(x["h0"]),
        jnp.asarray(start), jnp.asarray(x["em"]), jnp.asarray(x["mask"]), impl="pallas_interpret", **kw,
    )  # fmt: skip
    want = [np.asarray(a) for a in jout]
    tdt = QUANT[name][1]
    seen = []

    def recording_quantize(v, dtype):
        seen.append(v.float().clone())
        return tkq.quantize_kv(v, dtype)

    planes = [torch.from_numpy(as_codes(q[k]).copy()).view(tdt) for k in ("kc", "vc")]
    scales = [torch.from_numpy(q[k].copy()) for k in ("kc_scale", "vc_scale")]
    orig = tds.quantize_kv
    tds.quantize_kv = recording_quantize
    try:
        out = decode_stack_step_reference(
            stack_layer_weights(tmodel.encoder.blocks(), torch.float32), *planes, torch.from_numpy(x["h0"]),
            torch.from_numpy(start), torch.from_numpy(x["em"]), torch.from_numpy(x["mask"]), **kw,
            key_scale=scales[0], value_scale=scales[1],
        )  # fmt: skip
    finally:
        tds.quantize_kv = orig
    assert out[1] is planes[0] and out[3] is scales[0]  # updated in place
    got = [out[0].numpy(), *(as_codes(tkq.storage(p).numpy()) for p in out[1:3])]
    got += [t.numpy() for t in out[3:]]
    want = [want[0], as_codes(want[1]), as_codes(want[2]), *want[3:]]
    # seen: per layer, k then v rows (B_written, H, D) at the written rows.
    return got, want, seen


def decoded(codes: np.ndarray, name: str) -> np.ndarray:
    if name == "fp8":
        return torch.from_numpy(codes.copy()).view(tkq.FP8_DTYPE).float().numpy()
    return codes.astype(np.float32)


@pytest.mark.parametrize("name", sorted(QUANT))
def test_quantized_plain_version_matches_pallas_kernel(case, name):
    """Kernel B's quantized variant (``key_scale`` / ``value_scale``): the
    plain version against the JAX kernel in interpret mode on the same int8
    or fp8 codes and scales. Off the cursor, codes and scales are exact; at
    the cursor the scales agree within 1e-5 relative (amax of keys computed
    by two BLAS orders) and the codes are equal, where a code may differ by
    one step only if the scaled value lies within 1e-4 of a rounding tie
    (the fp32 keys differ by ulps, which can tip a tie either way). ``h``
    within ``TOL``, mask and length exact."""
    jcfg, params, tmodel, x = case
    got, want, seen = run_quant(jcfg, params, tmodel, x, name)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    at = np.broadcast_to(cursor_onehot(), x["kc"].shape)  # (L, B, H, M, D)
    at_s = at[..., 0]
    rows = np.nonzero((START >= 0) & (START < M))[0]
    for i, (plane, scale) in enumerate(((1, 3), (2, 4))):
        np.testing.assert_array_equal(got[plane][~at], want[plane][~at])
        np.testing.assert_array_equal(got[scale][~at_s], want[scale][~at_s])
        np.testing.assert_allclose(got[scale][at_s], want[scale][at_s], rtol=1e-5, atol=0)
        for l in range(x["kc"].shape[0]):
            g = got[plane][l][rows, :, START[rows]]  # (rows, H, D)
            w = want[plane][l][rows, :, START[rows]]
            differ = g != w
            if differ.any():
                scaled = (seen[2 * l + i] / torch.from_numpy(got[scale][l][rows, :, START[rows]])[..., None]).numpy()
                a, b = decoded(g, name)[differ], decoded(w, name)[differ]
                one_step = np.abs(g.view(np.int8 if name == "int8" else np.uint8).astype(int)
                                  - w.view(np.int8 if name == "int8" else np.uint8).astype(int))[differ] == 1
                tie = np.abs(scaled[differ] - (a + b) / 2) <= 1e-4 * np.maximum(1.0, np.abs(scaled[differ]))
                assert (one_step & tie).all(), (l, i, a, b, scaled[differ])
    np.testing.assert_array_equal(got[5], want[5])
    np.testing.assert_array_equal(got[6], want[6])


@pytest.mark.parametrize("name", sorted(QUANT))
def test_quantized_rows_without_live_positions_match_pallas_kernel(case, name):
    """The uniform-softmax rows (no live position) on a quantized cache read
    every position dequantized, zero codes with scale 1 included."""
    jcfg, params, tmodel, x = case
    start = np.array([0, 5, 8, 6, 3], np.int32)
    em = np.array([False, False, True, True, False])
    mask = np.arange(M)[None, :] < start[:, None]
    mask[1, 5 - WINDOWS[0] + 1 :] = False
    mask[2] = True
    kc, vc = x["kc"].copy(), x["vc"].copy()
    kc[:, 0], vc[:, 0] = 0.0, 0.0  # an unwritten row: zero codes, scale 1
    y = dict(x, em=em, mask=mask, kc=kc, vc=vc)
    got, want, _ = run_quant(jcfg, params, tmodel, y, name, start)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for i in (5, 6):
        np.testing.assert_array_equal(got[i], want[i])


def test_quantized_scales_both_or_neither(case):
    _, _, tmodel, x = case
    cfg = tmodel.config
    kc = torch.zeros(x["kc"].shape, dtype=torch.int8)
    args = [torch.from_numpy(x[k]) for k in ("h0",)] + [torch.from_numpy(START)]
    args += [torch.from_numpy(x[k]) for k in ("em", "mask")]
    with pytest.raises(ValueError, match="both"):
        decode_stack_step(stack_layer_weights(tmodel.encoder.blocks(), torch.float32), kc, kc.clone(), *args,
                          windows=WINDOWS, activation=cfg.activation_function, layer_norm_eps=1e-5,
                          key_scale=torch.ones(kc.shape[:-1]))  # fmt: skip
