"""The PyTorch port's hand-written kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda``
marker and skip without a CUDA device. The file imports no JAX (the machine
with the card has none); run it there without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import copy
import ctypes
import functools

import numpy as np
import pytest
import torch

from eventstreamgpt_tpu_torch.convert import init_params_from_seed
from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.ops.decode_step import (
    decode_stack_step,
    decode_stack_step_reference,
    stack_layer_weights,
)
from eventstreamgpt_tpu_torch.ops.kv_quant import FP8_DTYPE, dequantize_kv, quantize_kv, storage
from eventstreamgpt_tpu_torch.ops.dep_graph import (
    dep_graph_attention,
    dep_graph_attention_reference,
    dep_graph_bwd,
    dep_graph_fwd,
)
from eventstreamgpt_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_reference,
    flash_attention_window_bwd,
    flash_attention_window_fwd,
    tile_schedule,
    tiles_walked,
)
from eventstreamgpt_tpu_torch.distributions import gumbel
from eventstreamgpt_tpu_torch.generation.sampling import RowStreams
from eventstreamgpt_tpu_torch.ops.fused_sampling import (
    fused_categorical,
    fused_categorical_reference,
    fused_categorical_stream,
    gumbel_noise,
)
from eventstreamgpt_tpu_torch.ops.vocab_gather import (
    vocab_gather,
    vocab_gather_bwd,
    vocab_gather_fwd,
    vocab_gather_reference,
)

pytestmark = pytest.mark.cuda

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the port's kernels run only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("V", [3, 40, 1000])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_categorical_matches_plain_version(cuda, dtype, V):
    rng = np.random.default_rng(V)
    z = torch.from_numpy(rng.integers(-2, 3, size=(33, V)).astype(np.float32)).to(DTYPES[dtype])
    g = torch.from_numpy(rng.gumbel(size=(33, V)).astype(np.float32)).to(DTYPES[dtype])
    g[::2] = 0  # exact ties on half the rows
    keep = torch.from_numpy(rng.random((33, V)) < 0.5)
    active = torch.arange(33) % 4 != 0
    for k, a in ((None, None), (keep, None), (keep, active)):
        want = fused_categorical_reference(z, g, k, a, fill=5)
        got = fused_categorical(
            z.to(cuda), g.to(cuda), None if k is None else k.to(cuda), None if a is None else a.to(cuda), fill=5
        )
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def special_logits(rows, V, seed, dtype, device):
    """Normal logits with a NaN row, a row with +inf, an all--inf row and a row of exact ties."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(rows, V)) * 3).astype(np.float32)
    for r, kind in zip(range(0, rows, 7), ("nan", "inf", "neg_inf", "ties")):
        if kind == "nan":
            z[r, rng.integers(V)] = np.nan
        elif kind == "inf":
            z[r, rng.integers(V)] = np.inf
        elif kind == "neg_inf":
            z[r] = -np.inf
        else:
            z[r] = 1.0
    return torch.from_numpy(z).to(dtype).to(device)


# V: one column, two, the serving head, a lane past four warps, the
# vocabulary; rows: one, the serving slots, one more, many.
@pytest.mark.parametrize("rows", [1, 32, 33, 2048])
@pytest.mark.parametrize("V", [1, 2, 40, 129, 4057])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_categorical_stream_matches_plain_version(cuda, dtype, V, rows):
    """Indices equal to ``fused_categorical_reference`` given ``gumbel(stream)``
    on the card, with and without keep and active, on NaN, +inf and
    all--inf rows, for several seeds and salts."""
    dt = DTYPES[dtype]
    z = special_logits(rows, V, seed=V + rows, dtype=dt, device=cuda)
    rng = np.random.default_rng(rows * V)
    keep = torch.from_numpy(rng.random((rows, V)) < 0.5).to(cuda)
    active = torch.from_numpy(rng.random(rows) < 0.8).to(cuda)
    for trial in range(3):
        seeds = torch.from_numpy(rng.integers(-(2**62), 2**62, size=rows, dtype=np.int64)).to(cuda)
        counters = torch.from_numpy(rng.integers(0, 2**40, size=rows, dtype=np.int64)).to(cuda)
        salt = int(rng.integers(0, 2**32))
        for k, a in ((None, None), (keep, None), (None, active), (keep, active)):
            plain = RowStreams(seeds, counters, salt)
            want = fused_categorical_reference(z, gumbel(plain, z.shape, cuda).to(dt), k, a, fill=-2)
            launches = fused_categorical_stream.launches
            got = fused_categorical_stream(z, RowStreams(seeds, counters, salt), k, a, fill=-2)
            torch.cuda.synchronize()
            assert fused_categorical_stream.launches == launches + 1
            assert torch.equal(got, want), (trial, k is not None, a is not None, (got != want).nonzero()[:5])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_categorical_stream_strided_rows_and_leading_shape(cuda, dtype):
    """Columns of a wider plane (the heads' slices, read in place) and a
    ``(B, X, V)`` plane whose stream rows each cover X rows."""
    dt = DTYPES[dtype]
    B, X, V = 5, 3, 40
    wide = special_logits(B * X, 4057, seed=3, dtype=dt, device=cuda).reshape(B, X, 4057)
    seeds = torch.arange(B, dtype=torch.int64, device=cuda) * 1_000_003
    counters = torch.arange(B, dtype=torch.int64, device=cuda) + 17
    for logits in (wide[:, 0, 100 : 100 + V], wide[..., 7 : 7 + V]):
        want = fused_categorical_reference(logits, gumbel(RowStreams(seeds, counters, 9), logits.shape, cuda).to(dt))
        got = fused_categorical_stream(logits, RowStreams(seeds, counters, 9))
        assert got.shape == logits.shape[:-1] and torch.equal(got, want)


# Shapes: the serving plane, the vocabulary at many rows (most of the 2**24
# uniforms the hash can give), and a (B, X, V) plane.
@pytest.mark.parametrize("shape", [(32, 40), (4096, 4057), (6, 3, 129)], ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gumbel_noise_is_bitwise_gumbel_of_the_stream(cuda, dtype, shape):
    """The kernel's noise (its own device function, written out) equals
    ``gumbel(stream, shape).to(dtype)`` computed by ATen on the card, bit for
    bit: the same hash, the same fp32 roundings and the same ``logf``."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(shape[-1])
    seeds = torch.from_numpy(rng.integers(-(2**62), 2**62, size=shape[0], dtype=np.int64)).to(cuda)
    counters = torch.from_numpy(rng.integers(0, 2**40, size=shape[0], dtype=np.int64)).to(cuda)
    salt = int(rng.integers(0, 2**32))
    got = gumbel_noise(RowStreams(seeds, counters, salt), shape, dt)
    want = gumbel(RowStreams(seeds, counters, salt), shape, cuda).to(dt)
    bits = torch.int32 if dt == torch.float32 else torch.int16
    differ = got.view(bits) != want.view(bits)
    assert not differ.any(), (int(differ.sum()), got[differ][:5].tolist(), want[differ][:5].tolist())


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-4), ("bf16", 2e-2)])
def test_decode_stack_step_matches_plain_version(cuda, dtype, tol, with_active):
    cfg = StructuredTransformerConfig(
        vocab_sizes_by_measurement={"event_type": 3},
        vocab_offsets_by_measurement={"event_type": 1},
        measurements_idxmap={"event_type": 1},
        measurements_per_generative_mode={"single_label_classification": ["event_type"]},
        hidden_size=48, head_dim=12, num_attention_heads=4, num_hidden_layers=3, intermediate_size=72,
        seq_attention_types=["local", "global", "local"], seq_window_size=3,
    )  # fmt: skip
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(cfg), seed=0, std=0.2)
    cdt = DTYPES[dtype]
    weights = {k: v.to(cuda) for k, v in stack_layer_weights(model.encoder.blocks(), cdt).items()}
    L, B, H, M, D = 3, 6, 4, 10, 12
    rng = np.random.default_rng(1)
    start = torch.tensor([0, 2, 5, 9, 10, 4], dtype=torch.int32)
    kc = torch.from_numpy(rng.normal(size=(L, B, H, M, D)).astype(np.float32)).to(cdt)
    vc = torch.from_numpy(rng.normal(size=(L, B, H, M, D)).astype(np.float32)).to(cdt)
    h0 = torch.from_numpy(rng.normal(size=(B, H * D)).astype(np.float32)).to(cdt)
    em = torch.tensor([True, True, False, True, True, True])
    mask = torch.from_numpy((np.arange(M)[None] < start.numpy()[:, None]) & (rng.random((B, M)) < 0.8))
    kw = dict(windows=(3, 0, 3), activation="gelu", layer_norm_eps=1e-5)
    if with_active:
        kw["active"] = torch.tensor([True, False, True, True, False, True], device=cuda)

    def run(fn):
        k2, v2 = kc.clone().to(cuda), vc.clone().to(cuda)
        return fn(weights, k2, v2, h0.to(cuda), start.to(cuda), em.to(cuda), mask.to(cuda), **kw)

    want = [t.float().cpu() for t in run(decode_stack_step_reference) if t is not None]
    got = [t.float().cpu() for t in run(decode_stack_step) if t is not None]
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
    at = torch.arange(M)[None, :] == start[:, None].long()  # (B, M) cursor positions
    at = at[None, :, None, :, None].expand(L, B, H, M, D)
    for i in (1, 2):
        torch.testing.assert_close(got[i][~at], want[i][~at], rtol=0, atol=0)
        torch.testing.assert_close(got[i][at], want[i][at], rtol=tol, atol=tol)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=0)


def decode_model(H, D, I, L, dtype, device):
    """Stacked weights of a small CI model with H heads of D and L layers (std 0.2, seed 0)."""
    cfg = StructuredTransformerConfig(
        vocab_sizes_by_measurement={"event_type": 3},
        vocab_offsets_by_measurement={"event_type": 1},
        measurements_idxmap={"event_type": 1},
        measurements_per_generative_mode={"single_label_classification": ["event_type"]},
        hidden_size=H * D, head_dim=D, num_attention_heads=H, num_hidden_layers=L, intermediate_size=I,
        seq_attention_types=["local", "global"] * (L // 2) + ["local"] * (L % 2), seq_window_size=4,
    )  # fmt: skip
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(cfg), seed=0, std=0.2)
    return {k: v.to(device) for k, v in stack_layer_weights(model.encoder.blocks(), dtype).items()}


# (H, D, I, B, M, windows): the serving geometry's heads (4 x 64, clusters of
# 4) at 40 slots, so the 160 CTAs take more than one wave; 6 heads (clusters
# of 6) with an intermediate that 6 does not divide; 4 heads of 12 (the
# scalar path: 24-byte bf16 rows); 3 heads of 32 (clusters of 3).
DECODE_CASES = [
    (4, 64, 256, 40, 64, (4, 0)),
    (6, 64, 200, 9, 48, (5, 0)),
    (4, 12, 72, 10, 20, (4, 0, 3)),
    (3, 32, 96, 7, 33, (2, 0)),
]


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "H{}-D{}-I{}-B{}-M{}".format(*c[:5]))
def test_decode_stack_step_clusters_and_live_ranges(cuda, case, dtype, tol):
    """Kernel B against its plain version on the card, with the rows whose
    attention reads the whole buffer: a cursor at 0 whose event bit is 0 (no
    live position), a windowed cursor whose window holds only padding, and a
    cursor at M (writes nothing, attends to m < M); inactive rows keep their
    mask and length; two runs are bitwise equal. In fp32, ``h`` is held to
    the function computed in fp64 (the plain version in float64 on the
    card): the kernel's largest error is at most twice the plain fp32
    version's plus 1e-5. At hidden 256 with std-0.2 weights and unscaled
    scores both sit ~3e-4 from it on outputs up to ~60 (summation order
    alone), past a fixed 1e-4 between the two."""
    H, D, I, B, M, windows = case
    L, cdt = len(windows), DTYPES[dtype]
    weights = decode_model(H, D, I, L, cdt, cuda)
    rng = np.random.default_rng(H * D + B)
    start = rng.integers(0, M, size=B).astype(np.int32)
    em = rng.random(B) < 0.8
    mask = (np.arange(M)[None] < start[:, None]) & (rng.random((B, M)) < 0.85)
    start[0], em[0] = 0, False  # no live position on any layer
    start[1], em[1] = 10, False  # the local window [10 - w + 1, 10] holds only padding
    mask[1, 10 - windows[0] + 1 :] = False
    start[2] = M  # past the buffer
    mask[2] = rng.random(M) < 0.85
    active = torch.from_numpy(rng.random(B) < 0.7).to(cuda)
    kc = torch.from_numpy(rng.normal(size=(L, B, H, M, D)).astype(np.float32)).to(cdt)
    vc = torch.from_numpy(rng.normal(size=(L, B, H, M, D)).astype(np.float32)).to(cdt)
    h0 = torch.from_numpy(rng.normal(size=(B, H * D)).astype(np.float32)).to(cdt).to(cuda)
    start_t, em_t, mask_t = (torch.from_numpy(a).to(cuda) for a in (start, em, mask))
    kw = dict(windows=windows, activation="gelu", layer_norm_eps=1e-5, active=active)

    def run(fn):
        k2, v2 = kc.clone().to(cuda), vc.clone().to(cuda)
        return fn(weights, k2, v2, h0, start_t, em_t, mask_t, **kw)

    want = [t.float().cpu() for t in run(decode_stack_step_reference) if t is not None]
    launches = decode_stack_step.launches
    got = [t for t in run(decode_stack_step) if t is not None]
    again = [t for t in run(decode_stack_step) if t is not None]
    torch.cuda.synchronize()
    assert decode_stack_step.launches == launches + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # no atomics: bitwise reproducible
    got = [t.float().cpu() for t in got]
    if dtype == "fp32":
        w64 = {k: v.double() for k, v in weights.items()}
        k64, v64 = kc.double().to(cuda), vc.double().to(cuda)
        exact = decode_stack_step_reference(w64, k64, v64, h0.double(), start_t, em_t, mask_t, **kw)[0].cpu()
        err, plain_err = ((x.double() - exact).abs().max().item() for x in (got[0], want[0]))
        assert err <= 2 * plain_err + 1e-5, (err, plain_err)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
    at = torch.arange(M)[None, :] == torch.from_numpy(start)[:, None].long()
    at = at[None, :, None, :, None].expand(L, B, H, M, D)
    for i in (1, 2):
        torch.testing.assert_close(got[i][~at], want[i][~at], rtol=0, atol=0)
        torch.testing.assert_close(got[i][at], want[i][at], rtol=tol, atol=tol)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=0)


QUANT = {"int8": torch.int8, "fp8": FP8_DTYPE}


def quant_step(value: torch.Tensor, scale: torch.Tensor, name: str) -> torch.Tensor:
    """One quantisation step at each dequantized value: the scale in int8;
    in e4m3 (3 mantissa bits) at most 2^-3 of the scaled value, 2^-9 among
    the subnormals, times the scale."""
    if name == "int8":
        return scale
    return scale * torch.clamp((value / scale).abs() * 2.0**-3, min=2.0**-9)


@pytest.mark.parametrize("name", sorted(QUANT))
@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("case", [DECODE_CASES[0], DECODE_CASES[2], DECODE_CASES[3]],
                         ids=lambda c: "H{}-D{}-I{}-B{}-M{}".format(*c[:5]))  # fmt: skip
def test_decode_stack_step_quantized_matches_plain_version(cuda, case, dtype, tol, name):
    """Kernel B's quantized variant (int8 or fp8 codes with fp32 scale
    tables) against its plain version on the card, with a row with no live
    position (its uniform softmax reads every position dequantized, the
    unwritten ones zero codes with scale 1), a windowed row whose window holds
    only padding and a cursor at M (writes nothing). Codes and scales other
    than the cursor's bit-equal; the cursor's dequantized keys and values
    within the tolerance (of each row's largest) plus one quantisation step
    (a one-ulp difference in k can move a code); mask and length exact; counted on its own counter,
    and two runs bitwise equal. ``h`` on the rows whose cursor codes all
    agree (at least half of them), as stated below."""
    H, D, I, B, M, windows = case
    L, cdt, qdt = len(windows), DTYPES[dtype], QUANT[name]
    weights = decode_model(H, D, I, L, cdt, cuda)
    rng = np.random.default_rng(H * D + B + 1)
    start = rng.integers(0, M, size=B).astype(np.int32)
    em = rng.random(B) < 0.8
    mask = (np.arange(M)[None] < start[:, None]) & (rng.random((B, M)) < 0.85)
    start[0], em[0] = 0, False
    start[1], em[1] = 10, False
    mask[1, 10 - windows[0] + 1 :] = False
    start[2] = M
    mask[2] = rng.random(M) < 0.85
    active = torch.from_numpy(rng.random(B) < 0.7).to(cuda)
    kf = torch.from_numpy(rng.normal(size=(L, B, H, M, D)).astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=(L, B, H, M, D)).astype(np.float32))
    kf[:, 0], vf[:, 0] = 0.0, 0.0  # row 0 never written: zero codes, scale 1
    (kq, ks), (vq, vs) = quantize_kv(kf, qdt), quantize_kv(vf, qdt)
    h0 = torch.from_numpy(rng.normal(size=(B, H * D)).astype(np.float32)).to(cdt).to(cuda)
    start_t, em_t, mask_t = (torch.from_numpy(a).to(cuda) for a in (start, em, mask))
    kw = dict(windows=windows, activation="gelu", layer_norm_eps=1e-5, active=active)

    def run(fn, w=weights, x=h0):
        k2, v2, ks2, vs2 = (t.clone().to(cuda) for t in (kq, vq, ks, vs))
        return fn(w, k2, v2, x, start_t, em_t, mask_t, key_scale=ks2, value_scale=vs2, **kw)

    want = run(decode_stack_step_reference)
    launches = (decode_stack_step.launches, decode_stack_step.launches_int8, decode_stack_step.launches_fp8)
    got, again = run(decode_stack_step), run(decode_stack_step)
    torch.cuda.synchronize()
    after = (decode_stack_step.launches, decode_stack_step.launches_int8, decode_stack_step.launches_fp8)
    assert after == (launches[0], launches[1] + 2 * (name == "int8"), launches[2] + 2 * (name == "fp8"))
    for a, b in zip(got, again):
        assert torch.equal(storage(a), storage(b))
    # A key one rounding apart can move a code (and with it the scores) by a
    # quantisation step: rows whose cursor codes differ anywhere are left to
    # the cursor check below. On the others, fp32 holds h to the function in
    # fp64 as the float test does (on the rows where its codes agree too);
    # bf16 within 2e-2 of the largest |h|: at this geometry h reaches 30-60,
    # where a bf16 ulp is 0.125-0.25, and the residual sums leave such ulps
    # on small elements (the float kernel and its plain version differ by up
    # to 0.69 on these inputs dequantized, measured on an H100).
    runs = [got, want]
    if dtype == "fp32":
        w64 = {k: v.double() for k, v in weights.items()}
        runs.append(run(decode_stack_step_reference, w64, h0.double()))
    same = torch.ones(B, dtype=torch.bool)
    for other in runs[1:]:
        for i in (1, 2):  # codes; their scales may differ by the ulps of amax
            a, b = (storage(t.cpu()) for t in (got[i], other[i]))
            same &= (a == b).reshape(L, B, -1).all(-1).all(0)
    assert same.sum() >= B // 2, f"cursor codes differ on {int((~same).sum())} of {B} rows"
    if dtype == "fp32":
        exact = runs[2][0].cpu()
        err, plain_err = ((x[0].cpu().double()[same] - exact[same]).abs().max().item() for x in (got, want))
        assert err <= 2 * plain_err + 1e-5, (err, plain_err)
    else:
        g, w = got[0].float().cpu()[same], want[0].float().cpu()[same]
        torch.testing.assert_close(g, w, rtol=0, atol=tol * w.abs().max().item())
    at = torch.arange(M)[None, :] == torch.from_numpy(start)[:, None].long()
    at_s = at[None, :, None, :].expand(L, B, H, M)
    at = at_s[..., None].expand(L, B, H, M, D)
    for plane, scale in ((1, 3), (2, 4)):
        g, w = got[plane].cpu(), want[plane].cpu()
        gb, wb = storage(g), storage(w)
        assert torch.equal(gb[~at], wb[~at]), "codes changed off the cursor"
        gs, ws = got[scale].cpu(), want[scale].cpu()
        assert torch.equal(gs[~at_s], ws[~at_s]), "scales changed off the cursor"
        # In later layers the input carries the earlier layers' roundings, a
        # share of its magnitude: the tolerance scales with each row's largest.
        gd, wd = (dequantize_kv(c, sc, torch.float32) for c, sc in ((g, gs), (w, ws)))
        top = wd.abs().amax(-1, keepdim=True).expand_as(wd)[at]
        gd, wd = gd[at], wd[at]
        step = quant_step(wd, ws[..., None].expand(L, B, H, M, D)[at], name)
        bad = (gd - wd).abs() > tol + tol * top + step
        assert not bad.any(), (int(bad.sum()), gd[bad][:5].tolist(), wd[bad][:5].tolist())
    assert torch.equal(got[5], want[5]) and torch.equal(got[6], want[6])


def test_decode_stack_step_refuses_a_cluster_that_cannot_be_placed(cuda):
    """A shape whose scores need more shared memory than a CTA can have (one
    head a CTA, M = 60,000 fp32 scores) is refused, not run another way."""
    H, D, M = 4, 8, 60_000
    weights = decode_model(H, D, 16, 1, torch.float32, cuda)
    kc = torch.zeros((1, 1, H, M, D), device=cuda)
    args = (torch.zeros((1, H * D), device=cuda), torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.ones(1, dtype=torch.bool, device=cuda), torch.zeros((1, M), dtype=torch.bool, device=cuda))  # fmt: skip
    launches = decode_stack_step.launches
    with pytest.raises(RuntimeError, match="no cluster of 4 CTAs"):
        decode_stack_step(weights, kc, kc.clone(), *args, windows=(0,), activation="gelu", layer_norm_eps=1e-5)
    assert decode_stack_step.launches == launches


def gather_inputs(rows, V, M, seed):
    """A plane, indices with duplicates and out-of-range entries, and a cotangent."""
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(rows, V)).astype(np.float32))
    ci = rng.integers(0, V, size=(rows, M))
    ci[:, : M // 3] = rng.integers(0, 2, size=(rows, M // 3))  # many duplicates of 0 and 1
    ci[::3, -1] = -1
    ci[1::5, -2] = V + 3
    g = torch.from_numpy(rng.normal(size=(rows, M)).astype(np.float32))
    return z, torch.from_numpy(ci.astype(np.int32)), g


# (rows, V, M): tiny; odd widths; a wide odd V (rows start unaligned); the
# training shape's width; M above the staged limit (indices read in place).
@pytest.mark.parametrize("shape", [(7, 5, 3), (33, 1000, 48), (4, 9001, 130), (300, 7000, 48), (3, 300, 5000)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vocab_gather_matches_plain_version(cuda, dtype, shape):
    rows, V, M = shape
    z, ci, g = gather_inputs(rows, V, M, seed=V)
    z = z.to(DTYPES[dtype])

    def run(fn, dev):
        zz = z.detach().to(dev).requires_grad_(True)
        out = fn(zz, ci.to(dev))
        out.backward(g.to(dev))
        return out.detach().cpu(), zz.grad.cpu()

    want, want_dz = run(vocab_gather_reference, "cpu")
    launches = vocab_gather_fwd.launches, vocab_gather_bwd.launches
    got, got_dz = run(vocab_gather, cuda)
    torch.cuda.synchronize()
    assert (vocab_gather_fwd.launches, vocab_gather_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # The plain version on the CPU sums duplicates in slot order in fp32, as the kernel does.
    torch.testing.assert_close(got_dz, want_dz, rtol=0, atol=0)
    again = run(vocab_gather, cuda)[1]
    assert torch.equal(again, got_dz)  # no atomics: bitwise reproducible


def test_decode_stack_step_trace_build(cuda):
    """The source built with its per-CTA trace (``-DESGPT_DECODE_TRACE``, read
    by ``tools/ab_kernels.py --trace``) computes what the plain build
    computes, and records for every CTA stamps that rise phase by phase."""
    from eventstreamgpt_tpu_torch.ops import build
    from eventstreamgpt_tpu_torch.ops import decode_step as ds
    from eventstreamgpt_tpu_torch.tools import ab_kernels

    lib = build.load_library(ds.SOURCE, (ab_kernels.TRACE_DEFINE,))
    H, D, I, B, M, windows = DECODE_CASES[0]
    weights = decode_model(H, D, I, len(windows), torch.bfloat16, cuda)
    rng = np.random.default_rng(5)
    kc = torch.from_numpy(rng.normal(size=(len(windows), B, H, M, D)).astype(np.float32)).bfloat16().to(cuda)
    h0 = torch.from_numpy(rng.normal(size=(B, H * D)).astype(np.float32)).bfloat16().to(cuda)
    start = torch.from_numpy(rng.integers(0, M, size=B).astype(np.int32)).to(cuda)
    em = torch.ones(B, dtype=torch.bool, device=cuda)
    mask = torch.arange(M, device=cuda)[None, :] < start[:, None]
    outs = [ds._launch(weights, kc.clone(), kc.clone(), h0, start, em, mask, windows, "gelu", 1e-5, None, fn)
            for fn in (ds.bind(lib), None)]  # fmt: skip
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert (a is None and b is None) or torch.equal(a, b)
    buf = np.zeros(ab_kernels.TRACE_SHAPE, np.uint64)
    assert lib.esgpt_decode_trace(ctypes.c_void_p(buf.ctypes.data)) == 0
    rec = buf[: B * ds.cluster_size(H), : 2 + len(windows) * len(ab_kernels.PHASES)].astype(np.int64)
    assert (np.diff(rec, axis=1) >= 0).all() and (rec[:, 0] > 0).all()


def edge_rows(rows, V, M, seed):
    """Indices whose rows are all one index, all out of range, all padding
    index 0, all in one 16-byte chunk, or at the row's two ends; the rest as
    `gather_inputs` makes them."""
    z, ci, g = gather_inputs(rows, V, M, seed)
    ci = ci.numpy().copy()
    rng = np.random.default_rng(seed + 1)
    kinds = [
        np.full(M, V // 2),
        rng.choice([-7, -1, V, V + 100], size=M),
        np.zeros(M, dtype=np.int64),
        min(8, V - 1) + rng.integers(0, min(8, V), size=M) % V,
        rng.choice([0, V - 1], size=M),
    ]
    for r in range(rows):
        if r % 3 == 0:
            ci[r] = kinds[(r // 3) % len(kinds)]
    return z, torch.from_numpy(ci.astype(np.int32)), g


# (rows, V, M): an odd V at many rows (rows start at every 2-byte offset in
# bf16), V below one 16-byte chunk, and the training width.
@pytest.mark.parametrize("shape", [(257, 1001, 48), (40, 3, 10), (33, 7, 9), (96, 7000, 48)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vocab_gather_bwd_edge_rows_match_cpu(cuda, dtype, shape):
    """Kernel C's backward on rows that start unaligned, rows narrower than a
    chunk, all-duplicate and all-out-of-range rows: bit-equal to the CPU's
    ordered fp32 sums, and between two runs."""
    rows, V, M = shape
    z, ci, g = edge_rows(rows, V, M, seed=V + M)
    zz = z.to(DTYPES[dtype]).requires_grad_(True)
    vocab_gather_reference(zz, ci).backward(g)
    launches = vocab_gather_bwd.launches
    got = vocab_gather_bwd(g.to(cuda), ci.to(cuda), V, DTYPES[dtype])
    again = vocab_gather_bwd(g.to(cuda), ci.to(cuda), V, DTYPES[dtype])
    torch.cuda.synchronize()
    assert vocab_gather_bwd.launches == launches + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), zz.grad, rtol=0, atol=0)


# (rows, V, M): one slot and three (one slot a thread), the training width
# and 48 at many rows (four slots a thread), 50 (M % 4 == 2), at odd rows.
@pytest.mark.parametrize("rows,V,M", [(7, 5, 1), (33, 1000, 3), (257, 7000, 48), (99, 7000, 50), (8191, 300, 48)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vocab_gather_fwd_matches_plain_version(cuda, dtype, rows, V, M):
    """Kernel C's forward bitwise equal to its plain version on the card, with
    negative, too-large and padding indices, on a contiguous index plane and
    on one 4 bytes off a 16-byte boundary (which takes one slot a thread)."""
    rng = np.random.default_rng(rows + V + M)
    ci = rng.integers(0, V, size=(rows, M))
    ci[rng.random((rows, M)) < 0.3] = 0
    ci[rng.random((rows, M)) < 0.1] = -7
    ci[rng.random((rows, M)) < 0.1] = V
    ci[::5, -1] = 2**31 - 1
    ci = torch.from_numpy(ci.astype(np.int32)).to(cuda)
    z = torch.from_numpy(rng.normal(size=(rows, V)).astype(np.float32)).to(DTYPES[dtype]).to(cuda)
    want = vocab_gather_reference(z, ci)
    launches = vocab_gather_fwd.launches
    got = vocab_gather_fwd(z, ci)
    shifted = torch.empty(ci.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(ci.shape)
    shifted.copy_(ci)
    assert shifted.data_ptr() % 16 != 0
    got_shifted = vocab_gather_fwd(z, shifted)
    torch.cuda.synchronize()
    assert vocab_gather_fwd.launches == launches + 2
    assert torch.equal(got, want) and torch.equal(got_shifted, want)


# (N, S, H, D, q_offset, window): the training shape's geometry at an odd N;
# q_offset 0 (every position a query); a local window; wider heads, more
# positions and one head at the kernel's largest D; the training shape itself
# (every warp of the persistent grid walks several row tiles); one row; 3
# heads of 8191 rows (a warp tile of 4 (row, head) units straddles rows, the
# last one ragged); D = 96 (12 of a 16-lane group hold bf16 data, 24 of 32
# fp32) and D = 160 (fp32: two chunks a lane, 20 lanes); a 5 x 6 graph on the
# 8 x 8 instance over many tiles.
DEP_GRAPH_CASES = [
    (301, 4, 4, 64, 1, None),
    (77, 4, 2, 64, 0, None),
    (129, 5, 3, 32, 1, 2),
    (33, 8, 2, 128, 0, 3),
    (9, 3, 1, 256, 1, None),
    (8192, 4, 4, 64, 1, None),
    (1, 4, 4, 64, 1, None),
    (8191, 4, 3, 64, 1, None),
    (257, 4, 4, 96, 1, None),
    (65, 3, 2, 160, 0, 2),
    (4099, 6, 4, 64, 1, None),
]


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "keep_mask"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", DEP_GRAPH_CASES, ids=lambda c: "N{}-S{}-H{}-D{}-q{}-w{}".format(*c))
def test_dep_graph_matches_plain_version(cuda, case, dtype, with_mask):
    """Kernel D, forward and backward, against its plain version (autograd
    for the backward) on the card: within 1e-5 of the largest magnitude in
    fp32; in bf16 within 1e-2 of it (the plain version's autograd rounds the
    probabilities' cotangent to bf16 through their cast, the kernel keeps it
    in fp32, as the TPU kernel does)."""
    N, S, H, D, q_offset, window = case
    Q = S - q_offset
    rng = np.random.default_rng(N)
    dt = DTYPES[dtype]
    full = torch.from_numpy(rng.normal(size=(N, S, H, D)).astype(np.float32)).to(dt).to(cuda)
    q = full[:, q_offset:]  # the strided view the model passes
    k, v = (torch.from_numpy(rng.normal(size=(N, S, H, D)).astype(np.float32)).to(dt).to(cuda) for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(N, Q, H, D)).astype(np.float32)).to(dt).to(cuda)
    rate = 0.25 if with_mask else 0.0
    mask = torch.from_numpy(rng.random((N, Q, S, H)) < 1.0 - rate).to(cuda) if with_mask else None

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = dep_graph_attention_reference(*leaves, q_offset, window, mask, rate)
    want_grads = torch.autograd.grad(want, leaves, g)
    launches = dep_graph_fwd.launches, dep_graph_bwd.launches
    got_leaves = [full.detach().clone().requires_grad_(True), k.clone().requires_grad_(True), v.clone().requires_grad_(True)]
    got = dep_graph_attention(got_leaves[0][:, q_offset:], got_leaves[1], got_leaves[2], q_offset, window, mask, rate)
    got.backward(g)
    torch.cuda.synchronize()
    assert (dep_graph_fwd.launches, dep_graph_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    got_grads = [got_leaves[0].grad[:, q_offset:], got_leaves[1].grad, got_leaves[2].grad]
    if q_offset:
        assert not got_leaves[0].grad[:, :q_offset].any()  # the history position is no query
    rel = 1e-5 if dtype == "fp32" else 1e-2
    for name, a, b in zip(("out", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
        assert a.dtype == dt
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * b.float().abs().max().item(), (name, err, b.float().abs().max().item())
    again = dep_graph_bwd(q, k, v, g, q_offset, window, mask, 1.0 - rate)
    for a, b in zip(again, got_grads):
        assert torch.equal(a, b)  # no atomics: bitwise reproducible


def test_dep_graph_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((4, 3, 2, 48), device=cuda)
    kv = torch.zeros((4, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        dep_graph_fwd(q, kv, kv, q_offset=1)
    q, kv = torch.zeros((4, 9, 2, 32), device=cuda), torch.zeros((4, 10, 2, 32), device=cuda)
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        dep_graph_fwd(q, kv, kv, q_offset=1)
    q, kv = torch.zeros((4, 3, 2, 32), device=cuda), torch.zeros((4, 4, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        dep_graph_fwd(q, kv.bfloat16(), kv, q_offset=1)


def test_dep_graph_refuses_misaligned_views(cuda):
    """The kernels move 16-byte vectors: a query, key or value off a 16-byte
    boundary, or a query stride that is no multiple of 16 bytes, raises (no
    fallback to the plain version)."""
    kv = torch.zeros((4, 4, 2, 32), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(4 * 3 * 2 * 32 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(4, 3, 2, 32)
    with pytest.raises(ValueError, match="the query starts 2 bytes past a 16-byte boundary"):
        dep_graph_fwd(q, kv, kv, q_offset=1)
    with pytest.raises(ValueError, match="the query starts 2 bytes past a 16-byte boundary"):
        dep_graph_bwd(q, kv, kv, torch.zeros((4, 3, 2, 32), dtype=torch.bfloat16, device=cuda), q_offset=1)
    rows = torch.zeros(4 * 208, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="query stride of 136 bytes is not a multiple of 16"):
        dep_graph_fwd(rows.as_strided((4, 3, 2, 32), (208, 68, 32, 1)), kv, kv, q_offset=1)
    key = torch.zeros(kv.numel() + 4, device=cuda)[4:].view(4, 4, 2, 32)  # fp32, 16 bytes in: aligned
    assert dep_graph_fwd(q.float().clone(), key, kv.float(), q_offset=1).shape == (4, 3, 2, 32)
    with pytest.raises(ValueError, match="the key starts 4 bytes past"):
        dep_graph_fwd(q.float().clone(), torch.zeros(kv.numel() + 1, device=cuda)[1:].view(4, 4, 2, 32), kv.float(),
                      q_offset=1)  # fmt: skip
    # The output's cotangent comes from autograd, not the caller: a misaligned one is copied, not refused.
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda) for s in ((4, 3, 2, 32), kv.shape, kv.shape))
    g = torch.from_numpy(rng.normal(size=(4, 3, 2, 32)).astype(np.float32)).to(cuda)
    g_off = torch.zeros(g.numel() + 1, device=cuda)[1:].view(g.shape).copy_(g)
    for a, b in zip(dep_graph_bwd(q, k, v, g_off, q_offset=1), dep_graph_bwd(q, k, v, g, q_offset=1)):
        assert torch.equal(a, b)


def packed_segment_ids(rng, B, S, layout="packed"):
    """Segment ids of B rows, by layout (the kernels skip 64 x 64 tiles by them):

    * packed: 2-4 segments a row, then 1-40 padding events as segment -1;
    * aligned: segments of 64 or 128 events starting on tile boundaries, a
      tile of padding at the end;
    * crossing: segments of 40-90 events, crossing tile boundaries;
    * unordered: the packed layout with its real ids permuted (not monotone);
    * padmid: the packed layout with a run of padding inside the row;
    * single: one segment a row, no padding (no tile is skipped).
    """
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        if layout in ("packed", "unordered", "padmid"):
            pad = int(rng.integers(1, 41))
            cuts = np.sort(rng.choice(np.arange(8, S - pad - 8), size=int(rng.integers(1, 4)), replace=False))
            for i, c in enumerate(cuts):
                seg[b, c:] = i + 1
            seg[b, S - pad :] = -1
            if layout == "unordered":
                ids = rng.permutation(len(cuts) + 1) * 3 + 1
                seg[b] = np.where(seg[b] >= 0, ids[np.maximum(seg[b], 0)], -1)
            if layout == "padmid":
                start = int(rng.integers(20, S // 2))
                seg[b, start : start + int(rng.integers(5, 70))] = -1
        elif layout == "aligned":
            ends = np.cumsum(rng.choice([64, 128], size=S // 64))
            seg[b] = np.searchsorted(ends, np.arange(S), side="right")
            seg[b, S - 64 :] = -1
        elif layout == "crossing":
            ends = np.cumsum(rng.integers(40, 91, size=S // 40 + 1))
            seg[b] = np.searchsorted(ends, np.arange(S), side="right")
        elif layout != "single":
            raise ValueError(layout)
    return torch.from_numpy(seg)


# (B, H, S, D, window[, layout]): global (kernel E) and windowed (kernel F), a
# window narrower than a tile, one that does not divide S, and one wider than
# S, on the packed layout; then each segment layout that tile skipping meets.
FLASH_CASES = [
    (2, 3, 256, 64, None),
    (3, 2, 192, 32, None),
    (2, 2, 256, 64, 160),
    (1, 4, 320, 32, 40),
    (2, 1, 128, 64, 1000),
    (2, 2, 512, 64, None, "aligned"),
    (2, 2, 512, 32, 160, "aligned"),
    (2, 2, 512, 64, None, "crossing"),
    (2, 2, 384, 64, None, "unordered"),
    (2, 2, 384, 32, 100, "unordered"),
    (2, 2, 384, 64, None, "padmid"),
    (2, 2, 256, 64, None, "single"),
    (1, 2, 256, 32, 200, "single"),
    # head_dim 128 (bench.py's production width: 8 heads of 128 at hidden 1,024)
    (2, 2, 256, 128, None),
    (1, 3, 320, 128, 160),
    (2, 2, 384, 128, None, "unordered"),
    (1, 2, 256, 128, 40, "padmid"),
]


def flash_case_id(c):
    return "B{}-H{}-S{}-D{}-w{}".format(*c[:5]) + "".join(f"-{x}" for x in c[5:])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=flash_case_id)
def test_flash_attention_matches_plain_version(cuda, case, dtype):
    """Kernels E and F, forward and backward, against their plain version
    (autograd for the backward) on the card, on heads-first views of
    (B, S, H, D) tensors as the model passes them: within 1e-5 of the largest
    magnitude in fp32; in bf16 within 2e-2 of it (the kernel rounds the
    unnormalised probabilities before P V and keeps dP in fp32, as the TPU
    kernels do; the plain version rounds the normalised probabilities and,
    through its bf16 product, dP). The kernels walk the tiles `tile_schedule`
    visits, counted on the card."""
    B, H, S, D, window = case[:5]
    rng = np.random.default_rng(S + D)
    dt = DTYPES[dtype]

    def heads_first():
        return torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32)).to(dt).to(cuda).transpose(1, 2)

    q, k, v, g = heads_first(), heads_first(), heads_first(), heads_first()
    seg = packed_segment_ids(rng, B, S, *case[5:]).to(cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = flash_attention_reference(*leaves, seg, window)
    want_grads = torch.autograd.grad(want, leaves, g)
    if window is None:
        fwd, bwd = flash_attention_fwd, flash_attention_bwd
    else:
        fwd, bwd = flash_attention_window_fwd, flash_attention_window_bwd
    launches = fwd.launches, bwd.launches
    got_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    tiles_walked()
    got = flash_attention(*got_leaves, seg, window)
    got.backward(g)
    walked = tiles_walked()
    assert (fwd.launches, bwd.launches) == (launches[0] + 1, launches[1] + 1)
    # Each kernel (forward, dq, dk/dv) walks exactly the tiles `tile_schedule` visits, H times.
    want_tiles = int(tile_schedule(seg, window).sum()) * H
    assert walked == {"fwd": want_tiles, "dq": want_tiles, "dkv": want_tiles}
    rel = 1e-5 if dtype == "fp32" else 2e-2
    for name, a, b in zip(("out", "dq", "dk", "dv"), (got, *(t.grad for t in got_leaves)), (want, *want_grads)):
        assert a.dtype == dt
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * b.float().abs().max().item(), (name, err, b.float().abs().max().item())
    extra = () if window is None else (window,)
    out, stats = fwd(q, k, v, seg, *extra)
    assert torch.equal(out, got.detach())
    again = bwd(q, k, v, seg, out, stats, g, *extra)
    for a, t in zip(again, got_leaves):
        assert torch.equal(a, t.grad)  # no atomics: bitwise reproducible


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    seg = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention_fwd(*(torch.zeros((1, 2, 128, 48), device=cuda),) * 3, seg)
    with pytest.raises(ValueError, match="multiple of the kernel's tile"):
        x = torch.zeros((1, 2, 96, 32), device=cuda)
        flash_attention_fwd(x, x, x, seg[:, :96])
    x = torch.zeros((1, 2, 128, 32), device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_fwd(x, x.bfloat16(), x, seg)
    with pytest.raises(ValueError, match="window"):
        flash_attention_window_fwd(x, x, x, seg, 0)
    # bf16 needs 16-byte aligned rows: a base pointer 2 bytes off, and an s stride of 36 elements.
    xb = x.bfloat16()
    off = torch.zeros(1 * 2 * 128 * 32 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(1, 2, 128, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(off, xb, xb, seg)
    wide = torch.zeros((1, 2, 128, 36), dtype=torch.bfloat16, device=cuda)[..., :32]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(wide, wide, wide, seg)


def test_flash_attention_fp32_takes_unaligned_rows(cuda):
    """The fp32 kernels read one element at a time: views 4 bytes off and
    with an s stride of 36 elements are taken, and match the plain version."""
    B, H, S, D = 2, 2, 128, 32
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.normal(size=3 * B * S * H * 36 + 1).astype(np.float32)).to(cuda)
    q, k, v = (flat[1 + i * B * S * H * 36 :][: B * S * H * 36].view(B, S, H, 36)[..., :D].transpose(1, 2)
               for i in range(3))  # fmt: skip
    assert q.data_ptr() % 16 == 4 and q.stride(2) == H * 36
    g = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).to(cuda)
    seg = packed_segment_ids(rng, B, S).to(cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = flash_attention_reference(*leaves, seg)
    want_grads = torch.autograd.grad(want, leaves, g)
    out, stats = flash_attention_fwd(q, k, v, seg)
    got = (out, *flash_attention_bwd(q, k, v, seg, out, stats, g))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, (want, *want_grads)):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), (name, err)


def test_flash_attention_trace_build(cuda):
    """The source built with its per-block trace (``-DESGPT_FLASH_TRACE``,
    read by ``tools/ab_flash.py --trace``) computes what the plain build
    computes, and records for every block of each bf16 kernel a start, walk
    and end in order and the tiles it walked, adding up to `tile_schedule`'s."""
    from eventstreamgpt_tpu_torch.ops import build
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.tools import ab_flash

    lib = fa.bind(build.load_library(fa.SOURCE, (ab_flash.TRACE_DEFINE,)))
    B, H, S, D = 2, 2, 512, 64
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).bfloat16().to(cuda)
                  for _ in range(4))  # fmt: skip
    seg = packed_segment_ids(rng, B, S, "crossing").to(cuda)
    out, stats = fa._fwd(q, k, v, seg, None, "trace", lib)
    grads = fa._bwd(q, k, v, seg, out, stats, g, None, "trace", lib)
    torch.cuda.synchronize()
    want_out, want_stats = flash_attention_fwd(q, k, v, seg)
    assert torch.equal(out, want_out) and torch.equal(stats, want_stats)
    for a, b in zip(grads, flash_attention_bwd(q, k, v, seg, out, stats, g)):
        assert torch.equal(a, b)
    records = ab_flash.read_trace(lib, B * H * S // 64)
    want = int(tile_schedule(seg).sum()) * H
    for kernel, rec in records.items():
        assert (rec[:, 0] <= rec[:, 1]).all() and (rec[:, 1] <= rec[:, 2]).all(), kernel
        assert int(rec[:, 4].sum()) == want, kernel


# ------------------------------------------------ captured programs (CUDA graphs)
GRAPH_WIDTHS = dict(sizes=(5, 8, 6, 3), hidden_size=128, num_attention_heads=4, head_dim=32, intermediate_size=256,
                    seq_window_size=4)  # fmt: skip


def same_results(a, b) -> None:
    """Every integer, mask and float of two runs' results equal (NaN where NaN)."""
    assert [r.request_id for r in a] == [r.request_id for r in b]
    for x, y in zip(a, b):
        assert (x.error, y.error) == (None, None)
        assert (x.n_events, x.n_generated) == (y.n_events, y.n_generated), x.request_id
        for k, t in vars(x.batch).items():
            if torch.is_tensor(t):
                u = getattr(y.batch, k)
                assert torch.equal(t.nan_to_num(-7.0), u.nan_to_num(-7.0)) if t.is_floating_point() else torch.equal(t, u)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_captured_engine_equals_eager_engine(cuda, greedy, kv_cache_dtype):
    """Every program captured once and replayed (the decode chunk, each
    prefill (bucket, group width) and each extraction width) gives what the
    same programs run eagerly give, bit for bit, on groups the scheduler pads
    (group sizes 2 and 4 at 4 slots); after ``reset()`` a second pass
    captures nothing and gives the first pass's results. Kernel B's launches
    count through the replays (warm-up included) and kernel A's through the
    prefill replays: in the second pass, which runs no warm-up, the captured
    engine launches each as often as the eager one."""
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config = serving_config(mean_log=1.0, std_log=0.1, **GRAPH_WIDTHS)
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=0)
    prompts = synthetic_prompts(np.random.default_rng(0), 6, config, (6, 12), (4, 8))
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, greedy=greedy,
              kv_cache_dtype=kv_cache_dtype, device=cuda)  # fmt: skip
    counter = "launches" if kv_cache_dtype is None else "launches_int8"

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    def zero():
        setattr(decode_stack_step, counter, 0)
        fused_categorical_stream.launches = 0

    runs, widths = {}, []
    for graph in (True, False):
        zero()
        eng = GenerationEngine(model, config, template=prompts[0][0], cuda_graph=graph, **kw)
        eng.scheduler.group_sizes = (2, 4)
        dispatch = eng._dispatch_group
        eng._dispatch_group = lambda g: (widths.append((len(g.requests), g.group_size)), dispatch(g))
        first = eng.run(requests())
        s = eng.stats()
        chunks = s["graph_warmup_chunks"] + s["dispatched_chunks"]
        assert getattr(decode_stack_step, counter) == chunks * kw["decode_chunk"]
        eng.reset()
        zero()
        second = eng.run(requests())
        s2 = eng.stats()
        assert getattr(decode_stack_step, counter) == s2["dispatched_chunks"] * kw["decode_chunk"]
        same_results(first, second)
        if graph:
            assert (s["cuda_graph"], s["graph_captures"], s["graph_warmup_chunks"]) == (True, 1, 1)
            assert s["graph_replays"] == s["dispatched_chunks"] > 0
            assert s["prefill_graph_captures"] == s["prefill_graph_warmups"] == s["prefill_graph_keys"] > 0
            assert s["prefill_graph_replays"] == s["prefill_dispatches"]
            assert s["extract_graph_captures"] == s["extract_graph_keys"] > 0
            for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
                assert s2[k] == s[k], k  # reset() kept every program
            assert s2["prefill_graph_replays"] == s["prefill_graph_replays"] + s2["prefill_dispatches"]
            assert s2["graph_replays"] == s["graph_replays"] + s2["dispatched_chunks"]
        else:
            assert (s2["cuda_graph"], s2["graph_captures"], s2["prefill_graph_captures"],
                    s2["extract_graph_captures"]) == (False, 0, 0, 0)  # fmt: skip
        runs[graph] = first, fused_categorical_stream.launches
    assert any(g > n for n, g in widths), widths
    same_results(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert (runs[True][1] == 0) == greedy


def graph_engine_setup():
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts

    config = serving_config(mean_log=1.0, std_log=0.1, **GRAPH_WIDTHS)
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=0)
    prompts = synthetic_prompts(np.random.default_rng(0), 6, config, (6, 12), (4, 8))
    return config, model, prompts


def zero_block_intact(eng) -> bool:
    planes = (eng.key_cache[:, 0], eng.value_cache[:, 0])
    scales = [x[:, 0] for x in (eng.key_scale, eng.value_scale) if x is not None]
    return not any(bool(p.view(torch.uint8).any()) for p in planes) and all(bool((x == 1).all()) for x in scales)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_captured_paged_engine_equals_eager_and_monolithic(cuda, greedy, kv_cache_dtype):
    """The paged engine (blocks of 4) on the card: captured equals eager and
    the monolithic engine's unfused step (captured) bit for bit, on groups
    the scheduler pads; kernel B never launches, kernel A launches as often
    captured as eager (sampled only, counted through the replays), block 0
    stays zero, and after ``reset()`` a second pass captures nothing and
    gives the first pass's results."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config, model, prompts = graph_engine_setup()
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, greedy=greedy,
              kv_cache_dtype=kv_cache_dtype, device=cuda)  # fmt: skip

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    runs = {}
    for label, extra in (("paged", dict(paged_kv=True, block_size=4)),
                         ("eager", dict(paged_kv=True, block_size=4, cuda_graph=False)),
                         ("mono", dict(decode_step_impl="xla"))):  # fmt: skip
        for c in ("launches", "launches_int8", "launches_fp8"):
            setattr(decode_stack_step, c, 0)
        fused_categorical_stream.launches = 0
        eng = GenerationEngine(model, config, template=prompts[0][0], **kw, **extra)
        eng.scheduler.group_sizes = (2, 4)
        first = eng.run(requests())
        s = eng.stats()
        assert s["decode_step_impl"] == "unfused"
        assert decode_stack_step.launches + decode_stack_step.launches_int8 + decode_stack_step.launches_fp8 == 0
        if label != "mono":
            assert zero_block_intact(eng)
        eng.reset()
        fused_categorical_stream.launches = 0
        second = eng.run(requests())
        s2 = eng.stats()
        same_results(first, second)
        runs[label] = first, fused_categorical_stream.launches
        if label != "eager":
            assert (s["graph_captures"], s["graph_warmup_chunks"]) == (1, 1)
            assert s["prefill_graph_captures"] == s["prefill_graph_keys"] > 0
            for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
                assert s2[k] == s[k], k
            assert s2["graph_replays"] == s["graph_replays"] + s2["dispatched_chunks"]
    same_results(runs["paged"][0], runs["eager"][0])
    same_results(runs["paged"][0], runs["mono"][0])
    assert runs["paged"][1] == runs["eager"][1] == runs["mono"][1]
    assert (runs["paged"][1] == 0) == greedy


def test_captured_fork_runs_each_program_once_a_group(cuda):
    """Two fork groups (4 and 2 branches) among ordinary requests on the
    card: each group one replay of the prefill program (one replay a
    dispatch, each key captured once); every branch equal bit for bit to an
    independent request with ``derive_request_seed(session, j)`` on an
    engine whose groups are as wide as the fork's, and block 0 zero."""
    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config, model, prompts = graph_engine_setup()
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, paged_kv=True, block_size=4,
              device=cuda)  # fmt: skip
    eng = GenerationEngine(model, config, template=prompts[0][0], **kw)
    (p0, b0), (p1, b1) = prompts[:2]
    eng.fork(p0, 4, b0, key=7, request_id="a")
    for i, (p, b) in enumerate(prompts[2:4]):
        eng.submit(Request(prompt=p, max_new_events=b, request_id=i))
    eng.fork(p1, 2, b1, key=8, request_id="b")
    got = {r.request_id: r for r in eng.run()}
    s = eng.stats()
    assert s["fork_groups_admitted"] == 2 and s["prefill_graph_replays"] == s["prefill_dispatches"] >= 3
    assert s["prefill_graph_captures"] == s["prefill_graph_keys"]
    assert not any(k.startswith("fork_") and "_graph_" in k for k in s)
    assert zero_block_intact(eng)
    for rid, prompt, budget, n, session, width in (("a", p0, b0, 4, 7, (4,)), ("b", p1, b1, 2, 8, (2,))):
        ref = GenerationEngine(model, config, template=prompts[0][0], **kw)
        ref.scheduler.group_sizes = width
        want = ref.run([Request(prompt=prompt, max_new_events=budget, request_id=(rid, j),
                                key=derive_request_seed(session, j)) for j in range(n)])  # fmt: skip
        same_results([got[(rid, j)] for j in range(n)], want)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_captured_spec_engine_equals_eager_engine(cuda, greedy, kv_cache_dtype):
    """Speculative decoding on the card (a one-layer truncated draft, ``k``
    3, default tolerances): the spec chunk captured once (its warm-up's
    rounds not counted) and replayed once a dispatched chunk, each prefill
    key captured once; results, per-request proposals and acceptances and
    the rounds equal the eager engine's bit for bit, and again after
    ``reset()``; kernel B never launches; kernel A (sampled only) launches as
    often captured as eager, counted through the replays."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft

    config, model, prompts = graph_engine_setup()
    dcfg, draft = truncated_draft(config, model, 1)
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, greedy=greedy,
              kv_cache_dtype=kv_cache_dtype, device=cuda, spec=SpecConfig(model=draft, config=dcfg, k=3))  # fmt: skip

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    runs = {}
    for graph in (True, False):
        for c in ("launches", "launches_int8", "launches_fp8"):
            setattr(decode_stack_step, c, 0)
        fused_categorical_stream.launches = 0
        eng = GenerationEngine(model, config, template=prompts[0][0], cuda_graph=graph, **kw)
        eng.scheduler.group_sizes = (2, 4)
        first = eng.run(requests())
        s = eng.stats()
        eng.reset()
        fused_categorical_stream.launches = 0
        second = eng.run(requests())
        s2 = eng.stats()
        same_results(first, second)
        assert [(r.spec_proposed, r.spec_accepted) for r in first] == [(r.spec_proposed, r.spec_accepted)
                                                                      for r in second]  # fmt: skip
        assert decode_stack_step.launches + decode_stack_step.launches_int8 + decode_stack_step.launches_fp8 == 0
        assert s["decode_step_impl"] == "spec_draft_verify" and s["spec_rounds"] == s["dispatched_chunks"] * 3 > 0
        if graph:
            assert (s["graph_captures"], s["graph_warmup_chunks"]) == (1, 1)
            assert s["graph_replays"] == s["dispatched_chunks"]
            assert s["prefill_graph_captures"] == s["prefill_graph_keys"] > 0
            assert s["prefill_graph_replays"] == s["prefill_dispatches"]
            for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
                assert s2[k] == s[k], k
            assert s2["graph_replays"] == s["graph_replays"] + s2["dispatched_chunks"]
        runs[graph] = first, fused_categorical_stream.launches, s
    same_results(runs[True][0], runs[False][0])
    assert [(r.spec_proposed, r.spec_accepted) for r in runs[True][0]] == [
        (r.spec_proposed, r.spec_accepted) for r in runs[False][0]]
    assert runs[True][2]["spec_rounds"] == runs[False][2]["spec_rounds"]
    assert runs[True][1] == runs[False][1] and (runs[True][1] == 0) == greedy


@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_captured_train_step_equals_eager_step(cuda, na):
    """Three bf16 steps with dropout 0.1: the step captured on its second call
    and replayed gives the eager step's losses, health vectors and weights
    bit for bit (the dropout generator reseeded before each replay, the rate
    tensor written before each), and kernels C and D count their replays."""
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        serving_config,
        synthetic_training_batches,
        training_config,
    )
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step

    batch = next(synthetic_training_batches(np.random.default_rng(0), serving_config(**GRAPH_WIDTHS), 4, 32))
    config = (na_training_config if na else training_config)([batch], **GRAPH_WIDTHS)
    assert config.attention_dropout == config.resid_dropout == 0.1
    base = init_params_from_seed(build_model(config), seed=0)
    oc = dict(init_lr=1e-3, lr_num_warmup_steps=0, lr_frac_warmup_steps=None, max_training_steps=10)
    out = {}
    for graph in (True, False):
        model = copy.deepcopy(base)
        step = make_train_step(model, *build_optimizer(model, OptimizationConfig(**oc)), device=cuda,
                               with_health=True, cuda_graph=graph)  # fmt: skip
        vocab_gather_fwd.launches = dep_graph_fwd.launches = 0
        healths = [step(batch, 7)[1] for _ in range(3)]
        assert vocab_gather_fwd.launches == 3
        assert dep_graph_fwd.launches == (3 * config.num_hidden_layers if na else 0)
        s = step.stats()
        want = (1, 1, 2) if graph else (0, 0, 0)
        assert (s["graph_warmup_steps"], s["graph_captures"], s["graph_replays"]) == want
        out[graph] = torch.stack(healths).cpu(), [p.detach().cpu() for p in model.parameters()]
    assert torch.equal(out[True][0], out[False][0]), (out[True][0], out[False][0])
    assert len(set(out[True][0][:, 0].tolist())) == 3
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


REMAT_WIDTHS = dict(sizes=(5, 8, 6, 3), hidden_size=256, num_attention_heads=2, head_dim=128, intermediate_size=512,
                    seq_window_size=32)


def remat_steps(cuda, policy, graph, na=False):
    """Three bf16 steps (dropout 0.1) of the packed model at head_dim 128
    (global layer on kernel E, local on the band) or of the NA model under
    ``policy``: ``(health vectors, weights, AdamW tensors, launches)``."""
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        packed_batch,
        packed_training_config,
        serving_config,
        synthetic_training_batches,
    )
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step

    if na:
        widths = dict(GRAPH_WIDTHS)
        batch = next(synthetic_training_batches(np.random.default_rng(0), serving_config(**widths), 4, 32))
        config = na_training_config([batch], gradient_checkpointing=policy, **widths)
    else:
        batch = packed_batch(serving_config(**REMAT_WIDTHS), 40, 2, 256, seed=0, mean_seq_len=16)
        config = packed_training_config([batch], gradient_checkpointing=policy, **REMAT_WIDTHS)
    model = init_params_from_seed(build_model(config), seed=0)
    optimizer, scheduler = build_optimizer(model, OptimizationConfig(init_lr=1e-3, lr_num_warmup_steps=0,
                                                                     lr_frac_warmup_steps=None, max_training_steps=10))
    step = make_train_step(model, optimizer, scheduler, device=cuda, with_health=True, cuda_graph=graph)
    counters = (flash_attention_fwd, flash_attention_bwd, dep_graph_fwd, dep_graph_bwd)
    for fn in counters:
        fn.launches = 0
    healths = torch.stack([step(batch, 7)[1] for _ in range(3)]).cpu()
    launches = {fn.__name__: fn.launches for fn in counters}
    adam = [t.detach().cpu() for st in optimizer.state.values() for t in (st["exp_avg"], st["exp_avg_sq"])]
    return healths, [p.detach().cpu() for p in model.parameters()], adam, launches


@pytest.mark.parametrize("policy", ["none", "block", "dots", "dots_no_batch", "save_attention"])
def test_captured_remat_step_equals_eager_and_the_plain_step(cuda, policy):
    """Under capture each remat policy's step equals its eager run and the
    ``"none"`` step, bit for bit (losses, health, weights, AdamW tensors),
    with dropout 0.1; kernel E's forward launches once a global layer a
    step under ``none`` and ``save_attention`` and twice under the
    recomputing policies, its backward once, counted through the replays."""
    plain = remat_steps(cuda, "none", True)
    for graph in (True, False):
        got = remat_steps(cuda, policy, graph)
        assert torch.equal(got[0], plain[0]), (policy, graph, got[0], plain[0])
        for a, b in zip(got[1] + got[2], plain[1] + plain[2]):
            assert torch.equal(a, b)
        fwd = 3 if policy in ("none", "save_attention") else 6
        assert got[3] == {"flash_attention_fwd": fwd, "flash_attention_bwd": 3, "dep_graph_fwd": 0,
                          "dep_graph_bwd": 0}, got[3]  # fmt: skip


def test_captured_na_block_remat_step_equals_the_plain_step(cuda):
    """The NA model under ``block``, captured, equals its ``none`` step bit
    for bit with dropout 0.1; kernel D's forward runs twice a layer a step
    (the recompute), its backward once."""
    plain, got = remat_steps(cuda, "none", True, na=True), remat_steps(cuda, "block", True, na=True)
    assert torch.equal(got[0], plain[0])
    for a, b in zip(got[1] + got[2], plain[1] + plain[2]):
        assert torch.equal(a, b)
    L = 2  # GRAPH_WIDTHS' layers (the serving config's)
    assert plain[3]["dep_graph_fwd"] == 3 * L and got[3]["dep_graph_fwd"] == 6 * L
    assert got[3]["dep_graph_bwd"] == plain[3]["dep_graph_bwd"] == 3 * L


@pytest.mark.parametrize("name", ["ci", "na", "packed"])
def test_captured_chunk_equals_single_captured_steps(cuda, name):
    """bf16 chunks with dropout 0.1 over resident tables: a warm-up chunk,
    then the key captured on its second chunk and replayed, give the single
    captured steps' health vectors, weights and AdamW state bit for bit on
    the same plans, and kernels C, D and E launch as often as in the single
    steps, counted through the replays."""
    from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        packed_training_config,
        serving_config,
        synthetic_csr,
        training_config,
    )
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.torch_dataset import CSRDataset
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_chunked_train_step, make_train_step

    packed = name == "packed"
    csr = synthetic_csr(np.random.default_rng(0), serving_config(**GRAPH_WIDTHS), 64 if packed else 24, mean_seq_len=20)
    L, B, k = (128, 2, 2) if packed else (32, 4, 3)
    dd = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=L)), device=cuda)
    if packed:
        chunks = [c for s in (1, 2) for c in list(dd.packed_plan_chunks(B, k, seq_len=L, seed=s))[:2]]
        batches = [b for s in (1, 2) for b in list(dd.packed_batches(B, seq_len=L, seed=s))[: 2 * k]]
        assert all(len(plans["event_ids"]) == k for plans, _ in chunks)
        first = batches[0].map(lambda t: t.cpu())
        config = packed_training_config([first], **dict(GRAPH_WIDTHS, max_seq_len=L))
    else:
        chunks = [c for s in (1, 2) for c in dd.plan_chunks(B, k, seed=s)]
        batches = [b for s in (1, 2) for b in dd.batches(B, seed=s)]
        config = (na_training_config if name == "na" else training_config)([batches[0].map(lambda t: t.cpu())],
                                                                           **GRAPH_WIDTHS)  # fmt: skip
    assert len(chunks) == 4 and len(batches) == 4 * k
    base = init_params_from_seed(build_model(config), seed=0)
    oc = dict(init_lr=1e-3, lr_num_warmup_steps=2, lr_frac_warmup_steps=None, max_training_steps=20)
    counters = (vocab_gather_fwd, vocab_gather_bwd, dep_graph_fwd, dep_graph_bwd, flash_attention_fwd,
                flash_attention_bwd)  # fmt: skip
    out = {}
    for chunked in (True, False):
        model = copy.deepcopy(base)
        optimizer, scheduler = build_optimizer(model, OptimizationConfig(**oc))
        for fn in counters:
            fn.launches = 0
        if chunked:
            step = make_chunked_train_step(model, optimizer, scheduler, dd, packed=packed, device=cuda,
                                           with_health=True)  # fmt: skip
            healths = torch.cat([step(plans, 7)[1] for plans, _ in chunks])
            s = step.stats()
            assert (s["chunk_keys"], s["graph_warmup_chunks"], s["graph_captures"], s["graph_replays"]) == (1, 1, 1, 3)
        else:
            step = make_train_step(model, optimizer, scheduler, device=cuda, with_health=True)
            healths = torch.stack([step(b, 7)[1] for b in batches])
        launches = [fn.launches for fn in counters]
        state = [t.cpu() for st in optimizer.state.values() for _, t in sorted(st.items())]
        out[chunked] = healths.cpu(), [p.detach().cpu() for p in model.parameters()], state, launches
    (h, p, st, n), (h1, p1, st1, n1) = out[True], out[False]
    assert torch.isfinite(h).all() and torch.equal(h, h1), (h, h1)
    assert all(torch.equal(a, b) for a, b in zip(p, p1)) and all(torch.equal(a, b) for a, b in zip(st, st1))
    steps = 4 * k
    layers = config.num_hidden_layers
    want = [steps, steps] + [layers * steps if name == "na" else 0] * 2 + [steps if packed else 0] * 2
    assert n == n1 == want, (n, n1, want)


# ------------------------------------------------------------- cohort generate()
GEN_NEW = 5


def small_generate_setup(na: bool):
    """A small fp32 CI or NA model (one head of 32: kernel D's head widths) at
    a narrow log-time scale with a near-constant TTE head, and a 4 x 8 prompt."""
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompt_batch
    from eventstreamgpt_tpu_torch.training import build_model

    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3), hidden_size=32,
                            num_attention_heads=1, head_dim=32, intermediate_size=64, seq_window_size=4,
                            **(NA_OVERRIDES if na else {}))  # fmt: skip
    model = init_params_from_seed(build_model(config), seed=1, std=0.15)
    with torch.no_grad():
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    return config, model, synthetic_prompt_batch(np.random.default_rng(1), 4, config, 8)


def categorical_draws(model, na: bool, new: int) -> int:
    """Kernel A's launches in one cached generate() of ``new`` events: one a
    categorical head an event (NA: each level's heads, plus every head once at
    the prefix's full forward)."""
    n = sum(m == "single_label_classification" for m in model.output_layer.classification_mode_per_measurement.values())
    return n * (new + (1 if na else 0))


def same_batches(a, b) -> None:
    for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values",
              "dynamic_values_mask"):  # fmt: skip
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_captured_generate_equals_eager_and_replays(cuda, na):
    """The prefix and decode-step programs are captured at a key's first call;
    a second call captures nothing, replays the prefix once and the step
    ``max_new_events - 1`` times, draws every categorical head through kernel
    A, and equals the first and the ``cuda_graph=False`` call bit for bit."""
    from eventstreamgpt_tpu_torch.generation import generate
    from eventstreamgpt_tpu_torch.generation.generation_utils import program_stats
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_fwd

    config, model, prompt = small_generate_setup(na)
    model = model.to(cuda)
    kw = dict(seed=3, max_new_events=GEN_NEW, num_return_sequences=2, device=cuda)
    first = generate(model, prompt, config, **kw)
    s1 = program_stats(model)
    assert (s1["keys"], s1["warmups"], s1["captures"], s1["replays"]) == (1, 2, 2, GEN_NEW)
    fused_categorical_stream.launches = dep_graph_fwd.launches = 0
    second = generate(model, prompt, config, **kw)
    s2 = program_stats(model)
    assert s2["captures"] == s1["captures"] and s2["replays"] - s1["replays"] == GEN_NEW
    assert fused_categorical_stream.launches == categorical_draws(model, na, GEN_NEW) > 0
    assert dep_graph_fwd.launches == 0  # the cached walk is on the einsum path
    fused_categorical_stream.launches = 0
    eager = generate(model, prompt, config, cuda_graph=False, **kw)
    assert fused_categorical_stream.launches == categorical_draws(model, na, GEN_NEW)
    assert program_stats(model)["replays"] == s2["replays"]
    same_batches(first, second)
    same_batches(first, eager)
    assert first.batch_size == 8 and bool(first.event_mask.all())
    assert bool(torch.isfinite(first.time_delta).all() and torch.isfinite(first.dynamic_values).all())


def test_uncached_na_generate_launches_kernel_d(cuda):
    from eventstreamgpt_tpu_torch.generation import generate
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_fwd

    config, model, prompt = small_generate_setup(True)
    dep_graph_fwd.launches = 0
    out = generate(model.to(cuda), prompt, config, seed=3, max_new_events=3, use_cache=False, device=cuda)
    G = len(config.measurements_per_dep_graph_level)
    assert dep_graph_fwd.launches == 3 * G * config.num_hidden_layers  # a full forward a level an event
    assert bool(out.event_mask.all())


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_generate_on_card_matches_cpu(cuda, na, cached, monkeypatch):
    """Greedy (through the module's ``sample_predictions``), fp32: events and
    integers exact, floats within phase 2's small-engine tolerance (1e-4)."""
    import functools

    import eventstreamgpt_tpu_torch.generation.generation_utils as gu

    config, model, prompt = small_generate_setup(na)
    monkeypatch.setattr(gu, "sample_predictions", functools.partial(gu.sample_predictions, greedy=True))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        out[dev.type] = gu.generate(copy.deepcopy(model).to(dev), prompt, config, seed=3, max_new_events=GEN_NEW,
                                    use_cache=cached, device=dev)  # fmt: skip
    a, b = out["cuda"], out["cpu"]
    for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    for f in ("time_delta", "dynamic_values"):
        torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- the NA engine
def na_engine_setup(hidden_size=128, **widths):
    """A small fp32 NA model (the serving vocabulary, bench.py's three
    dep-graph levels) at a narrow log-time scale with a near-constant TTE
    head, and 6 prompts of 6-12 events with budgets of 4-8."""
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling

    sizes = dict(GRAPH_WIDTHS, hidden_size=hidden_size, **widths)
    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, **sizes, **NA_OVERRIDES)
    model = init_params_from_seed(NAPPTForGenerativeSequenceModeling(config), seed=1, std=0.15)
    with torch.no_grad():
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    return config, model, synthetic_prompts(np.random.default_rng(1), 6, config, (6, 12), (4, 8))


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_captured_na_engine_equals_eager_engine(cuda, greedy, kv_cache_dtype):
    """The NA engine on the card, groups padded (sizes 2 and 4 at 4 slots):
    the captured engine (decode chunk, prefill keys, extraction widths) equals
    the ``cuda_graph=False`` engine bit for bit, and its second pass after
    ``reset()`` captures nothing and repeats the first; kernel A (sampled
    only) launches as often as the eager engine plus the warm-up chunk's and
    each prefill key's warm-up; kernels B and D never launch."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config, model, prompts = na_engine_setup()
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, greedy=greedy,
              kv_cache_dtype=kv_cache_dtype, device=cuda)  # fmt: skip

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    def zero():
        for c in ("launches", "launches_int8", "launches_fp8"):
            setattr(decode_stack_step, c, 0)
        fused_categorical_stream.launches = dep_graph_fwd.launches = 0

    runs, widths = {}, []
    for graph in (True, False):
        zero()
        eng = GenerationEngine(model, config, template=prompts[0][0], cuda_graph=graph, **kw)
        eng.scheduler.group_sizes = (2, 4)
        dispatch = eng._dispatch_group
        eng._dispatch_group = lambda g, d=dispatch: (widths.append((len(g.requests), g.group_size)), d(g))
        first = eng.run(requests())
        s, a_first = eng.stats(), fused_categorical_stream.launches
        eng.reset()
        fused_categorical_stream.launches = 0
        second = eng.run(requests())
        s2 = eng.stats()
        same_results(first, second)
        assert decode_stack_step.launches + decode_stack_step.launches_int8 + decode_stack_step.launches_fp8 == 0
        assert dep_graph_fwd.launches == 0  # the cached walk is on the einsum path, as JAX routes it
        assert s["decode_step_impl"] == "unfused" and eng.dep_key.dtype == torch.float32
        if graph:
            assert (s["graph_captures"], s["graph_warmup_chunks"]) == (1, 1)
            assert s["graph_replays"] == s["dispatched_chunks"] > 0
            assert s["prefill_graph_captures"] == s["prefill_graph_warmups"] == s["prefill_graph_keys"] > 0
            assert s["prefill_graph_replays"] == s["prefill_dispatches"]
            for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
                assert s2[k] == s[k], k
            assert s2["graph_replays"] == s["graph_replays"] + s2["dispatched_chunks"]
        runs[graph] = first, a_first, fused_categorical_stream.launches, s
    assert any(g > n for n, g in widths), widths
    same_results(runs[True][0], runs[False][0])
    (_, a_cap, a_cap2, s), (_, a_eager, a_eager2, e) = runs[True], runs[False]
    assert a_cap2 == a_eager2 and (a_eager == 0) == greedy
    if not greedy:  # one call a prefill group or a step: the eager count a call, times the calls and warm-ups
        per_call = a_eager // (e["prefill_dispatches"] + e["dispatched_chunks"] * e["decode_chunk"])
        want = per_call * (s["prefill_dispatches"] + s["prefill_graph_warmups"]
                           + (s["dispatched_chunks"] + s["graph_warmup_chunks"]) * s["decode_chunk"])  # fmt: skip
        assert per_call > 0 and a_cap == want


def test_na_engine_on_card_matches_cpu(cuda):
    """The small fp32 greedy NA engine on the card against the same engine on
    the CPU, groups padded: events and integers exact, floats within phase 2's
    small-engine tolerance (1e-4)."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config, model, prompts = na_engine_setup(hidden_size=32, num_attention_heads=4, head_dim=8,
                                             intermediate_size=64)  # fmt: skip
    kw = dict(n_slots=8, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        eng = GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw)
        eng.scheduler.group_sizes = (4, 8)
        res[dev.type] = eng.run([Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)])
    for g, c in zip(res["cuda"], res["cpu"]):
        assert (g.error, c.error) == (None, None)
        assert (g.n_events, g.n_generated) == (c.n_events, c.n_generated), g.request_id
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
            assert torch.equal(getattr(g.batch, f), getattr(c.batch, f)), (g.request_id, f)
        for f in ("time_delta", "dynamic_values"):
            torch.testing.assert_close(getattr(g.batch, f), getattr(c.batch, f), rtol=1e-4, atol=1e-4)


# -------------------------------------------------- the NA speculative engine
@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_captured_na_spec_engine_equals_eager_engine(cuda, greedy, kv_cache_dtype):
    """NA speculative decoding on the card (the one-layer truncated draft,
    ``k`` 3, default tolerances), groups padded: the spec chunk captured once
    and replayed once a dispatched chunk, each prefill key captured once;
    results, per-request proposals and acceptances and the rounds equal the
    ``cuda_graph=False`` engine's bit for bit, and again after ``reset()``
    with nothing captured anew; kernels B and D never launch; kernel A
    (sampled only) launches as often captured as eager after ``reset()``,
    counted through the replays."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft

    config, model, prompts = na_engine_setup()
    dcfg, draft = truncated_draft(config, model, 1)
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, greedy=greedy,
              kv_cache_dtype=kv_cache_dtype, device=cuda, spec=SpecConfig(model=draft, config=dcfg, k=3))  # fmt: skip

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    runs = {}
    for graph in (True, False):
        for c in ("launches", "launches_int8", "launches_fp8"):
            setattr(decode_stack_step, c, 0)
        fused_categorical_stream.launches = dep_graph_fwd.launches = 0
        eng = GenerationEngine(model, config, template=prompts[0][0], cuda_graph=graph, **kw)
        eng.scheduler.group_sizes = (2, 4)
        first = eng.run(requests())
        s = eng.stats()
        eng.reset()
        fused_categorical_stream.launches = 0
        second = eng.run(requests())
        s2 = eng.stats()
        same_results(first, second)
        counts = [(r.spec_proposed, r.spec_accepted) for r in first]
        assert counts == [(r.spec_proposed, r.spec_accepted) for r in second]
        assert decode_stack_step.launches + decode_stack_step.launches_int8 + decode_stack_step.launches_fp8 == 0
        assert dep_graph_fwd.launches == 0
        assert s["decode_step_impl"] == "spec_draft_verify" and s["spec_rounds"] == s["dispatched_chunks"] * 3 > 0
        assert eng.draft_dep_key.dtype == eng.dep_key.dtype == torch.float32
        if graph:
            assert (s["graph_captures"], s["graph_warmup_chunks"]) == (1, 1)
            assert s["graph_replays"] == s["dispatched_chunks"]
            assert s["prefill_graph_captures"] == s["prefill_graph_keys"] > 0
            assert s["prefill_graph_replays"] == s["prefill_dispatches"]
            for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
                assert s2[k] == s[k], k
            assert s2["graph_replays"] == s["graph_replays"] + s2["dispatched_chunks"]
        runs[graph] = first, counts, fused_categorical_stream.launches, s
    same_results(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    assert runs[True][3]["spec_rounds"] == runs[False][3]["spec_rounds"]
    assert runs[True][2] == runs[False][2] and (runs[True][2] == 0) == greedy


def test_na_spec_engine_on_card_matches_cpu(cuda):
    """The small fp32 strict-greedy NA spec engine (the one-layer truncated
    draft, ``k`` 3, zero tolerances) on the card against the same engine on
    the CPU, groups padded: events, integers, proposals and acceptances
    exact, floats within phase 2's small-engine tolerance (1e-4)."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft

    config, model, prompts = na_engine_setup(hidden_size=32, num_attention_heads=4, head_dim=8,
                                             intermediate_size=64)  # fmt: skip
    dcfg, draft = truncated_draft(config, model, 1)
    kw = dict(n_slots=8, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True,
              spec=SpecConfig(model=draft, config=dcfg, k=3, value_rtol=0.0, value_atol=0.0))  # fmt: skip
    res = {}
    for dev in (cuda, torch.device("cpu")):
        eng = GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw)
        eng.scheduler.group_sizes = (4, 8)
        res[dev.type] = eng.run([Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)])
    for g, c in zip(res["cuda"], res["cpu"]):
        assert (g.error, c.error) == (None, None)
        assert (g.n_events, g.n_generated, g.spec_proposed, g.spec_accepted) == (
            c.n_events, c.n_generated, c.spec_proposed, c.spec_accepted), g.request_id
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
            assert torch.equal(getattr(g.batch, f), getattr(c.batch, f)), (g.request_id, f)
        for f in ("time_delta", "dynamic_values"):
            torch.testing.assert_close(getattr(g.batch, f), getattr(c.batch, f), rtol=1e-4, atol=1e-4)


# ------------------------------------------- hot swap and the prefill stream
def program_addresses(eng) -> list:
    """The data pointers of every tensor the engine's programs read as weights."""
    return [t.data_ptr() for t in list(eng._model.parameters()) + list(eng._stacked.values())]


def test_captured_hot_swap_flip_equals_a_fresh_engine(cuda):
    """A captured hot-swap engine flips to a second set of weights with no
    capture: every weight keeps its address, kernel B keeps launching
    through the replays, and the run after the flip equals a fresh captured
    engine built on the second weights bit for bit (the same programs at the
    same shapes); a second flip rolls back to the first run's results."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    config, model, prompts = graph_engine_setup()
    model2 = init_params_from_seed(copy.deepcopy(model), seed=1)
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, device=cuda)

    def requests():
        return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]

    eng = GenerationEngine(model, config, template=prompts[0][0], hot_swap=True, **kw)
    first = eng.run(requests())
    ptrs, before = program_addresses(eng), eng.program_stats()
    eng.load_shadow(model2.state_dict())
    assert eng.probe_shadow() is None
    eng.reset()
    eng.flip()
    decode_stack_step.launches = 0
    flipped = eng.run(requests())
    assert decode_stack_step.launches == eng.stats()["dispatched_chunks"] * kw["decode_chunk"] > 0
    after = eng.program_stats()
    for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures"):
        assert after[k] == before[k], k
    assert program_addresses(eng) == ptrs
    same_results(GenerationEngine(model2, config, template=prompts[0][0], **kw).run(requests()), flipped)
    eng.reset()
    eng.flip()
    same_results(first, eng.run(requests()))
    assert eng.program_stats()["prefill_graph_captures"] == before["prefill_graph_captures"]


def test_captured_service_with_a_prefill_stream(cuda):
    """Two captured decode replicas behind a captured prefill engine: every
    request finishes, a second pass after ``reset()`` of every engine gives
    the first pass's results bit for bit, the decode
    replicas run no prefill program (one admission replay a handoff), the
    prefill engine one ``prefill_compute`` replay a group, and greedy events
    and integers equal the same service's with local prefill."""
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, PrefillStream, Request, ServingService

    config, model, prompts = graph_engine_setup()
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=3, device=cuda, greedy=True)

    def engine():
        return GenerationEngine(model, config, template=prompts[0][0], **kw)

    def requests():
        return [(Request(prompt=p, max_new_events=b, request_id=i), "batch" if i % 2 else "interactive")
                for i, (p, b) in enumerate(prompts)]  # fmt: skip

    replicas, pf = [engine(), engine()], engine()
    svc = ServingService(replicas, prefill_stream=PrefillStream(pf))
    first = svc.run(requests())
    for e in replicas + [pf]:
        e.reset()
    second = svc.run(requests())
    same_results(first, second)
    for e in replicas:
        s = e.stats()
        assert s["prefill_graph_keys"] == s["prefill_dispatches"] == 0
        assert s["admit_graph_replays"] == s["handoffs_admitted"] > 0
    p = pf.stats()
    assert p["prefill_compute_graph_replays"] == p["prefill_computes"] == svc.stats()["prefill_stream"]["dispatches"]
    local = ServingService([engine(), engine()]).run(requests())
    assert [(r.n_events, r.n_generated) for r in local] == [(r.n_events, r.n_generated) for r in first]
    for a, b in zip(local, first):
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices"):
            assert torch.equal(getattr(a.batch, f), getattr(b.batch, f)), f


def test_a_row_does_not_depend_on_its_batch(cuda):
    """`tools/row_invariance.py` at the serving model's width (bf16, 32 rows of
    192 events): the prefill at every power-of-two group width from 2 to 32
    gives each row what it gives the row alone, and a decode step at 32 slots
    what it gives at 16, bit for bit in every prediction and greedy draw; no
    operation's rows depend on the batch; kernel B's rows equal on the same
    inputs."""
    from eventstreamgpt_tpu_torch.tools.row_invariance import row_invariance

    bf16 = row_invariance(cuda, rows=32, length=192)[0]
    assert bf16["precision"] == "bf16"
    for part in bf16["prefill"] + [bf16["decode"]]:
        assert part["ops"]["ops_differing"] == [], part["rows"]
        out = part["outputs"]
        assert out["rows_with_other_decisions"] == 0 and out["float_draws_max_abs"] == 0.0, part["rows"]
        assert set(out["pred_floats_max_abs"].values()) == {0.0}, part["rows"]
    assert bf16["decode"]["kernel_b_same_input"] == dict(rows_equal=True, max_abs=0.0)


@pytest.mark.parametrize("kind", ["chunked", "single"])
def test_restore_keeps_addresses_and_the_next_replay_trains_from_it(cuda, kind):
    """A resume or rollback restore (`load_train_state`) after the step is
    captured: every parameter and AdamW tensor keeps its address, nothing is
    captured again, and the next replay from the restored state gives what
    the same step gave from that state the first time, bit for bit (bf16,
    dropout 0.1, accumulation k=2 in the chunked case)."""
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_csr, training_config
    from eventstreamgpt_tpu_torch.data.torch_dataset import CSRDataset
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_chunked_train_step, make_train_step
    from eventstreamgpt_tpu_torch.training.pretrain import load_train_state, train_state_dict

    csr = synthetic_csr(np.random.default_rng(0), serving_config(**GRAPH_WIDTHS), 24, mean_seq_len=20)
    dd = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=32)), device=cuda)
    config = training_config([next(dd.batches(4, seed=0)).map(lambda t: t.cpu())], **GRAPH_WIDTHS)
    model = init_params_from_seed(build_model(config), seed=0)
    accumulation = 2 if kind == "chunked" else None
    oc = OptimizationConfig(init_lr=1e-3, lr_num_warmup_steps=2, lr_frac_warmup_steps=None, max_training_steps=20,
                            gradient_accumulation=accumulation)  # fmt: skip
    optimizer, scheduler = build_optimizer(model, oc)
    if kind == "chunked":
        step = make_chunked_train_step(model, optimizer, scheduler, dd, device=cuda, with_health=True)
        items = [plans for plans, _ in dd.plan_chunks(2, 2, seed=1)][:4]
    else:
        step = make_train_step(model, optimizer, scheduler, device=cuda, with_health=True)
        items = list(dd.batches(4, seed=1))[:4]
    for item in items[:3]:  # warm-up, capture, replay
        step(item, 7)
    assert step.stats()["graph_captures"] == 1
    snapshot = train_state_dict(model, optimizer, scheduler, step.state)
    first = step(items[3], 7)[1].cpu()
    after = [p.detach().cpu() for p in model.parameters()]
    ptrs = [p.data_ptr() for p in model.parameters()] + [t.data_ptr() for st in optimizer.state.values()
                                                          for t in st.values() if t.dim()]  # fmt: skip
    load_train_state(snapshot, model, optimizer, scheduler, step.state)
    assert ptrs == [p.data_ptr() for p in model.parameters()] + [
        t.data_ptr() for st in optimizer.state.values() for t in st.values() if t.dim()
    ]
    again = step(items[3], 7)[1].cpu()
    assert step.stats()["graph_captures"] == 1
    assert torch.equal(first, again), (first, again)
    assert all(torch.equal(a, p.detach().cpu()) for a, p in zip(after, model.parameters()))


# ------------------------------------------------------------- functor measurements in generation
def functor_setup():
    """`chip_smoke.py`'s functor configuration and prompts (phase 19): ``age``
    (an `AgeFunctor`) and ``tod`` (a four-value `TimeOfDayFunctor`) added to
    a config, each prompt event carrying both, start times in 2010."""
    import chip_smoke

    return chip_smoke.with_functors, chip_smoke.with_functor_elements


@pytest.mark.parametrize("kind", ["generate", "engine", "paged_fork", "spec", "na_engine", "na_spec"])
def test_functor_generation_on_card_matches_cpu(cuda, kind, monkeypatch):
    """Small fp32 greedy runs with an `AgeFunctor` and a `TimeOfDayFunctor`:
    the card's captured programs against the CPU's eager ones, every event
    and integer equal, floats within 1e-4; every generated real event holds
    one age and one time-of-day element."""
    import eventstreamgpt_tpu_torch.generation.generation_utils as gu
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft
    from eventstreamgpt_tpu_torch.training import build_model

    with_functors, functor_rows = functor_setup()
    na = kind.startswith("na")
    config = with_functors(serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3),
                                          hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4,
                                          **(NA_OVERRIDES if na else {})))  # fmt: skip
    model = init_params_from_seed(build_model(config), seed=1, std=0.15)
    with torch.no_grad():
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    rng = np.random.default_rng(2)
    got = {}
    if kind == "generate":
        rows = [p for p, _ in functor_rows(synthetic_prompts(rng, 4, config, (10, 10), (6, 6)), config, rng)]
        batch = EventStreamBatch(**{f: torch.cat([getattr(r, f) for r in rows]) for f, x in vars(rows[0]).items()
                                    if x is not None})  # fmt: skip
        monkeypatch.setattr(gu, "sample_predictions", functools.partial(gu.sample_predictions, greedy=True))
        for dev in ("cuda", "cpu"):
            out = gu.generate(copy.deepcopy(model).to(dev), batch, config, seed=3, max_new_events=6, device=dev)
            got[dev] = [(0, 10, out.map(lambda t: t.cpu()))]
    else:
        prompts = functor_rows(synthetic_prompts(rng, 6, config, (6, 12), (4, 8)), config, rng)
        kw = dict(n_slots=8, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True)
        if kind == "paged_fork":
            kw.update(paged_kv=True, block_size=4)
        if kind.endswith("spec"):
            dcfg, draft = truncated_draft(config, model, 1)
            kw["spec"] = SpecConfig(model=draft, config=dcfg, k=3, value_rtol=0.0, value_atol=0.0)
        for dev in ("cuda", "cpu"):
            eng = GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw)
            if kind == "paged_fork":
                eng.fork(prompts[0][0], 3, 6, key=5, request_id="f")
            res = eng.run([Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)])
            assert all(r.error is None for r in res)
            got[dev] = [(r.request_id, r.prompt_len, r.batch) for r in sorted(res, key=lambda r: str(r.request_id))]
    age, tod = config.measurements_idxmap["age"], config.measurements_idxmap["tod"]
    for (i, n, a), (j, _, b) in zip(got["cuda"], got["cpu"]):
        assert i == j
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (i, f)
        for f in ("time_delta", "dynamic_values"):
            torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f), rtol=1e-4, atol=1e-4)
        new = b.event_mask[:, n:]
        meas = b.dynamic_measurement_indices[:, n:]
        assert bool(((meas == age).sum(-1) == 1)[new].all() and ((meas == tod).sum(-1) == 1)[new].all()), i


# ------------------------------------------------------------- the embedding table's gradient under capture
def test_embedding_bag_gradient_is_the_same_under_capture(cuda):
    """An fp32 table of 64 rows behind 6,144 lookups (heavy duplication,
    padding in 45% of the slots), its forward and backward captured on one
    index set and replayed on others: every replay's table gradient equals
    the eager one on the same indices bit for bit, and two replays of the
    same indices agree. CUDA's own embedding backward summed in an order
    that changed between replays and captures here."""
    from eventstreamgpt_tpu_torch.ops.tensor_ops import embedding_bag

    rng = np.random.default_rng(0)

    def index_set(seed):
        r = np.random.default_rng(seed)
        idx = r.integers(1, 64, size=(2, 128, 24))
        idx[r.random(idx.shape) < 0.45] = 0
        return torch.from_numpy(idx).to(cuda)

    table = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).to(cuda).requires_grad_(True)
    weights = torch.from_numpy(rng.normal(size=(2, 128, 24)).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32)).to(cuda)
    static = index_set(0)

    def step():
        table.grad = None
        embedding_bag(table, static, weights).backward(cot)
        return table.grad

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for seed in (1, 2, 3):
        static.copy_(index_set(seed))
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        eager = table.detach().clone().requires_grad_(True)
        embedding_bag(eager, index_set(seed), weights).backward(cot)
        assert torch.equal(first, out) and torch.equal(out, eager.grad), seed


def test_packed_chunks_equal_single_steps_at_every_chunk_repeatedly(cuda):
    """The packed case of `test_captured_chunk_equals_single_captured_steps`
    eight times over, its weights and AdamW state compared after every chunk
    (the single path after the same steps): equal bit for bit each time.
    Before the table gradient's fixed order (`ops.tensor_ops.table_grad`) one
    run in four to six differed, from the first replay that fed the captured
    step new indices, in the embedding table alone."""
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
    from eventstreamgpt_tpu_torch.data.synthetic import packed_training_config, serving_config, synthetic_csr
    from eventstreamgpt_tpu_torch.data.torch_dataset import CSRDataset
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_chunked_train_step, make_train_step

    csr = synthetic_csr(np.random.default_rng(0), serving_config(**GRAPH_WIDTHS), 64, mean_seq_len=20)
    L, B, k = 128, 2, 2
    dd = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=L)), device=cuda)
    chunks = [c for s in (1, 2) for c in list(dd.packed_plan_chunks(B, k, seq_len=L, seed=s))[:2]]
    batches = [b for s in (1, 2) for b in list(dd.packed_batches(B, seq_len=L, seed=s))[: 2 * k]]
    config = packed_training_config([batches[0].map(lambda t: t.cpu())], **dict(GRAPH_WIDTHS, max_seq_len=L))
    oc = dict(init_lr=1e-3, lr_num_warmup_steps=2, lr_frac_warmup_steps=None, max_training_steps=20)

    def snapshot(model, optimizer):
        return ([p.detach().cpu().clone() for p in model.parameters()],
                [t.cpu().clone() for st in optimizer.state.values() for _, t in sorted(st.items())])  # fmt: skip

    for run in range(8):
        base = init_params_from_seed(build_model(config), seed=run)
        snaps = {}
        for chunked in (True, False):
            model = copy.deepcopy(base)
            optimizer, scheduler = build_optimizer(model, OptimizationConfig(**oc))
            snaps[chunked] = []
            if chunked:
                step = make_chunked_train_step(model, optimizer, scheduler, dd, packed=True, device=cuda)
                for plans, _ in chunks:
                    step(plans, 7)
                    snaps[chunked].append(snapshot(model, optimizer))
            else:
                step = make_train_step(model, optimizer, scheduler, device=cuda)
                for i, b in enumerate(batches):
                    step(b, 7)
                    if i % k == k - 1:
                        snaps[chunked].append(snapshot(model, optimizer))
        names = [n for n, _ in base.named_parameters()]
        for c, ((p, st), (p1, st1)) in enumerate(zip(snaps[True], snaps[False])):
            differ = [n for n, a, b in zip(names, p, p1) if not torch.equal(a, b)]
            assert not differ and all(torch.equal(a, b) for a, b in zip(st, st1)), (run, c, differ)


def test_functor_elements_do_not_depend_on_the_batch(cuda):
    """A new event's functor elements and time (`generation.sampling.functor_elements`)
    for 32 rows of 192 events at once, against each row alone and the first
    16: bit for bit (the prior deltas are summed in fp64 a row)."""
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.generation.sampling import (
        GenerativeSequenceModelSamples,
        functor_elements,
        functor_measurements,
    )

    with_functors, functor_rows = functor_setup()
    config = with_functors(serving_config())
    rng = np.random.default_rng(3)
    rows = [p for p, _ in functor_rows(synthetic_prompts(rng, 32, config, (192, 192), (1, 1)), config, rng)]
    batch = EventStreamBatch(**{f: torch.cat([getattr(r, f) for r in rows]) for f, x in vars(rows[0]).items()
                                if x is not None}).map(lambda t: t.to(cuda))  # fmt: skip
    sample = GenerativeSequenceModelSamples(
        event_mask=torch.ones(32, dtype=torch.bool, device=cuda),
        time_to_event=torch.from_numpy(rng.uniform(1, 240, 32).astype(np.float32)).to(cuda),
    )
    cursor = torch.from_numpy(rng.integers(2, 192, 32)).to(cuda)
    functors = functor_measurements(config)
    full = functor_elements(batch, sample, functors, cursor)
    for lo, hi in [(b, b + 1) for b in range(32)] + [(0, 16)]:
        part = functor_elements(batch.slice((slice(lo, hi), slice(None))),
                                GenerativeSequenceModelSamples(event_mask=sample.event_mask[lo:hi],
                                                               time_to_event=sample.time_to_event[lo:hi]),
                                functors, cursor[lo:hi])  # fmt: skip
        for a, b in zip(full, part):
            assert torch.equal(a[lo:hi], b), (lo, hi)


# ------------------------------------------------------------- fine-tuning and embeddings
def classifier_setup(na: bool, pooling: str = "last", n_batches: int = 4, precision="bf16", **widths):
    """A stream classifier (bf16, dropout 0.1 by default) of phase 4's
    synthetic vocabulary on a binary task, and ``n_batches`` labelled 4 x 32
    batches of one shape (one batch's rows rolled) with a ``valid_mask``
    (the last row a fill row)."""
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        serving_config,
        synthetic_training_batches,
        training_config,
    )
    from eventstreamgpt_tpu_torch.models.fine_tuning_model import ESTForStreamClassification

    widths = widths or GRAPH_WIDTHS
    first = next(synthetic_training_batches(np.random.default_rng(0), serving_config(**widths), 4, 32))
    first = first.replace(stream_labels={"task": torch.tensor([0.0, 1.0, 1.0, 0.0])})
    batches = [first.map(lambda t, k=k: t.roll(k, 0)).replace(valid_mask=torch.tensor([True, True, True, False]))
               for k in range(n_batches)]  # fmt: skip
    config = (na_training_config if na else training_config)(batches, precision=precision, **widths)
    config.finetuning_task, config.id2label, config.num_labels = "task", {0: False, 1: True}, 2
    config.problem_type = "single_label_classification"
    config.task_specific_params = {"pooling_method": pooling}
    return init_params_from_seed(ESTForStreamClassification(config), seed=0), batches


@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_captured_fine_tuning_step_equals_eager_step(cuda, na):
    """Three bf16 steps of a stream classifier (dropout 0.1) through
    `make_train_step`: the captured step equals its ``cuda_graph=False`` run
    bit for bit (losses, health vectors, weights); kernel D launches once a
    layer a step each way through the replays (NA)."""
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_optimizer, make_train_step

    base, batches = classifier_setup(na, pooling="mean" if na else "last")
    assert base.config.attention_dropout == base.config.resid_dropout == 0.1
    oc = dict(init_lr=1e-3, lr_num_warmup_steps=0, lr_frac_warmup_steps=None, max_training_steps=10)
    out = {}
    for graph in (True, False):
        model = copy.deepcopy(base)
        step = make_train_step(model, *build_optimizer(model, OptimizationConfig(**oc)), device=cuda,
                               with_health=True, cuda_graph=graph)  # fmt: skip
        dep_graph_fwd.launches = dep_graph_bwd.launches = vocab_gather_fwd.launches = 0
        healths = [step(b, 7)[1] for b in batches[:3]]
        layers = base.config.num_hidden_layers if na else 0
        assert (dep_graph_fwd.launches, dep_graph_bwd.launches, vocab_gather_fwd.launches) == (3 * layers, 3 * layers, 0)
        s = step.stats()
        assert (s["graph_warmup_steps"], s["graph_captures"], s["graph_replays"]) == ((1, 1, 2) if graph else (0, 0, 0))
        out[graph] = torch.stack(healths).cpu(), [p.detach().cpu() for p in model.parameters()]
    assert torch.equal(out[True][0], out[False][0]), (out[True][0], out[False][0])
    assert torch.isfinite(out[True][0]).all() and len(set(out[True][0][:, 0].tolist())) == 3
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pooling", ["last", "max", "mean", "none"])
@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_captured_embedding_forward_equals_eager(cuda, na, pooling):
    """`make_embed_step` captured on its second batch and replayed gives the
    eager forward's pooled encodings bit for bit; kernel D once a layer a
    batch through the replays (NA)."""
    from eventstreamgpt_tpu_torch.training.embedding import EmbeddingsOnlyModel, make_embed_step

    classifier, batches = classifier_setup(na)
    model = EmbeddingsOnlyModel(classifier.config)
    model.encoder = classifier.encoder
    out = {}
    for graph in (True, False):
        embed = make_embed_step(model, model.config, pooling, device=cuda, cuda_graph=graph)
        dep_graph_fwd.launches = 0
        out[graph] = [embed(b).cpu() for b in batches]
        assert dep_graph_fwd.launches == (len(batches) * model.config.num_hidden_layers if na else 0)
        s = embed.stats()
        want = (1, 1, len(batches) - 1) if graph else (0, 0, 0)
        assert (s["graph_warmups"], s["graph_captures"], s["graph_replays"]) == want
    for a, b in zip(out[True], out[False]):
        assert a.shape == ((4, 32, 128) if pooling == "none" else (4, 128)) and torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_fine_tuning_on_card_matches_cpu(cuda, na):
    """A small fp32 classifier (hidden 32, dropout 0; NA: one head of 32,
    kernel D's narrowest) trained 4 steps and its pooled encodings, on the
    card and on the CPU: losses, weights and encodings within 1e-4."""
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_optimizer, make_train_step, train_steps
    from eventstreamgpt_tpu_torch.training.embedding import EmbeddingsOnlyModel, embed_batch

    heads = dict(num_attention_heads=1, head_dim=32) if na else dict(head_dim=8)
    widths = dict(sizes=(5, 40, 6, 3), hidden_size=32, intermediate_size=64, seq_window_size=4, attention_dropout=0.0,
                  input_dropout=0.0, resid_dropout=0.0, **heads)  # fmt: skip
    base, batches = classifier_setup(na, precision="fp32", **widths)
    oc = dict(init_lr=1e-3, lr_num_warmup_steps=1, lr_frac_warmup_steps=None, max_training_steps=10)
    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base)
        step = make_train_step(model, *build_optimizer(model, OptimizationConfig(**oc)), device=dev)
        losses = train_steps(step, batches, seed=3)
        encoder = EmbeddingsOnlyModel(model.config)
        encoder.encoder = model.encoder
        emb = embed_batch(encoder.eval(), model.config, batches[0].map(lambda t: t.to(dev)), "last").cpu()
        out[dev] = torch.tensor(losses), {n: p.detach().cpu() for n, p in model.named_parameters()}, emb
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for name, w in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], w, rtol=0, atol=1e-4, msg=lambda m: f"{name}: {m}")
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-4, atol=1e-4)


def test_pretrain_entry_point_trains_on_the_card(cuda, tmp_path):
    """``scripts.pretrain.main`` with no device trains a tiny CI model on the
    card (a synthetic cohort whose labs are a multivariate regression plane),
    and kernel C's counters move through its steps and replays. An epoch is
    one chunk (4 steps, a log window of 4): its key warms up in epoch 0 and
    is captured in epoch 1, which the capture guard allows."""
    from eventstreamgpt_tpu_torch.data.synthetic import write_synthetic_cache
    from eventstreamgpt_tpu_torch.scripts import pretrain

    data = write_synthetic_cache(tmp_path / "cache", {"train": 32, "tuning": 8, "held_out": 8}, n_event_types=8,
                                 n_labs=40, n_meds=8, n_static=4, mean_seq_len=16, max_seq_len=32, seed=0)  # fmt: skip
    for fn in (vocab_gather_fwd, vocab_gather_bwd):
        fn.launches = 0
    tuning_loss, _, _ = pretrain.main(
        [f"data_config.save_dir={data}", "data_config.max_seq_len=16", "config.hidden_size=32", "config.head_dim=8",
         "config.num_attention_heads=4", "config.intermediate_size=64", "optimization_config.max_epochs=2",
         "optimization_config.batch_size=8", "optimization_config.validation_batch_size=8",
         "optimization_config.lr_frac_warmup_steps=0.5", "final_validation_metrics_config.do_skip_all_metrics=true",
         "trainer_config.log_every_n_steps=4", f"save_dir={tmp_path / 'run'}"])  # fmt: skip
    assert np.isfinite(tuning_loss)
    assert vocab_gather_fwd.launches >= 8 and vocab_gather_bwd.launches >= 8
    weights = torch.load(tmp_path / "run" / "pretrained_weights" / "model.pt", map_location="cpu", weights_only=True)
    assert all(torch.isfinite(w).all() for w in weights.values())
