"""The PyTorch port's hand-written kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda``
marker and skip without a CUDA device. The file imports no JAX (the machine
with the card has none); run it there without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from eventstreamgpt_tpu_torch.convert import init_params_from_seed
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
