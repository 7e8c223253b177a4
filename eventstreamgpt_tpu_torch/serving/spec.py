"""Speculative decoding for the event-stream grammar: the accept rule and the draft.

Counterpart: ``eventstreamgpt_tpu/serving/spec.py``. The engine's spec mode
(`serving.engine.GenerationEngine`, ``spec=SpecConfig(...)``) runs a cheap
**draft model** K events ahead of each slot, scores the K proposals with one
target forward over a K + 1-event window of the per-row-cursor cache, and
commits the accepted prefix plus one correction (or bonus) event per round,
rolling the cache cursors back over the rejected tail without copies. This
module holds the model-free pieces: the draft and its grammar check, the
per-event-index streams and the per-head accept walk.

**Streams.** Event ``j`` of a request (``j = position - prompt_len``, the
prefill's first event being ``j = 0``) draws every head from
``RowStreams(seed, j)`` (`generation.sampling`; on a nested-attention
model level ``l`` of event ``j`` from ``RowStreams(seed, j * G + l)``,
`level_streams`), addressed, never advanced:
draft proposals, target draws, acceptance uniforms (``spec_acc:<m>``) and
residual draws (``spec_res:<m>``) of event ``j`` all come from that stream,
so results do not depend on slot placement, chunking or refill order. The
port's counter hash (not Threefry) makes the sampled trajectories the port's
own, as in the non-speculative engine.

**The accept rule** (`spec_accept_level`, JAX's, batched over rows in place
of ``vmap``): discrete heads run the rejection rule (accept ``x ~ q`` with
probability ``min(1, p(x) / q(x))``, else draw the residual ``(p - q)^+``,
exact in closed form; a Bernoulli's residual is the deterministic flip);
continuous heads (TTE, regression values) run the comonotone coupling: draft
and target draw on the same stream and the draft's value commits when within
``value_atol + value_rtol * |target|``, else the target's. Heads walk in a
fixed order; after the first rejected head every later head commits the
target's draw. Greedy mode accepts on exact equality. ``top_k`` / ``top_p``
filter both pmfs with the sampling tail's own tie-inclusive mask and fill
(`ops.fused_sampling.topk_topp_mask`, the fp32 minimum), so the committed
law is the filtered target law. The residual's categorical draw is a Gumbel
argmax of its logits on the ``spec_res:`` stream: kernel A
(`ops.fused_sampling.fused_categorical_stream`) on the card, its plain
version on the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..distributions import Categorical
from ..generation.sampling import GenerativeSequenceModelSamples, RowStreams, assemble_event_sample
from ..models.config import StructuredTransformerConfig
from ..ops.fused_sampling import F32_MIN, fused_categorical_stream, topk_topp_mask

# The fill of a filtered logit: the sampling tail's (JAX's ``_NEG``, the fp32 minimum).
_NEG = F32_MIN


@dataclasses.dataclass
class SpecConfig:
    """The draft side of a speculative-decoding engine.

    Args:
        model: the draft model (a `models.ci_model.CIPPTForGenerativeSequenceModeling`
            or `models.na_model.NAPPTForGenerativeSequenceModeling`, as the
            target, with its weights; `truncated_draft` cuts one from the target).
        config: the draft's configuration. Its measurement grammar must equal
            the target's (`validate_against`); width and depth are free.
        k: events proposed a slot a round; a round commits 1 to ``k + 1``.
        value_rtol, value_atol: the continuous heads' acceptance tolerance
            (both zero: the exact target law, no continuous acceptance).
    """

    model: Any
    config: StructuredTransformerConfig
    k: int = 4
    value_rtol: float = 1e-3
    value_atol: float = 1e-6

    def validate_against(self, target: StructuredTransformerConfig) -> None:
        """The measurement-grammar equality the accept rule relies on (JAX's words)."""
        for attr in (
            "structured_event_processing_mode",
            "measurements_idxmap",
            "vocab_offsets_by_measurement",
            "vocab_sizes_by_measurement",
            "measurements_per_generative_mode",
            "TTE_generation_layer_type",
            "measurements_per_dep_graph_level",
        ):
            a, b = getattr(self.config, attr, None), getattr(target, attr, None)
            if a != b:
                raise ValueError(
                    f"draft config disagrees with the target on `{attr}`: the accept rule compares per-head "
                    f"densities, so the draft must share the target's measurement grammar ({a!r} != {b!r})"
                )
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")


def truncated_draft(config: StructuredTransformerConfig, model, num_layers: int) -> tuple:
    """A free draft: the target's first ``num_layers`` layers.

    Returns ``(draft_config, draft_model)``: the target's configuration cut to
    ``num_layers`` layers, and a model whose input layer, blocks ``h0 ..
    h{num_layers - 1}``, ``ln_f`` and output heads are the target's own
    modules (shared, not copied), as JAX's truncated parameter tree shares
    the target's leaves.
    """
    L = config.num_hidden_layers
    if not (1 <= num_layers < L):
        raise ValueError(f"num_layers must be in [1, {L}), got {num_layers}")
    draft_config = copy.deepcopy(config)
    draft_config.num_hidden_layers = num_layers
    draft_config.seq_attention_layers = list(config.seq_attention_layers[:num_layers])
    if getattr(config, "dep_graph_attention_layers", None) is not None:
        draft_config.dep_graph_attention_layers = list(config.dep_graph_attention_layers[:num_layers])
    with torch.device("meta"):  # every module below is replaced by the target's
        draft = type(model)(draft_config)
    enc, tgt = draft.encoder, model.encoder
    enc.input_layer, enc.ln_f = tgt.input_layer, tgt.ln_f
    for name in enc.layer_names:
        setattr(enc, name, getattr(tgt, name))
    draft.output_layer = model.output_layer
    return draft_config, draft


def event_streams(seeds: torch.Tensor, gen_index: torch.Tensor) -> RowStreams:
    """The streams of each row's event ``gen_index`` (``position - prompt_len``):
    every draw of that event comes from them (JAX's ``fold_in_event``)."""
    return RowStreams(seeds, gen_index.long())


def level_streams(seeds: torch.Tensor, gen_index: torch.Tensor, n_levels: int, level: int) -> RowStreams:
    """The streams of dep-graph level ``level`` of each row's event
    ``gen_index`` in a nested-attention engine of ``n_levels`` levels:
    counter ``gen_index * n_levels + level``, the address the
    non-speculative NA engine draws from (JAX's ``_level_keys`` of
    ``fold_in_event``). Every draw of that level comes from them: the
    draft's proposal, the target's draw, the acceptance uniforms and
    residuals, the bonus event and the correction walk's draws."""
    return RowStreams(seeds, gen_index.long() * n_levels + level)


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row ``(B,)`` mask shaped to broadcast over ``like`` ``(B, ...)``."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _row_all(x: torch.Tensor) -> torch.Tensor:
    """Each row's ``all`` over its trailing axes (JAX's per-row ``.all()``)."""
    return x.reshape(x.shape[0], -1).all(dim=1)


def _nan_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise exact equality with NaN == NaN (greedy acceptance)."""
    if a.is_floating_point():
        return (a == b) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def _value_close(x_q: torch.Tensor, x_p: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    """The continuous-head acceptance predicate (NaN pairs count as close:
    matched unobserved draws)."""
    both_nan = torch.isnan(x_q) & torch.isnan(x_p)
    return both_nan | ((x_q - x_p).abs() <= atol + rtol * x_p.abs())


def _combined_single_label_logpmf(is_obs_logits, cls_logits: torch.Tensor) -> torch.Tensor:
    """log-pmf ``(..., V)`` of the committed single-label value ``where(obs, c, 0)``:
    ``P(v) = p_obs * softmax(cls)[v] + (1 - p_obs) * [v == 0]``."""
    lsm = torch.log_softmax(cls_logits, dim=-1)
    if is_obs_logits is None:
        return lsm
    comb = F.logsigmoid(is_obs_logits)[..., None] + lsm
    first = torch.logaddexp(comb[..., :1], F.logsigmoid(-is_obs_logits)[..., None])
    return torch.cat([first, comb[..., 1:]], dim=-1)


def _residual_logits(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """Logits of the normalized residual ``(p - q)^+`` (``-1e30`` off its
    support); a row whose residual underflows to zero (``p == q`` yet the
    test rejected, probability 0) takes ``log_p``."""
    r = torch.clamp(torch.exp(log_p) - torch.exp(log_q), min=0.0)
    has_mass = r.sum(dim=-1, keepdim=True) > 0.0
    return torch.where(has_mass, torch.where(r > 0.0, torch.log(torch.clamp(r, min=1e-45)), -1e30), log_p)


def _residual_categorical(log_p: torch.Tensor, log_q: torch.Tensor, stream: RowStreams) -> torch.Tensor:
    """An exact draw per row from the normalized residual ``(p - q)^+``: the
    Gumbel argmax of `_residual_logits` on ``stream`` (kernel A on the card)."""
    return fused_categorical_stream(_residual_logits(log_p, log_q), stream)


def spec_accept_level(
    tgt_preds,
    dft_preds,
    dft_draws: dict,
    tgt_draws: dict,
    streams: RowStreams | None,
    event_mask: torch.Tensor,
    *,
    greedy: bool,
    rtol: float,
    atol: float,
    top_k: int | None = None,
    top_p: float | None = None,
) -> tuple:
    """The per-head accept walk of one proposed event, every row at once.

    Args:
        tgt_preds, dft_preds: the target's and the draft's predictions for the
            event (``(B, ...)`` parameters).
        dft_draws, tgt_draws: their raw named-head draws
            (`generation.sampling.sample_head_draws`) from the SAME event
            streams (the coupling).
        streams: the event's streams (`event_streams`); acceptance uniforms
            and residual draws take the names ``spec_acc:<m>`` and
            ``spec_res:<m>``. Unused (``None``) in greedy mode.
        event_mask: ``(B,)``, the mask the committed event carries.
        greedy: exact-equality acceptance against the target's greedy draws.
        top_k, top_p: the engine's filters (ignored in greedy mode).

    Returns:
        ``(accepted, corrected)``: ``(B,)`` whether every head accepted, and
        the event sample to commit where this is the first event not fully
        accepted.
    """
    tgt_sample = assemble_event_sample(tgt_preds, tgt_draws, event_mask)
    state = {"accepted": torch.ones_like(event_mask, dtype=torch.bool)}
    state["prior_rej"] = ~state["accepted"]

    def chain(accept_h, draft_val, residual_val, target_val):
        corrected = torch.where(
            _rows(state["prior_rej"], target_val),
            target_val,
            torch.where(_rows(accept_h, draft_val), draft_val, residual_val),
        )
        state["prior_rej"] = state["prior_rej"] | ~accept_h
        state["accepted"] = state["accepted"] & accept_h
        return corrected

    def log_uniform(name, shape):
        return torch.log(streams.for_name(name).uniform(shape))

    corr_cls = None
    if tgt_preds.classification is not None:
        corr_cls = {}
        for m, (t_obs, t_dist) in tgt_preds.classification.items():
            d_obs, d_dist = dft_preds.classification[m]
            x_t = tgt_sample.classification[m]
            B = x_t.shape[0]
            if isinstance(t_dist, Categorical):
                # Single-label head: the committed value's combined pmf.
                x_q = dft_draws[f"cls:{m}"]
                if d_obs is not None:
                    x_q = torch.where(dft_draws[f"cls_obs:{m}"] == 1, x_q, torch.zeros_like(x_q))
                x_q = x_q.to(x_t.dtype)
                if greedy:
                    acc = _nan_eq(x_q, x_t)
                    corr = chain(acc, x_q, x_t, x_t)
                else:
                    t_logits, d_logits = t_dist.logits, d_dist.logits
                    if top_k is not None or top_p is not None:
                        # Each side's pmf filtered by its own mask: the law its draw came from.
                        t_logits = torch.where(topk_topp_mask(t_logits, top_k, top_p), t_logits, _NEG)
                        d_logits = torch.where(topk_topp_mask(d_logits, top_k, top_p), d_logits, _NEG)
                    lp = _combined_single_label_logpmf(None if t_obs is None else t_obs.logits, t_logits)
                    lq = _combined_single_label_logpmf(None if d_obs is None else d_obs.logits, d_logits)
                    idx = x_q.long()[:, None]
                    ratio = lp.gather(-1, idx)[:, 0] - lq.gather(-1, idx)[:, 0]
                    acc = log_uniform(f"spec_acc:{m}", (B,)) <= torch.clamp(ratio, max=0.0)
                    x_r = _residual_categorical(lp, lq, streams.for_name(f"spec_res:{m}"))
                    corr = chain(acc, x_q, x_r.to(x_t.dtype), x_t)
            else:
                # Multi-label Bernoulli vector: the component-wise rule, a
                # draft prefix, the deterministic flip at the first rejected
                # component, the target's draws after it.
                x_q = dft_draws[f"cls:{m}"].to(x_t.dtype)
                if greedy:
                    acc = _row_all(_nan_eq(x_q, x_t))
                    corr = chain(acc, x_q, x_t, x_t)
                else:
                    lp, lq = t_dist.log_prob(x_q), d_dist.log_prob(x_q)
                    rej = log_uniform(f"spec_acc:{m}", tuple(x_q.shape)) > torch.clamp(lp - lq, max=0.0)
                    first = rej.to(torch.int32).argmax(dim=-1, keepdim=True)  # 0 where none rejects
                    idx = torch.arange(x_q.shape[-1], device=x_q.device)
                    flip = (t_dist.logits > d_dist.logits).to(x_t.dtype)
                    mixed = torch.where(idx < first, x_q, torch.where(idx == first, flip, x_t))
                    acc = ~rej.any(dim=-1)
                    corr = chain(acc, x_q, mixed, x_t)
            corr_cls[m] = corr

    corr_reg = None
    if tgt_preds.regression is not None:
        corr_reg = {}
        for m, (t_obs, _) in tgt_preds.regression.items():
            d_obs, _ = dft_preds.regression[m]
            raw_q, raw_t = dft_draws[f"reg:{m}"], tgt_draws[f"reg:{m}"]
            x_t = tgt_sample.regression[m]
            if t_obs is None:
                # Indexed / multivariate values: the coupling alone (greedy: the
                # greedy value is the coupled draw; the tolerance still governs).
                acc = _row_all(_value_close(raw_q, x_t if greedy else raw_t, rtol, atol))
                corr = chain(acc, raw_q, x_t, x_t)
            else:
                # Univariate with an is-observed bit: the bit runs the exact
                # Bernoulli rule; the value (reached only when observed) the coupling.
                o_q = dft_draws[f"reg_obs:{m}"]
                val_q = torch.where(_rows(o_q == 1, raw_q), raw_q, torch.nan)
                if greedy:
                    acc = _row_all(_value_close(val_q, x_t, rtol, atol))
                    corr = chain(acc, val_q, x_t, x_t)
                else:
                    lp_o, lq_o = t_obs.log_prob(o_q), d_obs.log_prob(o_q)
                    rej_o = log_uniform(f"spec_acc:{m}", tuple(o_q.shape)) > torch.clamp(lp_o - lq_o, max=0.0)
                    val_ok = (o_q != 1) | _row_all(_value_close(raw_q, raw_t, rtol, atol))
                    acc = ~rej_o & val_ok
                    o_flip = (t_obs.logits > d_obs.logits).to(o_q.dtype)
                    residual = torch.where(
                        _rows(rej_o, raw_t), torch.where(_rows(o_flip == 1, raw_t), raw_t, torch.nan), raw_t
                    )
                    corr = chain(acc, val_q, residual, x_t)
            corr_reg[m] = corr

    corr_tte = None
    if tgt_preds.time_to_event is not None:
        tte_q = torch.nan_to_num(dft_draws["tte"], posinf=1000.0)
        tte_t = tgt_sample.time_to_event
        # Greedy and sampled share the coupling: greedy's target draw is its greedy value.
        corr_tte = chain(_value_close(tte_q, tte_t, rtol, atol), tte_q, tte_t, tte_t)

    corrected = GenerativeSequenceModelSamples(
        event_mask=event_mask,
        time_to_event=corr_tte,
        classification=corr_cls,
        regression=corr_reg,
        regression_indices=tgt_sample.regression_indices,
    )
    return state["accepted"], corrected


def select_candidate(cands: list, index: torch.Tensor) -> GenerativeSequenceModelSamples:
    """Per-row selection among candidate event samples: row ``b`` of every
    field is ``cands[index[b]]``'s (a gather; values commit bit for bit)."""
    rows = torch.arange(index.shape[0], device=index.device)
    idx = index.long()

    def pick(*xs):
        return torch.stack(xs)[idx, rows]

    def pick_dict(name):
        first = getattr(cands[0], name)
        return None if first is None else {k: pick(*(getattr(c, name)[k] for c in cands)) for k in first}

    tte = cands[0].time_to_event
    return GenerativeSequenceModelSamples(
        event_mask=pick(*(c.event_mask for c in cands)),
        time_to_event=None if tte is None else pick(*(c.time_to_event for c in cands)),
        classification=pick_dict("classification"),
        regression=pick_dict("regression"),
        regression_indices=cands[0].regression_indices,
    )
