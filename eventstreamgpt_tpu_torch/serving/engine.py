"""Continuous-batching generation engine for CI models: slot-based decode.

Counterpart: the core of ``eventstreamgpt_tpu/serving/engine.py``
(`GenerationEngine`), single device. A fixed set of decode **slots** holds
requests at different depths: per-slot cursors, budgets, done/live/health
flags and random-stream counters live on the device; a decode chunk runs
``decode_chunk`` one-event steps over all slots and finished or empty slots
are masked out of every write, so no step syncs with the host. The host
reads one packed ``(5, n_slots)`` boundary per chunk, harvests finished
rows and refills free slots with bucketed prefill groups.

Per decode step on the card: the input layer (PyTorch), the whole layer
stack through kernel B (`ops.decode_step.decode_stack_step`, CUDA), ``ln_f``
and the output heads (PyTorch), the categorical heads through kernel A
(`ops.fused_sampling.fused_categorical_stream`, CUDA), which draws the
Gumbel noise of each row's stream inside the kernel, and the in-place
buffer updates. On CPU tensors both kernels
take their plain PyTorch versions. Prefill runs the model forward on a
fresh float cache at the bucket width for a group of requests padded, as
the JAX engine pads it, to the scheduler's group width with inert rows, and
admits the real rows into their slots. With ``kv_cache_dtype`` "int8" or
"fp8" the slot caches hold codes and per-head-per-position fp32 scales
(`ops.kv_quant`): the prefill's cache is quantized whole at admission,
kernel B quantizes each new key and value at the cursor and dequantizes
what it reads.

Index planes are held in int32 and floats in fp32, whatever the template
and prompts hold, as the JAX package (x64 off) holds them; request seeds
and stream counters are int32 words (the counter hash reads 32 bits of
each), cast to int64 once a program where kernel A and the hash take them.

The engine runs three kinds of program, each the counterpart of a jitted
JAX program: the decode chunk (JAX's ``_decode_chunk_ci`` behind
``_decode_jit``), the prefill-and-admit program of a (bucket, group width)
key (``_prefill_jit``: `GenerationEngine._prefill_admit`) and the
harvest's extraction at a group width (``_extract_jit``:
`GenerationEngine._extract`). Each reads its static inputs from one buffer
that the host fills with one staging copy (`utils.graphs.ByteLayout`) and
writes only the engine's state buffers and its static outputs, which keep
their addresses for the engine's life (`GenerationEngine.reset` writes the
initial values back in place). On the card each is captured into a CUDA
graph (`utils.graphs.CapturedProgram`; an engine's programs share one
memory pool): the decode chunk at construction while every slot is
inactive, a prefill or extraction key at its first use, after a warm-up
whose every row is inert. Each call is then one replay: one host launch.
``cuda_graph=False`` runs the same programs eagerly instead; the CPU always
does.

Pipelined boundaries: after each chunk the packed ``(5, n_slots)`` boundary
is computed on the device and its copy into pinned host memory started at
once (``non_blocking``, with a CUDA event); up to ``dispatch_depth`` chunks
are issued before the oldest boundary is resolved, strictly in issue order,
so the host's harvest and admission planning overlap the device's decode.
A finished slot's row is frozen (every write is masked by ``active``), so a
stale boundary harvests the same content, and each slot carries its
admission epoch (the chunk count when its request was admitted): a boundary
issued before that admission never harvests the new tenant. Results are
bitwise the same at every depth; a freed slot is refilled up to
``dispatch_depth - 1`` chunks later.

Randomness: request ``i`` draws from the counter-based stream
`derive_request_seed(engine seed, i)` (or its own ``key``), advanced once
per step the row is active, so a trajectory depends only on the request's
seed, never on its slot, co-residents or refill order.

Stop rules per row: the budget, dead rows (a masked newest event), extra
`generation.stopping_criteria.DeviceCriterion`s, and the health sentinel
(non-finite predictions or samples quarantine the slot; its request fails
with `serving.errors.SlotHealthError`, or, with ``health_retries`` budget
left, goes back to the front of the queue with its seed fixed, so the retry
reproduces a clean run bit for bit).

Not ported yet, each a ``ValueError`` at construction: speculative
decoding, the paged cache and ``fork()``, meshes and tensor parallelism,
hot swap, the dedicated prefill stream, nested-attention models, and
functional-time-dependent measurements.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.types import X32, EventStreamBatch
from ..distributions import dist_tensors
from ..generation.generation_utils import _mask_through_cursor, _slice_preds_at, _trim_to_event
from ..generation.sampling import (
    M32,
    RowStreams,
    append_new_event,
    assemble_event_sample,
    check_generation_config,
    derive_request_seed,
    measurements_to_fill,
    sample_head_draws,
    update_last_event_data,
)
from ..generation.stopping_criteria import DeadRowCriteria, DeviceCriterion
from ..models.config import StructuredEventProcessingMode, StructuredTransformerConfig
from ..models.transformer import init_kv_caches
from ..ops.decode_step import decode_stack_step, stack_layer_weights
from ..ops.fused_sampling import fused_categorical_stream, topk_topp_mask
from ..ops.kv_quant import (
    CACHE_DTYPES,
    cache_dtype_name,
    kv_cache_bytes_per_slot,
    quantize_kv,
    resolve_cache_dtype,
    storage,
)
from ..ops.tensor_ops import take_event
from ..utils.device import resolve_device
from ..utils.graphs import ByteLayout, CapturedProgram, ProgramFamily
from .errors import MalformedPromptRejected, SlotHealthError
from .scheduler import EngineResult, Request, Scheduler, check_prompt_finite, make_buckets

# EventStreamBatch fields a slot row carries.
_CORE_FIELDS = (
    "event_mask",
    "time_delta",
    "static_indices",
    "static_measurement_indices",
    "dynamic_indices",
    "dynamic_measurement_indices",
    "dynamic_values",
    "dynamic_values_mask",
    "start_time",
)
# The per-slot state a decode step rebinds: the chunk threads it through its
# steps and copies the result back into the engine's buffers of these names.
_CHUNK_STATE = ("cursor", "n_generated", "counters", "done", "health", "active_steps", "cache_mask", "cache_len")
# The memory budget `stats` reports slots against off the card (the JAX engine's default).
_REPORT_HBM_GB = 16.0
_SEQ_FIELDS = (
    "event_mask",
    "time_delta",
    "dynamic_indices",
    "dynamic_measurement_indices",
    "dynamic_values",
    "dynamic_values_mask",
)
# The JAX engine's options this slice does not port: name -> its off value.
_NOT_PORTED = {
    "mesh": None,
    "hot_swap": False,
    "spec": None,
    "paged_kv": False,
    "prefill_stream": None,
}


def _int32_word(v: int) -> int:
    """The low 32 bits of ``v`` as a signed int32 value (the word the counter hash reads)."""
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _admit_rows(dst: torch.Tensor, src, slots: torch.Tensor, valid: torch.Tensor, dim: int = 0) -> None:
    """``dst``'s rows ``slots`` along ``dim`` set to ``src`` (a tensor of those
    rows, or a scalar) where ``valid``, and to what they hold where not: the
    JAX admission's ``.at[slots].set(src, mode="drop")`` for a padded group,
    whose pad rows are aimed at slots outside the group. A gather, a select
    and a scatter to distinct slots: deterministic, and an invalid row
    writes back its slot's bits."""
    old = dst.index_select(dim, slots)
    shape = [1] * old.ndim
    shape[dim] = -1
    new = torch.where(valid.view(shape), src.to(dst.dtype) if torch.is_tensor(src) else src, old)
    dst.index_copy_(dim, slots, new)


class GenerationEngine:
    """Continuous-batching engine over one CI model.

    Args:
        model: a `models.ci_model.CIPPTForGenerativeSequenceModeling` with
            its weights loaded (fp32 parameters; the engine casts a copy of
            the Dense weights to the compute dtype once).
        config: the model configuration.
        template: any `EventStreamBatch` from the same data pipeline: fixes
            the data-element and static widths.
        n_slots, max_len, decode_chunk, max_prompt_len, min_bucket, max_queue,
        stop_dead_rows, device_criteria, greedy, top_k, top_p,
        health_sentinel, validate_prompts: as in the JAX engine.
        seed: the engine seed request streams derive from.
        dispatch_depth: decode chunks in flight before the oldest boundary
            is resolved (1: each chunk's boundary is resolved before the
            next chunk is issued). Results do not depend on it.
        health_retries: how often a request whose slot the health sentinel
            quarantined is retried (from the front of the queue, with the
            same seed) before it fails with `SlotHealthError`.
        kv_cache_dtype: the slot caches' storage type: ``None`` (the
            compute dtype), its own name, or ``"int8"`` / ``"fp8"`` (codes
            with fp32 scale tables, `ops.kv_quant`). Kernel B reads float
            caches in the compute dtype only.
        device: ``None`` (the CUDA device, raising without one) or an
            explicit device such as ``"cpu"``.
        cuda_graph: on a CUDA device, capture each program once and replay
            it for every call (the default, the counterpart of the JAX
            engine's jitted programs): the decode chunk at construction, each
            prefill (bucket, group width) and extraction width at its first
            use. ``False`` runs them eagerly, one host launch per operation
            (the counterpart of ``jax.disable_jit()``, for comparisons). The
            CPU always runs them eagerly.
    """

    def __init__(
        self,
        model,
        config: StructuredTransformerConfig,
        *,
        template: EventStreamBatch,
        n_slots: int,
        max_len: int,
        decode_chunk: int = 8,
        dispatch_depth: int = 2,
        max_queue: Optional[int] = None,
        max_prompt_len: int | None = None,
        min_bucket: int = 8,
        seed: int = 0,
        device_criteria: Sequence[DeviceCriterion] = (),
        stop_dead_rows: bool = True,
        top_k: int | None = None,
        top_p: float | None = None,
        greedy: bool = False,
        health_sentinel: bool = True,
        health_retries: int = 0,
        validate_prompts: bool = True,
        kv_cache_dtype: str | None = None,
        device=None,
        cuda_graph: bool = True,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"GenerationEngine got an unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise ValueError(f"{name}={value!r} is not part of the PyTorch port's serving slice yet")
        self.dispatch_depth = int(dispatch_depth)
        if self.dispatch_depth < 1:
            raise ValueError("dispatch_depth must be >= 1")
        if config.structured_event_processing_mode != StructuredEventProcessingMode.CONDITIONALLY_INDEPENDENT:
            raise ValueError("nested-attention serving (the NA engine) is not part of the PyTorch port yet")
        check_generation_config(config)
        self.device = resolve_device(device, "GenerationEngine")
        self.config = config
        self.cdt = config.compute_dtype
        self.greedy = bool(greedy)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.health_sentinel = bool(health_sentinel)
        self.health_retries = int(health_retries)
        self.validate_prompts = bool(validate_prompts)
        self._kv_buf_dtype, self._kv_quantized = resolve_cache_dtype(kv_cache_dtype, self.cdt)
        if not self._kv_quantized and self._kv_buf_dtype != self.cdt:
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r} under compute dtype {self.cdt}: kernel B reads float caches "
                "in the compute dtype only (or use 'int8' / 'fp8')"
            )
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.decode_chunk = int(decode_chunk)
        self.max_prompt_len = int(max_prompt_len or (max_len - 1))
        if self.max_prompt_len >= self.max_len:
            raise ValueError("max_prompt_len must leave room to generate (< max_len)")
        self.device_criteria = tuple(device_criteria)
        self.stop_dead_rows = bool(stop_dead_rows)
        self.seed = int(seed)
        self.scheduler = Scheduler(self.n_slots, make_buckets(min_bucket, self.max_prompt_len), max_pending=max_queue)
        self._to_fill = measurements_to_fill(config)

        # Weights in the compute dtype, once: the model keeps fp32 for callers.
        self._model = copy.deepcopy(model).to(self.device).eval().cast_to_compute_dtype()
        self._stacked = stack_layer_weights(self._model.encoder.blocks(), self.cdt)
        self._windows = tuple(
            config.seq_window_size if t == "local" else 0 for t in config.seq_attention_layers
        )

        self._template = self._normalize_prompt(template)
        self._init_state()
        # Static inputs and outputs of the prefill and extraction programs,
        # by (kind, key); on the card, their captured programs by kind.
        self._statics: dict = {}
        self._program = None
        self._families: dict = {}
        if self.device.type == "cuda" and cuda_graph:
            pool = torch.cuda.graph_pool_handle()
            self._families = {kind: ProgramFamily(f"the {kind} program", device=self.device, pool=pool)
                              for kind in ("prefill", "extract")}  # fmt: skip
            # The chunk's program: captured now, while every slot is inactive,
            # so the warm-up writes nothing a request can see (every write of a
            # step is masked by ``active``, and admission replaces a slot's
            # cache rows whole).
            self._program = CapturedProgram(self._decode_chunk, "the decode chunk", device=self.device, pool=pool)
            with torch.inference_mode():
                self._program.warmup()
                self._program.capture()
        # Host slot table (slot -> Request) and each slot's admission epoch:
        # the dispatched-chunk count when its request was admitted. A boundary
        # issued at chunk c reflects that admission iff epoch < c.
        self._table: list[Optional[Request]] = [None] * self.n_slots
        self._slot_epoch: list[int] = [0] * self.n_slots
        self._dispatched_chunks = 0
        self._resolved_chunks = 0
        self._inflight: deque = deque()  # (chunk index, host boundary, CUDA event or None), in issue order
        self._health_quarantined = 0
        self._health_failed = 0
        self._health_retried = 0

    # ------------------------------------------------------------ state init
    def _normalize_prompt(self, batch: EventStreamBatch) -> EventStreamBatch:
        """The fields a slot row carries, 64-bit integers and floats in 32 bits."""
        out = EventStreamBatch(**{f: getattr(batch, f) for f in _CORE_FIELDS})
        for f in ("event_mask", "time_delta", "dynamic_indices"):
            if getattr(out, f) is None:
                raise ValueError(f"Engine prompts need `{f}`")
        if out.start_time is None:
            out = out.replace(start_time=torch.zeros(out.batch_size, dtype=torch.float32))
        return out.map(lambda x: x.to(X32.get(x.dtype, x.dtype)))

    def _init_state(self) -> None:
        S, L, t, dev = self.n_slots, self.max_len, self._template, self.device

        def rows(x, seq_axis):
            if x is None:
                return None
            shape = (S, L) + tuple(x.shape[2:]) if seq_axis else (S,) + tuple(x.shape[1:])
            return torch.empty(shape, dtype=x.dtype, device=dev)

        self.big = EventStreamBatch(
            event_mask=torch.empty(S, L, dtype=torch.bool, device=dev),
            time_delta=rows(t.time_delta, True),
            static_indices=rows(t.static_indices, False),
            static_measurement_indices=rows(t.static_measurement_indices, False),
            dynamic_indices=rows(t.dynamic_indices, True),
            dynamic_measurement_indices=rows(t.dynamic_measurement_indices, True),
            dynamic_values=rows(t.dynamic_values, True),
            dynamic_values_mask=rows(t.dynamic_values_mask, True),
            start_time=rows(t.start_time, False),
        )
        cfg = self.config
        shape = (cfg.num_hidden_layers, S, cfg.num_attention_heads, L, cfg.head_dim)
        self.key_cache = torch.empty(shape, dtype=self._kv_buf_dtype, device=dev)
        self.value_cache = torch.empty(shape, dtype=self._kv_buf_dtype, device=dev)
        self.key_scale = self.value_scale = None
        if self._kv_quantized:
            self.key_scale = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
            self.value_scale = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
        self.cache_mask = torch.empty(S, L, dtype=torch.bool, device=dev)
        self.cache_len, self.cursor, self.base_len, self.budget, self.n_generated = (
            torch.empty(S, dtype=torch.int32, device=dev) for _ in range(5)
        )
        self.done, self.live, self.health = (torch.empty(S, dtype=torch.bool, device=dev) for _ in range(3))
        # A request's seed and its stream's counter: the 32-bit words the
        # counter hash reads (JAX keeps a (2,) uint32 key a slot).
        self.seeds = torch.empty(S, dtype=torch.int32, device=dev)
        self.counters = torch.empty(S, dtype=torch.int32, device=dev)
        self.active_steps = torch.empty((), dtype=torch.int32, device=dev)
        self._boundary = torch.empty((5, S), dtype=torch.int32, device=dev)
        self._write_initial_state()

    def _write_initial_state(self) -> None:
        """Every state buffer to its initial value, in place (each keeps its
        address): empty rows, zero caches with unit scales (zero codes
        dequantize to zeros), every slot done and not live."""
        for x in vars(self.big).values():
            if torch.is_tensor(x):
                x.zero_()
        for x in (self.key_cache, self.value_cache):
            storage(x).zero_()
        for x in (self.key_scale, self.value_scale):
            if x is not None:
                x.fill_(1.0)
        for x in (self.cache_mask, self.cache_len, self.budget, self.n_generated, self.live, self.health,
                  self.seeds, self.counters, self.active_steps, self._boundary):  # fmt: skip
            x.zero_()
        self.cursor.fill_(1)
        self.base_len.fill_(1)
        self.done.fill_(True)

    # --------------------------------------------------------- device pieces
    def _categorical_sampler(self, active):
        def sampler(logits, stream):
            keep = topk_topp_mask(logits, self.top_k, self.top_p)
            return fused_categorical_stream(logits, stream, keep, active, fill=0)

        return sampler

    def _sample_rows(self, preds_last, em_last, seeds, counters, active=None):
        """Per-row draws (named heads, per-row streams) assembled into events."""
        if self.greedy:
            draws = sample_head_draws(preds_last, None, greedy=True)
        else:
            draws = sample_head_draws(
                preds_last, RowStreams(seeds, counters), categorical_sampler=self._categorical_sampler(active)
            )
        return assemble_event_sample(preds_last, draws, em_last)

    def _row_done(self, big, cursor, base_len, n_generated, budget):
        done = (cursor - base_len) >= budget
        kw = dict(big=big, cursor=cursor, base_len=base_len, n_generated=n_generated, budget=budget)
        if self.stop_dead_rows:
            done = done | DeadRowCriteria().row_done(**kw)
        for crit in self.device_criteria:
            done = done | crit.row_done(**kw)
        return done

    def _rows_nonfinite(self, preds_last, sample) -> torch.Tensor:
        """Per-slot any-non-finite over the float tensors of the step (the
        health sentinel's detector; row-local, no cross-slot op)."""
        leaves = []
        for group in (preds_last.classification, preds_last.regression):
            for pair in (group or {}).values():
                leaves += [t for d in pair if d is not None for t in dist_tensors(d)]
        if preds_last.time_to_event is not None:
            leaves += dist_tensors(preds_last.time_to_event)
        leaves += [sample.time_to_event] + list((sample.classification or {}).values())
        leaves += list((sample.regression or {}).values())
        bad = torch.zeros(self.n_slots, dtype=torch.bool, device=self.device)
        for x in leaves:
            if x is not None and x.is_floating_point() and x.ndim >= 1 and x.shape[0] == self.n_slots:
                bad = bad | ~torch.isfinite(x.reshape(self.n_slots, -1)).all(dim=1)
        return bad

    def _decode_step(self, st: dict, seeds: torch.Tensor) -> dict:
        """One event for every active slot of state ``st`` (`_CHUNK_STATE`,
        the counters in int64) with the slots' seeds in int64; returns the
        next state. Inactive slots keep theirs."""
        cfg, m = self.config, self._model
        active = self.live & ~st["done"]
        view = _trim_to_event(self.big, st["cursor"] - 1)
        h0 = m.encoder.input_layer(view)[:, 0]
        h, _, _, _, _, cache_mask, cache_len = decode_stack_step(
            self._stacked, self.key_cache, self.value_cache, h0, st["cache_len"],
            view.event_mask[:, 0], st["cache_mask"], windows=self._windows,
            activation=cfg.activation_function, layer_norm_eps=float(cfg.layer_norm_epsilon), active=active,
            key_scale=self.key_scale, value_scale=self.value_scale,
        )  # fmt: skip
        encoded = m.encoder.ln_f(h[:, None, :])
        out = m.output_layer(view, encoded, is_generation=True)
        preds_last = _slice_preds_at(out.preds, 0)
        em_last = take_event(self.big.event_mask, st["cursor"] - 1)
        sample = self._sample_rows(preds_last, em_last, seeds, st["counters"], active=active)
        append_new_event(self.big, sample, st["cursor"], active)
        update_last_event_data(self.big, sample, cfg, st["cursor"] + 1, self._to_fill, active)

        cursor = torch.where(active, st["cursor"] + 1, st["cursor"])
        n_generated = st["n_generated"] + (active & sample.event_mask).to(torch.int32)
        done = st["done"] | (active & self._row_done(self.big, cursor, self.base_len, n_generated, self.budget))
        health = st["health"]
        if self.health_sentinel:
            hit = active & self._rows_nonfinite(preds_last, sample)
            done, health = done | hit, health | hit
        return dict(
            cursor=cursor,
            n_generated=n_generated,
            counters=torch.where(active, st["counters"] + 1, st["counters"]),
            done=done,
            health=health,
            active_steps=st["active_steps"] + active.sum(),
            cache_mask=cache_mask,
            cache_len=cache_len,
        )

    def _decode_chunk(self) -> None:
        """The decode chunk (JAX's ``_decode_chunk_ci``): ``decode_chunk``
        steps from the engine's state buffers, the final state copied back
        into them and the packed ``(5, n_slots)`` boundary (done, cursor,
        base_len, n_generated, health) written into its buffer. Every tensor
        it reads or writes outside its temporaries keeps its address for the
        engine's life: on the card this is the program captured once and
        replayed per chunk; on the CPU it runs as it is. The stream words are
        cast to int64 once a chunk, where the hash and kernel A take them."""
        st = {k: getattr(self, k) for k in _CHUNK_STATE}
        st["counters"] = self.counters.long()
        seeds = self.seeds.long()
        for _ in range(self.decode_chunk):
            st = self._decode_step(st, seeds)
        for k in _CHUNK_STATE:
            getattr(self, k).copy_(st[k])
        torch.stack(
            [self.done.to(torch.int32), self.cursor, self.base_len, self.n_generated, self.health.to(torch.int32)],
            out=self._boundary,
        )

    # ------------------------------------------------ prefill and extraction
    def _run_program(self, kind: str, key, inputs: dict, outputs: dict, body, fill, inert) -> tuple:
        """Runs the ``kind`` program of ``key``: ``body(x)``, where ``x`` holds
        its static inputs and outputs, views of two device buffers laid out
        by ``inputs`` and ``outputs`` (`ByteLayout`s made at the key's first
        use). ``fill(views)`` first writes this call's inputs into a staging
        buffer (pinned on the card, zeroed) that one copy moves to the
        device. Eager on the CPU or with ``cuda_graph=False``; else one
        replay of the key's captured program, which its first use warms up
        on inputs that ``inert`` wrote (every row inert) and captures.
        Returns the outputs' ``(layout, buffer)``."""
        if (kind, key) not in self._statics:
            layout, out_layout = ByteLayout(inputs), ByteLayout(outputs)
            buf, out_buf = layout.empty(self.device), out_layout.empty(self.device)
            x = {**layout.views(buf), **out_layout.views(out_buf)}
            self._statics[(kind, key)] = layout, buf, out_layout, out_buf, x
        layout, buf, out_layout, out_buf, x = self._statics[(kind, key)]

        def upload(write):
            host = layout.empty("cpu", pin_memory=buf.is_cuda).zero_()
            write(layout.views(host))
            buf.copy_(host, non_blocking=buf.is_cuda)

        family = self._families.get(kind)
        if family is None:
            upload(fill)
            body(x)
            return out_layout, out_buf
        program, new = family.get(key, lambda: body(x))
        if new:
            upload(inert)
            program.warmup()
            program.capture()
        upload(fill)
        program.replay()
        return out_layout, out_buf

    def _request_seed(self, req: Request) -> int:
        return int(req.key) if req.key is not None else derive_request_seed(self.seed, req.admission_index)

    def _stage_prompt(self, x: dict, i: int, prompt: EventStreamBatch) -> None:
        """Request row ``i`` of a staged group: its prompt, zeros after it."""
        p = self._normalize_prompt(prompt)
        if p.batch_size != 1:
            raise ValueError("Requests hold one-row prompts; split cohorts first")
        if p.n_data_elements != self._template.n_data_elements:
            raise ValueError(
                f"Prompt data-element width {p.n_data_elements} != engine width {self._template.n_data_elements}"
            )
        n = p.sequence_length
        if n > self.max_len:
            raise ValueError(f"Prompt of {n} events exceeds max_len={self.max_len}")
        for f in _CORE_FIELDS:
            src = getattr(p, f)
            if f in x and src is not None:
                if f in _SEQ_FIELDS:
                    x[f][i, :n] = src[0]
                else:
                    x[f][i] = src[0]

    def _dispatch_group(self, group) -> None:
        """Bucketed prefill forward + first-event sample + admission into the
        slots: one prefill program of key (bucket, group width), its group
        padded to the width as JAX's ``_group_arrays`` pads it, with inert
        rows (no content, ``plen`` 1, budget 1, seed 0). The pad rows are
        aimed at distinct slots outside the group, whose contents the
        admission writes back unchanged (`_admit_rows`)."""
        reqs, n, g = group.requests, len(group.requests), group.group_size
        taken = set(group.slots)
        slots = list(group.slots) + [s for s in range(self.n_slots) if s not in taken][: g - n]
        fields = {f: ((g,) + tuple(getattr(self.big, f).shape[1:]), getattr(self.big, f).dtype)
                  for f in _CORE_FIELDS if getattr(self.big, f) is not None}  # fmt: skip
        fields.update({k: ((g,), torch.int32) for k in ("plen", "budget", "seed", "slot")})
        fields["valid"] = ((g,), torch.bool)

        def inert(x):
            x["plen"].fill_(1)
            x["budget"].fill_(1)
            x["slot"].copy_(torch.arange(g))

        def fill(x):
            inert(x)
            for i, r in enumerate(reqs):
                self._stage_prompt(x, i, r.prompt)
            x["plen"][:n] = torch.tensor([r.prompt_len for r in reqs])
            x["budget"][:n] = torch.tensor([r.max_new_events for r in reqs])
            x["seed"][:n] = torch.tensor([_int32_word(self._request_seed(r)) for r in reqs])
            x["slot"].copy_(torch.tensor(slots))
            x["valid"][:n] = True

        body = lambda x: self._prefill_admit(group.bucket_len, x)  # noqa: E731
        self._run_program("prefill", (group.bucket_len, g), fields, {}, body, fill, inert)
        for r, s in zip(reqs, group.slots):
            self._table[s] = r
            self._slot_epoch[s] = self._dispatched_chunks

    def _prefill_admit(self, bucket_len: int, x: dict) -> None:
        """The prefill program (JAX's ``_prefill_ci``: ``_prefill_forward_ci``
        then ``_admit``) on the staged group ``x``: the model forward of the
        rows' first ``bucket_len`` events on a fresh float cache, the first
        event sampled (counter 0 of each row's stream) and written after each
        prompt, and the rows admitted into slots ``x["slot"]``: whole rows,
        KV planes (quantized for an int8 or fp8 cache), mask, cursors,
        budget, seed and counter, flags. Rows not ``x["valid"]`` write back
        what their slots hold. The staged rows are written in place."""
        cfg, g = self.config, x["plen"].shape[0]
        pbig = EventStreamBatch(**{f: x.get(f) for f in _CORE_FIELDS})
        plen, budget = x["plen"], x["budget"]
        plen64, seeds = plen.long(), x["seed"].long()
        view = pbig.slice((slice(None), slice(0, bucket_len)))
        out = self._model(view, past=init_kv_caches(cfg, g, self.max_len, self.device), use_cache=True)
        preds_last = _slice_preds_at(out.preds, plen64 - 1)
        em_last = take_event(pbig.event_mask, plen64 - 1)
        sample = self._sample_rows(preds_last, em_last, seeds, torch.zeros_like(seeds))
        append_new_event(pbig, sample, plen64)
        update_last_event_data(pbig, sample, cfg, plen64 + 1, self._to_fill)

        # Admission: whole rows into the slots (cache rows past the bucket are zeros).
        slots, valid = x["slot"].long(), x["valid"]
        for f in _CORE_FIELDS:
            if f in x:
                _admit_rows(getattr(self.big, f), x[f], slots, valid)
        for plane, scale, which in ((self.key_cache, self.key_scale, "key"), (self.value_cache, self.value_scale, "value")):
            rows_kv = torch.stack([getattr(c, which) for c in out.past_key_values])
            if scale is not None:  # quantize on admission: the prefill ran on float caches
                rows_kv, rows_scale = quantize_kv(rows_kv, plane.dtype)
                _admit_rows(scale, rows_scale, slots, valid, dim=1)
            _admit_rows(storage(plane), storage(rows_kv), slots, valid, dim=1)
        cursor1 = plen + 1
        n_gen1 = sample.event_mask.to(torch.int32)
        admitted = (
            (self.cache_mask, out.past_key_values[0].mask),
            (self.cache_len, plen),
            (self.cursor, cursor1),
            (self.base_len, plen),
            (self.budget, budget),
            (self.n_generated, n_gen1),
            (self.done, self._row_done(pbig, cursor1, plen, n_gen1, budget)),
            (self.live, True),
            (self.seeds, x["seed"]),
            (self.counters, 1),
            (self.health, False),
        )
        for dst, src in admitted:
            _admit_rows(dst, src, slots, valid)

    def _extract(self, x: dict) -> None:
        """The extraction program (JAX's ``_extract_jit``): the rows of slots
        ``x["slot"]`` with the event mask cut at each cursor
        (`_mask_through_cursor`), and their cursor, base_len and
        n_generated, written into the static outputs of ``x``."""
        slots = x["slot"].long()
        cursor = self.cursor.index_select(0, slots)
        for f in _CORE_FIELDS:
            if f in x:
                torch.index_select(getattr(self.big, f), 0, slots, out=x[f])
        x["event_mask"].copy_(_mask_through_cursor(EventStreamBatch(event_mask=x["event_mask"]), cursor).event_mask)
        x["cursor"].copy_(cursor)
        torch.index_select(self.base_len, 0, slots, out=x["base_len"])
        torch.index_select(self.n_generated, 0, slots, out=x["n_generated"])

    def _fetch_rows(self, fetch_slots: list[int]) -> tuple[dict, dict]:
        """The finished rows of ``fetch_slots`` through the extraction program
        of their group width (padded with slot 0), copied to the host once:
        ``({slot: one-row CPU batch trimmed to its events}, {slot: (cursor,
        base_len, n_generated)})``."""
        g = self.scheduler.group_size_for(len(fetch_slots))
        fields = {f: ((g,) + tuple(getattr(self.big, f).shape[1:]), getattr(self.big, f).dtype)
                  for f in _CORE_FIELDS if getattr(self.big, f) is not None}  # fmt: skip
        fields.update({k: ((g,), torch.int32) for k in ("cursor", "base_len", "n_generated")})

        def fill(x):
            x["slot"][: len(fetch_slots)] = torch.tensor(fetch_slots)

        inputs = {"slot": ((g,), torch.int32)}
        layout, buf = self._run_program("extract", g, inputs, fields, self._extract, fill, inert=lambda x: None)
        host = buf
        if buf.is_cuda:
            host = layout.empty("cpu", pin_memory=True)
            host.copy_(buf)
        h = layout.views(host)
        rows = EventStreamBatch(**{f: h.get(f) for f in _CORE_FIELDS})
        acct, fetched = {}, {}
        for i, s in enumerate(fetch_slots):
            acct[s] = (int(h["cursor"][i]), int(h["base_len"][i]), int(h["n_generated"][i]))
            fetched[s] = rows.slice((slice(i, i + 1), slice(0, acct[s][0]))).map(torch.clone)
        return fetched, acct

    # ---------------------------------------------------------- host pieces
    def _harvest(
        self, boundary: np.ndarray, chunk_index: int, now: float, fetch_results: bool = True
    ) -> list[EngineResult]:
        """Harvests slots whose request finished (rows: done, cursor, base_len,
        n_generated, health), admitted before chunk ``chunk_index`` was
        issued. A quarantined slot's request is requeued at the front with
        its seed fixed while its retry budget lasts, else fails typed. The
        finished rows come through the extraction program (`_fetch_rows`);
        with ``fetch_results=False`` nothing more is read than the boundary
        (results carry ``batch=None`` and the boundary's accounting)."""
        done_np, health_np = boundary[0].astype(bool), boundary[4].astype(bool)
        finished = [
            s for s in range(self.n_slots)
            if self._table[s] is not None and done_np[s] and self._slot_epoch[s] < chunk_index
        ]  # fmt: skip
        kept = []
        for s in finished:
            req = self._table[s]
            if health_np[s] and self.health_sentinel and req.health_retries < self.health_retries:
                self._health_quarantined += 1
                self._health_retried += 1
                self._table[s] = None
                req.key = self._request_seed(req)  # the retry keeps the stream of its admission index
                req.health_retries += 1
                self.scheduler.requeue_front(req)
            else:
                kept.append(s)
        finished = kept
        if not finished:
            return []
        ok_slots = [s for s in finished if not (health_np[s] and self.health_sentinel)]
        fetched, acct = self._fetch_rows(ok_slots) if fetch_results and ok_slots else ({}, {})
        results = []
        for s in finished:
            req = self._table[s]
            self._table[s] = None
            n_events, prompt_len, n_gen = acct.get(s, (int(boundary[1][s]), int(boundary[2][s]), int(boundary[3][s])))
            row, error = fetched.get(s), None
            if s not in ok_slots:
                self._health_quarantined += 1
                self._health_failed += 1
                error = SlotHealthError(
                    f"non-finite logits/values detected in decode slot {s} (request {req.request_id!r}, "
                    f"admission index {req.admission_index}); the slot was quarantined at chunk "
                    f"{chunk_index} and its co-residents are untouched",
                    request_id=req.request_id, admission_index=req.admission_index, slot=s,
                    chunk_index=chunk_index,
                )  # fmt: skip
            results.append(
                EngineResult(
                    request_id=req.request_id,
                    admission_index=req.admission_index,
                    batch=row,
                    prompt_len=prompt_len,
                    n_events=n_events,
                    n_generated=n_gen,
                    completion_time=now,
                    error=error,
                )
            )
        return results

    def submit(self, request: Request) -> Request:
        if request.max_new_events < 1:
            raise ValueError("max_new_events must be >= 1")
        if request.prompt_len + request.max_new_events > self.max_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + budget ({request.max_new_events}) exceeds max_len ({self.max_len})"
            )
        if self.validate_prompts and not request.prompt_validated:
            reason = check_prompt_finite(request.prompt)
            if reason is not None:
                self.scheduler.note_malformed_reject()
                raise MalformedPromptRejected(f"request {request.request_id!r}: {reason} — rejected at the door")
        return self.scheduler.submit(request)

    def fork(self, *args, **kwargs):
        raise ValueError("fork() needs the paged KV cache, which is not part of the PyTorch port yet")

    @property
    def occupied(self) -> int:
        return sum(t is not None for t in self._table)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if self._table[s] is None]

    @torch.inference_mode()
    def plan_and_dispatch(self, now: float | None = None, max_padded_events: int | None = None) -> int:
        free = self.free_slots()
        if not free or not self.scheduler.pending:
            return 0
        groups = self.scheduler.plan_admissions(free, now=now, max_padded_events=max_padded_events)
        for g in groups:
            self._dispatch_group(g)
        return sum(len(g.requests) for g in groups)

    @property
    def inflight_chunks(self) -> int:
        """Decode chunks issued whose boundary has not been resolved."""
        return len(self._inflight)

    @torch.inference_mode()
    def issue_chunk(self) -> None:
        """Runs one decode chunk (a replay of its captured program on the
        card) and starts its packed boundary's copy to the host (pinned
        memory, ``non_blocking``, an event behind it on the card); nothing
        waits for the device."""
        if self._program is not None:
            self._program.replay()
        else:
            self._decode_chunk()
        self._dispatched_chunks += 1
        event = None
        if self._boundary.is_cuda:
            host = torch.empty(self._boundary.shape, dtype=self._boundary.dtype, pin_memory=True)
            host.copy_(self._boundary, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:  # the next chunk rewrites the buffer
            host = self._boundary.clone()
        self._inflight.append((self._dispatched_chunks, host, event))

    @torch.inference_mode()
    def resolve_chunk(self, now: float, fetch_results: bool = True) -> list[EngineResult]:
        """Resolves the OLDEST in-flight boundary and harvests its finished
        rows; waits only until that boundary's copy has landed (and, fetching
        results, for the rows' extraction)."""
        chunk_index, host, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        self._resolved_chunks += 1
        return self._harvest(host.numpy(), chunk_index, now, fetch_results)

    def run(
        self, requests: Sequence[Request] = (), *, use_arrival_times: bool = False, fetch_results: bool = True,
        max_padded_events: int | None = None,
    ) -> list[EngineResult]:  # fmt: skip
        """Drains the queue (plus ``requests``) to completion; results in
        admission order. Up to ``dispatch_depth`` chunks are issued before the
        oldest boundary is resolved. ``fetch_results=False`` reads no row
        content (the accounting-only harvest of throughput benchmarks)."""
        for r in requests:
            self.submit(r)
        results: list[EngineResult] = []
        t0 = time.perf_counter()
        while self.scheduler.pending or self.occupied or self._inflight:
            now = time.perf_counter() - t0
            self.plan_and_dispatch(now=now if use_arrival_times else None, max_padded_events=max_padded_events)
            if self.occupied:
                self.issue_chunk()
                if len(self._inflight) < self.dispatch_depth and self.occupied:
                    continue  # keep the pipe full before paying a resolve
            if self._inflight:
                results.extend(self.resolve_chunk(time.perf_counter() - t0, fetch_results))
            elif self.scheduler.pending:
                time.sleep(1e-3)  # waiting on arrivals
        return sorted(results, key=lambda r: r.admission_index)

    def reset(self) -> None:
        """Clears every slot, the queue and the counters of a run, keeping
        every program (JAX's ``reset``): benchmarks warm the programs with one
        run, reset, and time the next. The state buffers are written back to
        their initial values in place, so each captured program stays valid;
        the scheduler is rebuilt with its buckets, group sizes and queue
        bound. Program captures and replays count over the engine's life."""
        self._write_initial_state()
        self._table = [None] * self.n_slots
        self._slot_epoch = [0] * self.n_slots
        self._dispatched_chunks = 0
        self._resolved_chunks = 0
        self._health_quarantined = 0
        self._health_failed = 0
        self._health_retried = 0
        self._inflight.clear()
        self.scheduler = Scheduler(
            self.n_slots, self.scheduler.buckets, group_sizes=self.scheduler.group_sizes,
            max_pending=self.scheduler.max_pending,
        )  # fmt: skip

    def slots_report(self, hbm_gb: float | None = None) -> dict:
        """Device-memory capacity of each cache dtype (`ops.kv_quant.CACHE_DTYPES`),
        allocating nothing: the sequence-cache bytes a slot pins at ``max_len``
        (planes, scale tables, mask) and the most slots that fit a budget of
        ``hbm_gb`` GB net of the engine's resident weights (the model in the
        compute dtype and the stacked layer weights kernel B reads) and each
        slot's other state (content rows, cursors, streams), as the JAX
        engine's `slots_report` counts them. ``hbm_gb`` defaults to the engine
        device's own memory; on the CPU it must be given."""
        if hbm_gb is None:
            if self.device.type != "cuda":
                raise ValueError("slots_report: pass hbm_gb for an engine that is not on a CUDA device")
            hbm_gb = torch.cuda.get_device_properties(self.device).total_memory / 1e9
        cfg = self.config
        rest = [getattr(self.big, f) for f in _CORE_FIELDS]
        rest += [self.cursor, self.base_len, self.budget, self.n_generated, self.done, self.live, self.health,
                 self.seeds, self.counters, self.active_steps]  # fmt: skip
        row_bytes = max(sum(t.numel() * t.element_size() for t in rest if t is not None) // self.n_slots, 1)
        resident = list(self._model.parameters()) + list(self._model.buffers()) + list(self._stacked.values())
        params_bytes = sum(t.numel() * t.element_size() for t in resident)
        budget = max(int(hbm_gb * 1e9) - params_bytes, 0)
        per_dtype = {}
        for name in CACHE_DTYPES:
            kv = kv_cache_bytes_per_slot(cfg.num_hidden_layers, cfg.num_attention_heads, self.max_len, cfg.head_dim,
                                         name, cfg.compute_dtype)  # fmt: skip
            per_dtype[name] = {"kv_bytes_per_slot": kv, "max_slots": int(budget // (kv + row_bytes))}
        active = cache_dtype_name(self._kv_buf_dtype)
        return {
            "kv_cache_dtype": active,
            "hbm_budget_gb": hbm_gb,
            "params_bytes": params_bytes,
            "row_bytes_per_slot": row_bytes,
            "per_dtype": per_dtype,
            "slots_per_chip_ratio_vs_bf16": round(
                per_dtype[active]["max_slots"] / max(per_dtype["bf16"]["max_slots"], 1), 3
            ),
        }

    def program_stats(self) -> dict:
        """Captures and replays of the engine's programs: ``graph_*`` the
        decode chunk's, ``prefill_*`` and ``extract_*`` those of the prefill
        (bucket, group width) and extraction (group width) keys, with the
        keys' count (zeros when nothing is captured)."""
        out = {
            "cuda_graph": self._program is not None,
            "graph_warmup_chunks": 0 if self._program is None else self._program.warmups,
            "graph_captures": 0 if self._program is None else self._program.captures,
            "graph_replays": 0 if self._program is None else self._program.replays,
        }
        for kind in ("prefill", "extract"):
            family = self._families.get(kind)
            counts = family.counts() if family else dict.fromkeys(("keys", "warmups", "captures", "replays"), 0)
            out.update({f"{kind}_graph_{k}": v for k, v in counts.items()})
        return out

    def stats(self) -> dict:
        total = self._dispatched_chunks * self.decode_chunk * self.n_slots
        active = int(self.active_steps.item())
        report = dict(self.scheduler.padding_report())
        report.update(
            {
                "n_slots": self.n_slots,
                "decode_chunk": self.decode_chunk,
                "dispatch_depth": self.dispatch_depth,
                "dispatched_chunks": self._dispatched_chunks,
                "resolved_chunks": self._resolved_chunks,
                "slot_steps": total,
                "active_slot_steps": active,
                "wasted_decode_frac": round(1.0 - active / max(total, 1), 4),
                "sampling_impl": "greedy" if self.greedy else "fused_categorical",
                "decode_step_impl": "decode_stack_step",
                **self.program_stats(),
                "device": str(self.device),
                "greedy": self.greedy,
                "health_sentinel": self.health_sentinel,
                "health_quarantined_total": self._health_quarantined,
                "health_failed_total": self._health_failed,
                "health_retried_total": self._health_retried,
                "kv_cache_dtype": cache_dtype_name(self._kv_buf_dtype),
                "kv_cache_bytes": sum(
                    t.numel() * t.element_size()
                    for t in (self.key_cache, self.value_cache, self.key_scale, self.value_scale)
                    if t is not None
                ),
                # At the card's memory; off the card at the JAX engine's default budget.
                "slots_report": self.slots_report(None if self.device.type == "cuda" else _REPORT_HBM_GB),
            }
        )
        return report
