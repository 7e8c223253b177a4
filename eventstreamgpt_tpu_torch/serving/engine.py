"""Continuous-batching generation engine for CI and NA models: slot-based decode.

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
buffer updates. ``decode_step_impl="xla"`` (and every paged engine) runs
the JAX engine's unfused step instead: the model's cached one-event
forward (`models.transformer`'s per-row-cursor branch), whose new cache
rows are merged where a slot is active, with kernel A still sampling. On
CPU tensors both kernels take their plain PyTorch versions. Prefill runs
the model forward on a fresh float cache at the bucket width for a group of
requests padded, as the JAX engine pads it, to the scheduler's group width
with inert rows, and admits the real rows into their slots. With
``kv_cache_dtype`` "int8" or "fp8" the slot caches hold codes and
per-head-per-position fp32 scales (`ops.kv_quant`): the prefill's cache is
quantized whole at admission, each new key and value at the cursor, and
what is read is dequantized.

Paged cache (``paged_kv=True``, JAX's copy-on-write block pool): the
keys and values live in one pool of ``num_blocks`` blocks of
``block_size`` positions a layer (`models.transformer.PagedKVCache`; block
0 is the zero block every unallocated table entry reads), each slot holds
a block table on the device, and the host's `BlockAllocator` owns which
blocks are free, shared or held, with the tables mirrored in numpy. An
admission plans its rows' blocks on the host (a slot's previous blocks are
freed only then, since a finished row keeps writing at its frozen cursor)
and its program scatters the prefill's cache into them and writes the
tables in place. `GenerationEngine.fork` admits one prompt as
``n_branches`` branches that share its whole blocks: the group runs the
prefill program as a group of ``n_branches`` independent submissions of the
prompt would (so each branch equals one bit for bit), each branch samples
its first event on its own seed, and the scatter table lands the prompt's
whole blocks once, from branch 0. Kernel B does not read the pool (as in
JAX): a paged engine decodes through the unfused step.

Index planes are held in int32 and floats in fp32, whatever the template
and prompts hold, as the JAX package (x64 off) holds them; request seeds
and stream counters are int32 words (the counter hash reads 32 bits of
each), cast to int64 once a program where kernel A and the hash take them.

The engine runs three kinds of program, each the counterpart of a jitted
JAX program: the decode chunk (JAX's ``_decode_chunk_ci`` behind
``_decode_jit``), the prefill-and-admit program of a (bucket, group width)
key (``_prefill_jit``: `GenerationEngine._prefill_admit`) and the
harvest's extraction at a group width (``_extract_jit``:
`GenerationEngine._extract`); behind a prefill stream, that program's two
halves instead (``_prefill_compute_jit`` and ``_admit_jit``: the
``prefill_compute`` program of a (bucket, group width) key on the prefill
engine, the ``admit`` program of a group width on the decode engine, which
reads its handoff from a device buffer). Each reads its static inputs from one buffer
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

Nested-attention (NA) models (JAX's default NA path): every decode step is
the unfused one, an event's whole dep-graph level walk (JAX's
``_decode_step_na``): the target-0 forward of the last event through the
sequence caches (merged where a slot is active, as for CI) and the
dep-graph caches, level 0 (the time) drawn and the event appended, then
levels 1 .. G-1 (``G = len(measurements_per_dep_graph_level)``), each a
one-element forward against the dep-graph caches alone that draws its
level's heads and fills its measurements in. The dep-graph caches are one
``(layers, slots, heads, G + 1, head_dim)`` plane pair in the compute dtype
under every ``kv_cache_dtype`` with a ``(slots, G + 1)`` mask; their length
is G at every step boundary, a Python int in the programs, and they are
taken whole after each step (a finished slot's rows hold inert values that
its next admission overwrites). The prefill runs the bucket's forward with
``last_event_index = plen - 1``, so a bucket-padded prompt seeds each row's
dep-graph history from its last real event, then draws level 0 and walks
the levels before admission. Event ``j`` of a request draws level ``l`` from
stream counter ``j * G + l``. Kernel B and the paged cache are refused for
NA models, as JAX refuses them.

Speculative decoding (``spec=SpecConfig(...)``, `serving.spec`, JAX's spec
mode for CI models): a draft model (`serving.spec.truncated_draft` cuts one
from the target) holds its own per-slot cache beside the target's. Each
round runs ``spec.k`` draft steps (the draft's cached one-event forward, its
proposals written into the slot rows beyond the cursor), then ONE target
forward over the ``k + 1``-event window from the last committed event (the
per-row-cursor cache's range write) scores every proposal, the accept walk
(`serving.spec.spec_accept_level`) commits the accepted prefix plus one
correction or bonus event, and both caches' lengths roll back to the new
cursor, without copies. A spec chunk is ``decode_chunk`` rounds in one
program; its boundary ``(7, n_slots)`` adds each slot's proposed and
accepted counts. Each event ``j`` draws from the addressed stream
``RowStreams(seed, j)``; kernel A samples every categorical head of the
draft, the target, the bonus event and the residuals. As in JAX the spec
engine runs both forwards unfused (kernel B never launches) and refuses the
paged cache, the megakernel and custom device criteria.

On an NA model (JAX's ``_spec_draft_chunk_na`` and ``_spec_verify_na``)
each draft step is a whole event, the draft's target-0 forward and level
walk, every level's draws recorded; the one target forward over the window
is teacher-forced (``partial_content_levels``: slot ``l`` embedded from the
event's levels ``<= l``, as the walk wrote it) and starts from the carried
history heads (each layer's contextualized embedding of the event before
the window), so it scores every level of every proposal as the sequential
walk would. The accept walk runs level by level; the first rejected event's
first rejected level is the break: the levels below it commit the draft's
content, the breaking level its residual, and a correction walk (a
one-event re-contextualize forward, then the levels above the break) the
rest. Level ``l`` of event ``j`` draws from stream counter ``j * G + l``
(`serving.spec.level_streams`), the non-speculative NA engine's address.
Two repairs of JAX's NA spec state (ROADMAP Queue 3): the draft writes its
last proposal's sequence-cache entry and its dep-graph caches are rebuilt
for the last committed event each round (JAX's keep the walk of its last
proposal), so a perfect draft stays accepted; and the correction walk masks
each level's input to the levels below it, as the sequential walk saw the
event, so the levels above a break are drawn from the sequential law.

Hot swap (``hot_swap=True``, JAX's double-buffered weights): `load_shadow`
stages a checkpoint's ``state_dict`` (and a spec engine's draft's) in a
shadow copy of the model in the compute dtype, with its own stacked layer
weights for kernel B; `probe_shadow` runs the prefill forward on the shadow
eagerly and reports the first non-finite output; `flip`, on a drained
engine, exchanges the contents of every live tensor with its shadow's in
place, one tensor at a time through one scratch buffer on the engine's
stream. No live tensor moves, so every captured program keeps its
addresses and replays on the new weights with no capture; a second `flip`
is the rollback. A hot-swap spec engine gives its draft its own storage, so
a target-only flip leaves the live draft as it was.

The dedicated prefill stream's two halves (JAX's ``prefill_compute`` and
``admit_prefilled``): `prefill_compute` runs a group's bucketed prefill
forward and first-event draw on this engine with no slot scatter (a spec
engine's draft prompt forward, an NA engine's level walks and history heads
too) and returns a `PrefillHandoff` that owns a device copy of the outputs;
a decode engine's `admit_prefilled` runs the scatter alone. Together they
give the slot state of a local prefill. On the card each half is a captured
program keyed as the local prefill is.

Not ported yet, a ``ValueError`` at construction: meshes and tensor
parallelism. Functional-time-dependent measurements are generated as in
JAX: `generation.sampling.append_new_event` writes each new event's functor
elements, reading the slot's ``start_time``.
"""

from __future__ import annotations

import copy
import dataclasses
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
    derive_request_seed,
    measurements_to_fill,
    sample_head_draws,
    update_last_event_data,
)
from ..generation.stopping_criteria import DeadRowCriteria, DeviceCriterion
from ..models.config import StructuredEventProcessingMode, StructuredTransformerConfig
from ..models.model_output import GenerativeSequenceModelPredictions
from ..models.na_model import level_measurements
from ..models.transformer import (
    KVCache,
    NAPast,
    PagedKVCache,
    init_kv_caches,
    mask_batch_to_levels,
    na_level_of_measurement,
    paged_kv_bytes_per_block,
    time_from_deltas,
)
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
from ..reliability import serving_faults as _sfaults
from ..utils.device import resolve_device
from ..utils.graphs import ByteLayout, CapturedProgram, ProgramFamily
from .errors import BlockLedgerError, MalformedPromptRejected, SlotHealthError
from .spec import SpecConfig, event_streams, level_streams, select_candidate, spec_accept_level
from .scheduler import (
    AdmissionRejected,
    EngineResult,
    ForkSpec,
    Request,
    Scheduler,
    check_prompt_finite,
    make_buckets,
)

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
# A spec chunk's (its rounds address their streams by event index: no counters).
_SPEC_STATE = ("cursor", "n_generated", "done", "health", "active_steps", "cache_mask", "cache_len",
               "draft_cache_mask", "draft_cache_len", "spec_proposed", "spec_accepted", "spec_rounds")  # fmt: skip
# The engine's program kinds besides the decode chunk, each a family keyed by shape.
_PROGRAM_KINDS = ("prefill", "extract", "prefill_compute", "admit")
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
    "base_key": None,  # the port's engine takes an integer ``seed``
}
# The JAX engine's implementation knobs: name -> (the values whose function the
# port computes, what any other value asks for that the port lacks).
_IMPL_KNOBS = {
    "sampling_impl": (
        (None, "auto", "pallas"),
        "the categorical heads sample through kernel A (the fused filter and draw) only; the per-op tail "
        "('multi_op'), the fused XLA tail and interpret mode are not part of the PyTorch port",
    ),
    "decode_step_impl": (
        (None, "auto", "pallas", "xla"),
        "the decode step runs the layer stack through kernel B (the decode megakernel) or the unfused model "
        "step ('xla'); interpret mode is not part of the PyTorch port",
    ),
}
# JAX's refusals (its words, without its tracking notes): the megakernel on a
# paged engine, and speculative decoding with custom criteria, a paged cache
# or the megakernel.
_PAGED_MEGAKERNEL = (
    "the decode megakernel reads the monolithic (B, H, M, D) cache planes; the paged pool's block-table "
    "indirection is not fused yet. Nearest supported configurations: monolithic caches "
    "(kv_cache_dtype='int8' composes), or paged_kv with decode_step_impl='xla'"
)
_SPEC_CRITERIA = (
    "speculative decoding supports the built-in per-row stops (budget, dead rows, max length via budget) only; "
    "custom device_criteria cannot be re-evaluated per committed prefix inside the verify program"
)
_PAGED_SPEC = (
    "paged KV cache does not compose with speculative decoding yet: the verify window re-reads freshly written "
    "positions through the draft/target cache pair, which still admits monolithically. Nearest supported "
    "configurations: spec with monolithic caches (kv_cache_dtype='int8' composes), or paged_kv without spec "
    "(fork() branched rollouts)"
)
# JAX's refusals of a nested-attention engine (its words, without its
# tracking notes): the megakernel and the paged cache.
_NA_MEGAKERNEL = (
    "the decode megakernel fuses the CI one-event step only; nested-attention decode walks the per-event dep-graph "
    "levels through their own fused kernels (ops/pallas_dep_graph.py) and does not route through it. Nearest "
    "supported configuration: CI engines with decode_step_impl set, or NA engines with decode_step_impl='xla'"
)
_NA_PAGED = (
    "paged KV cache does not support nested-attention models yet: the dep-graph caches reset per event and do not "
    "page; run NA engines with paged_kv=False"
)
# JAX's refusal of NA speculative decoding over a scan_layers model (its words).
_NA_SPEC_SCAN = (
    "NA speculative decoding requires the unrolled layer stack (the verify pass threads per-layer history heads); "
    "migrate the checkpoint with unstack_layer_params"
)
# JAX's refusals of the prefill stream on a paged engine (its words).
_PAGED_STREAM = (
    "paged engines do not serve behind a dedicated prefill stream yet: the handoff admit would need the decode "
    "replica's block tables planned at compute time; prefill locally (the paged admit is a block scatter either way)"
)
_PAGED_HANDOFF = "paged engines do not take prefill-stream handoffs (see prefill_compute)"
_SPEC_MEGAKERNEL = (
    "speculative decoding replaces the decode step with the draft-chunk/verify program pair, which the megakernel "
    "does not fuse yet. Nearest supported configurations: spec with decode_step_impl='xla' (the fused sampling "
    "tail still applies), or the megakernel without spec"
)


def _int32_word(v: int) -> int:
    """The low 32 bits of ``v`` as a signed int32 value (the word the counter hash reads)."""
    v &= M32
    return v - (1 << 32) if v >= 1 << 31 else v


class BlockAllocator:
    """Host-side reference-counted free list over the device block pool
    (JAX's `BlockAllocator`, plain Python, never on the device).

    Block 0 is the zero block: never allocated, every unused table entry
    points at it. Freeing is deferred: a slot's blocks are released when the
    slot is re-admitted (or at `GenerationEngine.reset`), never at harvest,
    because a finished row keeps writing at its frozen cursor until then.
    The default pool (``n_slots * max_len // block_size + 1``) lets every
    slot hold a full table at once. The guards against a double free and
    a free of the zero block are always on (`BlockLedgerError`); the
    lifetime counters survive `reset_occupancy`.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # Popped from the tail: blocks allocate in ascending order.
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._rc = np.zeros(self.num_blocks, np.int32)
        self.high_water = 0
        self.frag_events = 0
        self.cover_events = 0
        self.allocs_total = 0
        self.frees_total = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def shared_blocks(self) -> int:
        """Blocks held by more than one block table (a fork's prefix)."""
        return int((self._rc >= 2).sum())

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: need {n} blocks, {len(self._free)} free of {self.num_blocks - 1} usable "
                "(size the pool with num_blocks >= n_slots * (max_len // block_size) + 1 for worst-case occupancy)"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        self.allocs_total += n
        self.high_water = max(self.high_water, self.in_use)
        return out

    def incref(self, blocks, n: int = 1) -> None:
        for b in blocks:
            self._rc[b] += n

    def decref(self, blocks) -> int:
        freed = 0
        for b in blocks:
            if b == 0:
                raise BlockLedgerError(
                    "decref of the reserved zero block (block 0 backs every unwritten table entry and must never "
                    "be freed)"
                )
            if self._rc[b] <= 0:
                raise BlockLedgerError(
                    f"double-free of block {int(b)}: refcount is {int(self._rc[b])} before this decref"
                )
            self._rc[b] -= 1
            if self._rc[b] == 0:
                self._free.append(b)
                freed += 1
        self.frees_total += freed
        return freed

    def note_cover(self, cover_events: int, allocated_blocks: int) -> None:
        """Internal-fragmentation accounting for one admitted row."""
        self.cover_events += int(cover_events)
        self.frag_events += int(allocated_blocks * self.block_size - cover_events)

    def reset_occupancy(self) -> None:
        """Every block back to the free list, the lifetime counters kept."""
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._rc[:] = 0


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


def _named_floats(out) -> list:
    """``(name, tensor)`` for every float tensor of a predictions or samples
    output (its distributions' parameters included)."""
    named = []
    for group in ("classification", "regression"):
        for k, v in (getattr(out, group, None) or {}).items():
            leaves = [v] if torch.is_tensor(v) else [t for d in v if d is not None for t in dist_tensors(d)]
            named += [(f"{group}[{k!r}]", t) for t in leaves]
    tte = getattr(out, "time_to_event", None)
    if tte is not None:
        named += [("time_to_event", t) for t in ([tte] if torch.is_tensor(tte) else dist_tensors(tte))]
    return [(k, t) for k, t in named if t is not None and t.is_floating_point()]


def _weights(model) -> list:
    """A model's parameters and buffers (each shared tensor once), in
    module order: two copies of one model list their tensors alike."""
    return [] if model is None else list(model.parameters()) + list(model.buffers())


@dataclasses.dataclass
class PrefillHandoff:
    """A prefill-stream admission in flight between engines (JAX's
    ``PrefillHandoff``): what `GenerationEngine.prefill_compute` computed for
    a group, in one device buffer of its own laid out by ``layout`` (the
    group's rows with their first event, prompt lengths, budgets, seeds,
    the float prefill caches; an NA engine's dep-graph caches; a spec
    engine's draft cache seed and, NA, history heads). The buffer is a
    copy, so a later call of the same program does not overwrite it."""

    requests: list
    group: int  # the program's group width
    layout: ByteLayout
    buffer: torch.Tensor
    has_draft: bool = False  # the draft cache seed rides along (spec engines)


class GenerationEngine:
    """Continuous-batching engine over one CI or NA model.

    Args:
        model: a `models.ci_model.CIPPTForGenerativeSequenceModeling` or
            `models.na_model.NAPPTForGenerativeSequenceModeling` with
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
            with fp32 scale tables, `ops.kv_quant`). Float caches are held
            in the compute dtype only (kernel B reads no other).
        paged_kv, block_size, num_blocks: the paged copy-on-write cache, as
            in the JAX engine: a pool of ``num_blocks`` blocks of
            ``block_size`` positions (``block_size`` must divide
            ``max_len``; the default pool, ``n_slots * max_len // block_size
            + 1`` blocks, holds every slot's full table and the zero
            block), which `fork` needs. ``num_blocks`` without
            ``paged_kv`` raises, as in JAX.
        spec: a `serving.spec.SpecConfig`: speculative decoding with its
            draft model (JAX's spec mode; CI and NA models, monolithic caches).
            ``decode_step_impl`` None, "auto" or "xla" then name the spec
            round (the draft's and the target's cached forwards); "pallas"
            raises, as do ``device_criteria`` and ``paged_kv``, with JAX's
            messages.
        hot_swap: reserve a shadow copy of the weights for `load_shadow`,
            `probe_shadow` and `flip` (JAX's double buffering; ``slots_report``
            charges the second copy from construction on, and the flip's
            scratch buffer beside it). A spec engine's draft then holds its
            own storage even where a truncated draft shares the target's
            modules.
        sampling_impl, decode_step_impl: the JAX engine's implementation
            knobs, taken where the port computes what they ask for:
            ``sampling_impl`` None, "auto" or "pallas" (the categorical
            heads through kernel A); ``decode_step_impl`` "xla" (the unfused
            model step), "pallas" (the layer stack through kernel B), or
            None / "auto": kernel B on a monolithic CI cache and the unfused
            step on a paged one or an NA model, where "pallas" raises as in
            JAX. Any other value raises ``ValueError`` naming what the port
            lacks.
        device: ``None`` (the CUDA device, raising without one) or an
            explicit device such as ``"cpu"``.
        cuda_graph: on a CUDA device, capture each program once and replay
            it for every call (the default, the counterpart of the JAX
            engine's jitted programs): the decode (or spec) chunk at construction, each
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
        paged_kv: bool = False,
        block_size: int = 16,
        num_blocks: int | None = None,
        spec: SpecConfig | None = None,
        hot_swap: bool = False,
        sampling_impl: str | None = None,
        decode_step_impl: str | None = None,
        device=None,
        cuda_graph: bool = True,
        **not_ported,
    ):
        for name, value in dict(sampling_impl=sampling_impl, decode_step_impl=decode_step_impl).items():
            accepted, missing = _IMPL_KNOBS[name]
            if value not in accepted:
                raise ValueError(f"{name}={value!r}: {missing}")
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"GenerationEngine got an unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise ValueError(f"{name}={value!r} is not part of the PyTorch port's serving slice yet")
        self.dispatch_depth = int(dispatch_depth)
        if self.dispatch_depth < 1:
            raise ValueError("dispatch_depth must be >= 1")
        self._na = config.structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION
        if self._na:
            if paged_kv:
                raise ValueError(_NA_PAGED)
            if decode_step_impl == "pallas":
                raise ValueError(_NA_MEGAKERNEL)
        self.spec = spec
        if spec is not None and self._na and config.scan_layers:
            raise ValueError(_NA_SPEC_SCAN)
        if spec is not None:
            spec.validate_against(config)
            if tuple(device_criteria):
                raise ValueError(_SPEC_CRITERIA)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self._init_paging(paged_kv, block_size, num_blocks)
        if spec is not None and self.paged_kv:
            raise ValueError(_PAGED_SPEC)
        if spec is not None and decode_step_impl == "pallas":
            raise ValueError(_SPEC_MEGAKERNEL)
        # The decode step: kernel B, or the unfused model step (JAX's
        # "auto" on a paged or NA engine, where kernel B does not read the
        # pool or walk the levels); a spec engine runs its round of draft and
        # target forwards instead.
        if self.paged_kv and decode_step_impl == "pallas":
            raise ValueError(_PAGED_MEGAKERNEL)
        self._unfused = decode_step_impl == "xla" or self.paged_kv or spec is not None or self._na
        self.decode_step_impl = "unfused" if self._unfused else "decode_stack_step"
        self._chunk, chunk_name = self._decode_chunk, "the decode chunk"
        if spec is not None:
            self.decode_step_impl, self._chunk, chunk_name = "spec_draft_verify", self._spec_chunk, "the spec chunk"
        self.device = resolve_device(device, "GenerationEngine")
        # An NA spec engine's level map (the strip of a correction event's
        # rejected levels, the draft's walk replays); split-mode levels raise JAX's error.
        self._level_of_meas = None
        if self._na and spec is not None:
            self._level_of_meas = na_level_of_measurement(config).to(self.device)
        self.config = config
        self.cdt = config.compute_dtype
        self.greedy = bool(greedy)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.health_sentinel = bool(health_sentinel)
        self.health_retries = int(health_retries)
        self.validate_prompts = bool(validate_prompts)
        # Fault-injection scope (`reliability.serving_faults`): the fleet
        # stamps each service's engines with the service id; None: only
        # scope-less faults match.
        self.fault_scope: Optional[str] = None
        self._kv_buf_dtype, self._kv_quantized = resolve_cache_dtype(kv_cache_dtype, self.cdt)
        if not self._kv_quantized and self._kv_buf_dtype != self.cdt:
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r} under compute dtype {self.cdt}: kernel B reads float caches "
                "in the compute dtype only (or use 'int8' / 'fp8')"
            )
        self.decode_chunk = int(decode_chunk)
        self.max_prompt_len = int(max_prompt_len or (max_len - 1))
        if self.max_prompt_len >= self.max_len:
            raise ValueError("max_prompt_len must leave room to generate (< max_len)")
        self.device_criteria = tuple(device_criteria)
        self.stop_dead_rows = bool(stop_dead_rows)
        self.seed = int(seed)
        self.scheduler = Scheduler(self.n_slots, make_buckets(min_bucket, self.max_prompt_len), max_pending=max_queue)
        if self.paged_kv:
            self.scheduler.block_pool_stats = self._block_pool_stats
        # What an event's draw fills: CI, every dynamic measurement at once;
        # NA, level l's measurements at level l (JAX's fill list; level 0,
        # the time, is the event's append).
        self._to_fill = measurements_to_fill(config)
        self._n_levels = 1
        if self._na:
            levels = config.measurements_per_dep_graph_level
            self._to_fill = [{"time"}] + [set(sorted(level, key=str)) for level in levels[1:]]
            self._n_levels = len(self._to_fill)

        # Weights in the compute dtype, once: the model keeps fp32 for callers.
        # A draft is copied with the target in one go, so modules a truncated
        # draft shares with it stay shared; under hot swap it is copied on its
        # own, so that a flip of the target's tensors leaves the draft's alone.
        self.hot_swap = bool(hot_swap)
        if self.hot_swap:
            self._model, self._draft = copy.deepcopy(model), copy.deepcopy(None if spec is None else spec.model)
        else:
            self._model, self._draft = copy.deepcopy((model, None if spec is None else spec.model))
        self._model = self._model.to(self.device).eval().cast_to_compute_dtype()
        if spec is not None:
            self._draft = self._draft.to(self.device).eval().cast_to_compute_dtype()
        # Kernel B's layer weights, stacked (the unfused step reads the model's own).
        self._stacked = {} if self._unfused else stack_layer_weights(self._model.encoder.blocks(), self.cdt)
        self._windows = tuple(
            config.seq_window_size if t == "local" else 0 for t in config.seq_attention_layers
        )
        # Hot swap: the shadow model (and draft) a checkpoint is staged in,
        # its stacked layer weights, and the flip's scratch buffer, as large
        # as the largest live tensor.
        self._shadow = self._shadow_draft = None
        self._shadow_stacked: dict = {}
        self.weights_version = 0
        self._swap_scratch = None
        if self.hot_swap:
            live = _weights(self._model) + list(self._stacked.values()) + _weights(self._draft)
            largest = max(t.numel() * t.element_size() for t in live)
            self._swap_scratch = torch.empty(largest, dtype=torch.uint8, device=self.device)
        self._prefill_computes = self._handoffs_admitted = 0

        self._template = self._normalize_prompt(template)
        self._init_state()
        # Static inputs and outputs of the programs other than the decode
        # chunk, by (kind, key); on the card, their captured programs by kind.
        self._statics: dict = {}
        self._program = None
        self._families: dict = {}
        if self.device.type == "cuda" and cuda_graph:
            pool = torch.cuda.graph_pool_handle()
            self._families = {kind: ProgramFamily(f"the {kind} program", device=self.device, pool=pool)
                              for kind in _PROGRAM_KINDS}  # fmt: skip
            self._capture_chunk(CapturedProgram(self._chunk, chunk_name, device=self.device, pool=pool))
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

    def _capture_chunk(self, program: CapturedProgram) -> None:
        """The chunk's program (decode or spec) warmed up and captured now,
        while every slot is inactive, so the warm-up writes nothing a request
        can see (every write of a step or round is masked by ``active``, and
        admission replaces a slot's rows whole); the initial state is then
        written back, so the warm-up's rounds are not counted."""
        self._program = program
        with torch.inference_mode():
            program.warmup()
            program.capture()
        self._write_initial_state()

    def _init_paging(self, paged_kv: bool, block_size: int, num_blocks: int | None) -> None:
        """The paged cache's options, checked as the JAX engine checks them,
        its allocator and the host mirror of the block tables."""
        self.paged_kv = bool(paged_kv)
        self.block_size = int(block_size)
        self._block_alloc: Optional[BlockAllocator] = None
        self._tables: Optional[np.ndarray] = None
        self._paged_num_blocks = 0
        self._next_fork_group = 0
        if not self.paged_kv:
            if num_blocks is not None:
                raise ValueError("num_blocks requires paged_kv=True")
            return
        if self.block_size < 1 or self.max_len % self.block_size != 0:
            raise ValueError(
                f"block_size ({self.block_size}) must divide max_len ({self.max_len}) — block tables cover the "
                "slot width exactly"
            )
        blocks_per_slot = self.max_len // self.block_size
        if num_blocks is None:  # every slot holding a full table, and the zero block
            num_blocks = self.n_slots * blocks_per_slot + 1
        num_blocks = int(num_blocks)
        if num_blocks < blocks_per_slot + 1:
            raise ValueError(
                f"num_blocks ({num_blocks}) must fit at least one full slot table ({blocks_per_slot}) plus the "
                "zero block"
            )
        if num_blocks == self.n_slots:
            # JAX adds a block here (a pool as long as the slot axis would be
            # sharded over it); kept, so the two engines' pools and counters agree.
            num_blocks += 1
        self._paged_num_blocks = num_blocks
        self._block_alloc = BlockAllocator(num_blocks, self.block_size)
        self._tables = np.zeros((self.n_slots, blocks_per_slot), np.int32)

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
        # The slot planes (layers, slots, heads, max_len, head_dim) or, paged,
        # the block pool (layers, num_blocks, heads, block_size, head_dim) and
        # each slot's block table; the scale tables drop the last axis.
        shape = (cfg.num_hidden_layers, S, cfg.num_attention_heads, L, cfg.head_dim)
        self.block_table = None
        if self.paged_kv:
            shape = (cfg.num_hidden_layers, self._paged_num_blocks, cfg.num_attention_heads, self.block_size,
                     cfg.head_dim)  # fmt: skip
            self.block_table = torch.empty(S, L // self.block_size, dtype=torch.int32, device=dev)
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
        self.dep_key = self.dep_value = self.dep_mask = None
        if self._na:
            # The dep-graph caches (JAX's ``_init_state``): one plane pair a
            # layer of G + 1 positions, in the compute dtype under every
            # cache dtype, and their mask. Their shared length is a phase,
            # not state: G at every step boundary (a walk resets it to 1 and
            # writes G more), a Python int in each program.
            dep = (cfg.num_hidden_layers, S, cfg.num_attention_heads, self._n_levels + 1, cfg.head_dim)
            self.dep_key = torch.empty(dep, dtype=self.cdt, device=dev)
            self.dep_value = torch.empty(dep, dtype=self.cdt, device=dev)
            self.dep_mask = torch.empty(S, self._n_levels + 1, dtype=torch.bool, device=dev)
        if self.spec is not None:
            self._init_spec_state()
        self._boundary = torch.empty((5 if self.spec is None else 7, S), dtype=torch.int32, device=dev)
        self._write_initial_state()

    def _init_spec_state(self) -> None:
        """The draft's per-slot cache (JAX's ``_init_spec_state``): planes at
        the target's ``max_len`` and cache dtype, at the draft's own depth,
        heads and head width, with their mask and lengths; each slot's
        proposed and accepted counts and the rounds run."""
        S, L, dev, dcfg = self.n_slots, self.max_len, self.device, self.spec.config
        # Quantized as the target's; a float cache in the draft's compute dtype.
        kv = cache_dtype_name(self._kv_buf_dtype) if self._kv_quantized else None
        dtype, quantized = resolve_cache_dtype(kv, dcfg.compute_dtype)
        shape = (dcfg.num_hidden_layers, S, dcfg.num_attention_heads, L, dcfg.head_dim)
        self.draft_key_cache = torch.empty(shape, dtype=dtype, device=dev)
        self.draft_value_cache = torch.empty(shape, dtype=dtype, device=dev)
        self.draft_key_scale = self.draft_value_scale = None
        if quantized:
            self.draft_key_scale = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
            self.draft_value_scale = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
        self.draft_cache_mask = torch.empty(S, L, dtype=torch.bool, device=dev)
        self.draft_cache_len, self.spec_proposed, self.spec_accepted = (
            torch.empty(S, dtype=torch.int32, device=dev) for _ in range(3)
        )
        self.spec_rounds = torch.empty((), dtype=torch.int32, device=dev)
        self.draft_dep_key = self.draft_dep_value = self.draft_dep_mask = self.spec_history = None
        if self._na:
            # The draft's dep-graph planes, as the target's (the compute
            # dtype under every cache dtype, length G at a round's end), and
            # the history heads: each target layer's contextualized embedding
            # of each slot's next-to-last committed event, the verify
            # window's position-0 history (JAX's ``SpecState.history``).
            dep = (dcfg.num_hidden_layers, S, dcfg.num_attention_heads, self._n_levels + 1, dcfg.head_dim)
            self.draft_dep_key = torch.empty(dep, dtype=dcfg.compute_dtype, device=dev)
            self.draft_dep_value = torch.empty(dep, dtype=dcfg.compute_dtype, device=dev)
            self.draft_dep_mask = torch.empty(S, self._n_levels + 1, dtype=torch.bool, device=dev)
            cfg = self.config
            self.spec_history = torch.empty(cfg.num_hidden_layers, S, cfg.hidden_size, dtype=self.cdt, device=dev)

    def _write_initial_state(self) -> None:
        """Every state buffer to its initial value, in place (each keeps its
        address): empty rows, zero caches (the draft's and the dep-graph
        caches too) with unit scales (zero codes dequantize to zeros; a
        pool's zero block among them),
        block tables on the zero block, zero spec counts, every slot done and
        not live."""
        for x in vars(self.big).values():
            if torch.is_tensor(x):
                x.zero_()
        zeros = [self.cache_mask, self.cache_len, self.budget, self.n_generated, self.live, self.health, self.seeds,
                 self.counters, self.active_steps, self._boundary, self.block_table, self.dep_key, self.dep_value,
                 self.dep_mask]  # fmt: skip
        planes = [self._planes()]
        if self.spec is not None:
            planes.append(self._planes(draft=True))
            zeros += [self.draft_cache_mask, self.draft_cache_len, self.spec_proposed, self.spec_accepted,
                      self.spec_rounds, self.draft_dep_key, self.draft_dep_value, self.draft_dep_mask,
                      self.spec_history]  # fmt: skip
        for keys, values, key_scale, value_scale in planes:
            storage(keys).zero_()
            storage(values).zero_()
            for x in (key_scale, value_scale):
                if x is not None:
                    x.fill_(1.0)
        for x in zeros:
            if x is not None:
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
        return assemble_event_sample(preds_last, self._draw_rows(preds_last, RowStreams(seeds, counters), active),
                                     em_last)  # fmt: skip

    def _row_done(self, big, cursor, base_len, n_generated, budget):
        done = (cursor - base_len) >= budget
        kw = dict(big=big, cursor=cursor, base_len=base_len, n_generated=n_generated, budget=budget)
        if self.stop_dead_rows:
            done = done | DeadRowCriteria().row_done(**kw)
        for crit in self.device_criteria:
            done = done | crit.row_done(**kw)
        return done

    def _rows_nonfinite(self, preds_last, sample=None) -> torch.Tensor:
        """Per-slot any-non-finite over the float tensors of the step's
        predictions (a spec round: of its whole verify window) and sample
        (the health sentinel's detector; row-local, no cross-slot op). A
        sampled regression value may be NaN: that is how the sample marks a
        value its is-observed head left out (`assemble_event_sample`), so
        there only an infinity counts. (JAX's detector counts that NaN too
        and quarantines any slot whose univariate regression head samples
        "unobserved": ROADMAP Queue 3.)"""
        leaves, sampled = [], []
        for group in (preds_last.classification, preds_last.regression):
            for pair in (group or {}).values():
                leaves += [t for d in pair if d is not None for t in dist_tensors(d)]
        if preds_last.time_to_event is not None:
            leaves += dist_tensors(preds_last.time_to_event)
        if sample is not None:
            leaves += [sample.time_to_event] + list((sample.classification or {}).values())
            sampled = list((sample.regression or {}).values())
        bad = torch.zeros(self.n_slots, dtype=torch.bool, device=self.device)
        for x, nan_ok in [(x, False) for x in leaves] + [(x, True) for x in sampled]:
            if x is not None and x.is_floating_point() and x.ndim >= 1 and x.shape[0] == self.n_slots:
                x = x.reshape(self.n_slots, -1)
                bad = bad | (x.isinf() if nan_ok else ~torch.isfinite(x)).any(dim=1)
        return bad

    def _planes(self, draft: bool = False) -> tuple:
        """The target's (or the draft's) cache planes and scale tables."""
        if draft:
            return self.draft_key_cache, self.draft_value_cache, self.draft_key_scale, self.draft_value_scale
        return self.key_cache, self.value_cache, self.key_scale, self.value_scale

    def _layer_caches(self, cache_mask: torch.Tensor, cache_len: torch.Tensor, draft: bool = False) -> tuple:
        """The engine's cache (or the draft's) as the model's per-layer past:
        one `KVCache` (views of the slot planes) or, paged, one `PagedKVCache`
        (views of the pool, the block tables) a layer, with per-row ``cache_len``."""
        keys, values, key_scale, value_scale = self._planes(draft)
        scales = [(None, None)] * keys.shape[0]
        if key_scale is not None:
            scales = list(zip(key_scale, value_scale))
        if self.paged_kv:
            return tuple(PagedKVCache(k, v, self.block_table, cache_mask, cache_len, *sc)
                         for k, v, sc in zip(keys, values, scales))  # fmt: skip
        return tuple(KVCache(k, v, cache_mask, cache_len, *sc) for k, v, sc in zip(keys, values, scales))

    def _dep_planes(self, draft: bool = False) -> tuple:
        """The target's (or the draft's) dep-graph planes and their mask."""
        if draft:
            return self.draft_dep_key, self.draft_dep_value, self.draft_dep_mask
        return self.dep_key, self.dep_value, self.dep_mask

    def _dep_caches(self, draft: bool = False) -> tuple:
        """The dep-graph caches (or the draft's) as the model's per-layer
        dep-graph past: views of the planes at the step boundary's length G
        (a Python int)."""
        keys, values, mask = self._dep_planes(draft)
        return tuple(KVCache(k, v, mask, self._n_levels) for k, v in zip(keys, values))

    def _store_dep(self, dep: tuple, draft: bool = False) -> None:
        """A walk's dep-graph caches into the planes (or the draft's), whole
        rows of every slot (JAX's ``_merge_caches`` takes them without a
        merge: they advance in lockstep, and a finished slot's rows hold
        inert values its next admission overwrites)."""
        keys, values, mask = self._dep_planes(draft)
        for i, c in enumerate(dep):
            keys[i].copy_(c.key)
            values[i].copy_(c.value)
        mask.copy_(dep[0].mask)

    def _unfused_forward(
        self, view: EventStreamBatch, cache_mask, cache_len, active, draft: bool = False, dep=None, **window
    ) -> tuple:
        """The JAX engine's unfused decode step (``_decode_step_ci`` with
        ``self.model.apply(params, view, past=caches, use_cache=True)`` and
        ``_merge_caches``): the model's (or the draft's) cached forward of the
        view's events, one a step or a spec round's verify window; an NA
        model's is the step's target-0 forward (``NAPast`` of the sequence
        caches and the dep-graph caches ``dep``, by default `_dep_caches`),
        whose dep-graph caches the caller walks on, or, given ``window``
        (the NA verify's ``partial_content_levels``, ``history_head``,
        ``return_contextualized``), the full forward of the view with no
        dep-graph past (its reset seeds the walk of the view's last event).
        A monolithic cache takes each layer's new planes where a slot is
        active; a pool was written in place by the forward, every row at its
        own block (a finished row writes into blocks it still holds, which
        no live row reads). Returns the output and the merged mask and
        lengths."""
        model = self._draft if draft else self._model
        past = self._layer_caches(cache_mask, cache_len, draft)
        if window:
            out = model(view, past=NAPast(seq_past=past), use_cache=True, **window)
            new = out.past_key_values.seq_past
        elif self._na:
            dep = self._dep_caches(draft) if dep is None else dep
            out = model(view, past=NAPast(seq_past=past, dep_graph_past=dep), use_cache=True,
                        dep_graph_el_generation_target=0)  # fmt: skip
            new = out.past_key_values.seq_past
        else:
            out = model(view, past=past, use_cache=True)
            new = out.past_key_values
        if not self.paged_kv:
            keys, values, key_scale, value_scale = self._planes(draft)
            for i, c in enumerate(new):
                pairs = [(keys[i], c.key), (values[i], c.value)]
                if key_scale is not None:
                    pairs += [(key_scale[i], c.key_scale), (value_scale[i], c.value_scale)]
                for dst, src in pairs:
                    dst = storage(dst)
                    dst.copy_(torch.where(active.view(-1, *[1] * (dst.ndim - 1)), storage(src), dst))
        return (
            out,
            torch.where(active[:, None], new[0].mask, cache_mask),
            torch.where(active, new[0].length, cache_len),
        )

    def _level_walk(self, big: EventStreamBatch, cursor, dep: tuple, seeds, counter, active=None, bad=None) -> tuple:
        """Levels 1 .. G-1 of each row's event at ``cursor`` (JAX's NA level
        loop, `_walk` on the target): level ``l``'s heads drawn from stream
        counter ``counter + l`` and its measurements filled in where
        ``active``. ``bad``, the health sentinel's rows, takes each level's
        non-finite rows. Returns the dep-graph caches and ``bad``."""
        dep, _, bad = self._walk(self._model, big, cursor, dep, lambda level: RowStreams(seeds, counter + level),
                                 lambda level: active, sample_active=active, bad=bad)  # fmt: skip
        return dep, bad

    def _walk(
        self, model, big: EventStreamBatch, cursor, dep: tuple, streams=None, write=None, *, sample_active=None,
        drop_oob: bool = False, mask_levels: bool = False, bad=None,
    ) -> tuple:  # fmt: skip
        """Levels 1 .. G-1 of each row's event at ``cursor`` through ``model``
        (the target or the draft): each level's one-element forward against
        the dep-graph caches ``dep`` (no sequence cache is read); with
        ``streams(level)`` its heads drawn (kernel A on each categorical
        head) and its measurements filled in, in place, where
        ``write(level)`` (None: every row; ``drop_oob`` drops rows past the
        buffer). ``mask_levels`` masks the event's levels ``>= level`` out of
        each level's input (`mask_batch_to_levels`): a walk over an event
        whose later levels are written already (a teacher-forced replay, a
        correction walk frozen below its break) then writes the keys and
        values the sequential walk wrote. ``streams=None`` draws nothing (a
        replay). ``bad`` takes each level's non-finite rows. Returns the
        dep-graph caches, each level's ``(predictions, draws)`` and ``bad``."""
        at = cursor.clamp(max=big.event_mask.shape[1] - 1)  # a finished row's cursor may sit at the buffer's end
        em = take_event(big.event_mask, at)
        drawn = []
        for level in range(1, self._n_levels):
            view = _trim_to_event(big, at)
            if mask_levels:
                view = mask_batch_to_levels(view, self._level_of_meas, level - 1)
            out = model(view, past=NAPast(dep_graph_past=dep), use_cache=True, dep_graph_el_generation_target=level)
            dep = out.past_key_values.dep_graph_past
            if streams is None:
                continue
            preds = _slice_preds_at(out.preds, 0)
            draws = self._draw_rows(preds, streams(level), sample_active)
            sample = assemble_event_sample(preds, draws, em)
            if bad is not None:
                bad = bad | self._rows_nonfinite(preds, sample)
            update_last_event_data(big, sample, self.config, cursor + 1, self._to_fill[level],
                                   None if write is None else write(level), drop_oob=drop_oob)  # fmt: skip
            drawn.append((preds, draws))
        if dep[0].length != self._n_levels:  # the boundary's phase every program assumes
            raise RuntimeError(f"a level walk left its dep-graph caches at {dep[0].length}, not {self._n_levels}")
        return dep, drawn, bad

    def _decode_step(self, st: dict, seeds: torch.Tensor) -> dict:
        """One event for every active slot of state ``st`` (`_CHUNK_STATE`,
        the counters in int64) with the slots' seeds in int64; returns the
        next state. Inactive slots keep theirs. The layer stack runs through
        kernel B or, unfused, as the model's cached forward. An NA event
        (JAX's ``_decode_step_na``) is the target-0 forward of the last
        event, level 0 (its time) drawn and the event appended, then the
        level walk; event ``j`` of a request draws level ``l`` from stream
        counter ``j * G + l``."""
        cfg, m = self.config, self._model
        active = self.live & ~st["done"]
        view = _trim_to_event(self.big, st["cursor"] - 1)
        counter = st["counters"] * self._n_levels if self._na else st["counters"]
        if self._unfused:
            out, cache_mask, cache_len = self._unfused_forward(view, st["cache_mask"], st["cache_len"], active)
        else:
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
        sample = self._sample_rows(preds_last, em_last, seeds, counter, active=active)
        append_new_event(self.big, sample, self.config, st["cursor"], active)
        bad = self._rows_nonfinite(preds_last, sample) if self.health_sentinel else None
        if self._na:
            dep, bad = self._level_walk(self.big, st["cursor"], out.past_key_values.dep_graph_past, seeds, counter,
                                        active, bad)  # fmt: skip
            self._store_dep(dep)
        else:
            update_last_event_data(self.big, sample, cfg, st["cursor"] + 1, self._to_fill, active)

        cursor = torch.where(active, st["cursor"] + 1, st["cursor"])
        n_generated = st["n_generated"] + (active & sample.event_mask).to(torch.int32)
        done = st["done"] | (active & self._row_done(self.big, cursor, self.base_len, n_generated, self.budget))
        health = st["health"]
        if bad is not None:
            hit = active & bad
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

    # ------------------------------------------------- speculative decoding
    def _take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``take_event`` with each row's index clamped into the buffer (JAX's
        gathers clamp; a spec round reads up to ``k`` events past a cursor)."""
        return take_event(x, idx.clamp(max=x.shape[1] - 1))

    def _window_view(self, start: torch.Tensor, W: int) -> EventStreamBatch:
        """A ``W``-event view of the slot rows from each row's position
        ``start`` (JAX's ``_window_view``), with absolute time from the whole
        row, so each window position is bit for bit the one-event view
        `_trim_to_event` builds there; positions past the buffer read its
        last event, as JAX's clamped gathers do."""
        big = self.big
        idx = (start.long()[:, None] + torch.arange(W, device=start.device)).clamp(max=self.max_len - 1)

        def take(x):
            if x.ndim == 2:
                return x.gather(1, idx)
            return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))

        fields = ("event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values",
                  "dynamic_values_mask")  # fmt: skip
        return big.replace(time=take(time_from_deltas(big)), **{f: take(getattr(big, f)) for f in fields})

    def _draw_rows(self, preds, streams, active=None) -> dict:
        """Per-row raw named-head draws (`sample_head_draws`) from an event's
        streams, kernel A drawing every categorical head (``active``: its
        rows; greedy: the greedy statistics)."""
        if self.greedy:
            return sample_head_draws(preds, None, greedy=True)
        return sample_head_draws(preds, streams, categorical_sampler=self._categorical_sampler(active))

    def _spec_draft(self, st: dict, seeds: torch.Tensor, active: torch.Tensor) -> tuple:
        """The draft chunk (JAX's ``_spec_draft_chunk_ci``): ``k`` proposals a
        slot from the draft's cached forwards, each written into the slot row
        after the last (event ``cursor + t``; past the buffer dropped), the
        draft cache advancing with them. Returns each proposal's
        ``(predictions, draws)`` and the draft cache's mask.

        The first step reads the last TWO committed events (a two-event
        window from ``cursor - 2``), where JAX's reads the last one: after a
        round that accepted all ``k`` proposals and committed the bonus, the
        last proposal is committed but no draft step took it as input, so
        JAX's draft cache keeps a stale entry there for the rest of the
        request (ROADMAP Queue 3). Re-reading it costs one more event in one
        forward a round; the committed law does not depend on the draft."""
        cfg, big = self.config, self.big
        mask = st["draft_cache_mask"]
        proposals = []
        for t in range(self.spec.k):
            pos = st["cursor"] + t
            if t == 0:  # an empty slot's cursor is 1: its start clamped to 0
                length = (pos - 2).clamp(min=0)
                view = self._window_view(length, 2)
            else:
                view = self._window_view(pos - 1, 1)
            out, mask, length = self._unfused_forward(view, mask, length, active, draft=True)
            preds = _slice_preds_at(out.preds, 1 if t == 0 else 0)
            draws = self._draw_rows(preds, event_streams(seeds, pos - self.base_len))
            sample = assemble_event_sample(preds, draws, self._take(big.event_mask, pos - 1))
            append_new_event(big, sample, self.config, pos, active, drop_oob=True)
            update_last_event_data(big, sample, cfg, pos + 1, self._to_fill, active, drop_oob=True)
            proposals.append((preds, draws))
        return proposals, mask

    def _spec_round_caps(self, c: torch.Tensor, a: torch.Tensor, prop_em: torch.Tensor) -> tuple:
        """Events a round commits (JAX's ``_spec_round_caps``): the accepted
        prefix plus the correction or bonus event (``a + 1``), capped by the
        budget and, with dead-row stops, at the first committed dead event;
        and whether the last of them is the correction (``m == a + 1``)."""
        budget_left = self.budget - (c - self.base_len)
        m = torch.minimum(a + 1, budget_left)
        if self.stop_dead_rows:
            f = torch.cumprod(prop_em.to(torch.int32), dim=0).sum(0, dtype=torch.int32)
            m = torch.minimum(m, torch.where(f < a, f + 1, self.spec.k + 2))
        m = m.clamp(min=1)
        return m, m == a + 1

    def _spec_round(self, st: dict, seeds: torch.Tensor) -> dict:
        """One speculative round for every active slot of state ``st``
        (`_SPEC_STATE`): the draft chunk, then ONE target forward over the
        ``k + 1``-event window from the last committed event (JAX's
        ``_spec_verify_ci``): the accept walk of each proposal, the bonus
        event off the window's last position, the commit of the accepted
        prefix plus one event (selected, not recomputed), the cursor and
        both caches' lengths rolled to the new cursor, the counters and the
        health sentinel over the whole window. Returns the next state;
        inactive slots keep theirs."""
        cfg, big, K = self.config, self.big, self.spec.k
        active = self.live & ~st["done"]
        c, base = st["cursor"], self.base_len
        proposals, dmask = self._spec_draft(st, seeds, active)

        out, cache_mask, cache_len = self._unfused_forward(
            self._window_view(c - 1, K + 1), st["cache_mask"], st["cache_len"], active
        )
        accepts, cands = [], []
        for t in range(1, K + 1):
            tgt_preds = _slice_preds_at(out.preds, t - 1)
            dft_preds, dft_draws = proposals[t - 1]
            streams = event_streams(seeds, c + t - 1 - base)
            acc, cand = spec_accept_level(
                tgt_preds, dft_preds, dft_draws, self._draw_rows(tgt_preds, streams), streams,
                self._take(big.event_mask, c + t - 2), greedy=self.greedy, rtol=self.spec.value_rtol,
                atol=self.spec.value_atol, top_k=self.top_k, top_p=self.top_p,
            )  # fmt: skip
            accepts.append(acc)
            cands.append(cand)
        # The bonus: a target sample off the window's last position, which a
        # fully accepted round commits for free.
        bonus = _slice_preds_at(out.preds, K)
        draws = self._draw_rows(bonus, event_streams(seeds, c + K - base))
        cands.append(assemble_event_sample(bonus, draws, self._take(big.event_mask, c + K - 1)))

        a = torch.cumprod(torch.stack(accepts).to(torch.int32), dim=0).sum(0, dtype=torch.int32)
        prop_em = torch.stack([self._take(big.event_mask, c + t - 1) for t in range(1, K + 1)])
        m, needs_corr = self._spec_round_caps(c, a, prop_em)
        corr = select_candidate(cands, a)
        commit = active & needs_corr
        append_new_event(big, corr, self.config, c + m - 1, commit)
        update_last_event_data(big, corr, cfg, c + m, self._to_fill, commit)
        return self._spec_advance(st, active, m, needs_corr, out.preds, cache_mask, cache_len, dmask)

    def _spec_advance(self, st: dict, active, m, needs_corr, window_preds, cache_mask, cache_len, dmask) -> dict:
        """The state after a round that committed ``m`` events a row (JAX's
        ``_spec_advance``): cursors, generated counts, stops, the health
        sentinel over the verify window's predictions, both caches' lengths
        rolled to the new cursor, the proposed and accepted counts."""
        c, base = st["cursor"], self.base_len
        cursor = c + torch.where(active, m, 0)
        pos = torch.arange(self.max_len, device=c.device)[None, :]
        new_real = (self.big.event_mask & (pos >= c[:, None]) & (pos < cursor[:, None])).sum(1, dtype=torch.int32)
        n_generated = st["n_generated"] + torch.where(active, new_real, 0)
        done = st["done"] | (active & self._row_done(self.big, cursor, base, n_generated, self.budget))
        # Proposals past a row's budget can never commit: only the committable count.
        proposable = (self.budget - (c - base)).clamp(0, self.spec.k)
        health = st["health"]
        if self.health_sentinel:
            hit = active & self._rows_nonfinite(window_preds)
            done, health = done | hit, health | hit
        return dict(
            cursor=cursor,
            n_generated=n_generated,
            done=done,
            health=health,
            active_steps=st["active_steps"] + active.sum(dtype=torch.int32),
            cache_mask=cache_mask,
            cache_len=torch.where(active, cursor - 1, cache_len),
            draft_cache_mask=dmask,
            draft_cache_len=torch.where(active, cursor - 1, st["draft_cache_len"]),
            spec_proposed=st["spec_proposed"] + torch.where(active, proposable, 0),
            spec_accepted=st["spec_accepted"] + torch.where(active, m - needs_corr.to(torch.int32), 0),
            spec_rounds=st["spec_rounds"] + 1,
        )

    # ------------------------------------------ speculative decoding, NA
    def _level_preds(self, preds, level: int) -> GenerativeSequenceModelPredictions:
        """Dep-graph level ``level``'s heads of a full NA forward's
        predictions (JAX's ``_level_preds``): the heads the cached walk's
        level-``level`` forward gives; level 0, the time to event."""
        if level == 0:
            return GenerativeSequenceModelPredictions(time_to_event=preds.time_to_event)
        cat, num = level_measurements(self.config.measurements_per_dep_graph_level[level])
        cls = {m: d for m, d in (preds.classification or {}).items() if m in cat}
        reg = {m: d for m, d in (preds.regression or {}).items() if m in num}
        return GenerativeSequenceModelPredictions(classification=cls or None, regression=reg or None)

    def _spec_draft_na(self, st: dict, seeds: torch.Tensor, active: torch.Tensor) -> tuple:
        """The NA draft chunk (JAX's ``_spec_draft_chunk_na``): ``k`` whole
        events a slot, each the draft's target-0 forward of the event before
        it (level 0, its time, drawn and the event opened at ``cursor + t``)
        and the draft's level walk (`_walk`), every level's predictions and
        draws recorded; past the buffer dropped. Level ``l`` of event ``j``
        draws from `level_streams` ``(j, l)``.

        Then one more target-0 forward, of the last proposal: it writes that
        proposal's draft sequence-cache entry, which JAX's draft never
        writes (after a round that commits every proposal and the bonus, the
        entry stays stale for the rest of the request; ROADMAP Queue 3).
        Each target-0 forward's reset, the seed of the next event's walk,
        is kept: `_spec_round_na` rebuilds the draft's dep-graph caches for
        the last committed event from the seed of its position (JAX's draft
        keeps the walk of its last proposal, whichever event the round
        commits last). Returns the proposals (``[(predictions, draws)]`` a
        level, a proposal), the draft cache's mask and the ``k + 1`` seeds."""
        big, K, G = self.big, self.spec.k, self._n_levels
        c, base = st["cursor"], self.base_len
        mask, length = st["draft_cache_mask"], st["draft_cache_len"]
        dep = self._dep_caches(draft=True)
        proposals, seeds_out = [], []
        for t in range(K + 1):
            pos = c + t
            out, mask, length = self._unfused_forward(self._window_view(pos - 1, 1), mask, length, active, draft=True,
                                                      dep=dep)  # fmt: skip
            dep = out.past_key_values.dep_graph_past
            seeds_out.append(dep)
            if t == K:
                break
            j = pos - base
            preds = _slice_preds_at(out.preds, 0)
            draws = self._draw_rows(preds, level_streams(seeds, j, G, 0))
            sample = assemble_event_sample(preds, draws, self._take(big.event_mask, pos - 1))
            append_new_event(big, sample, self.config, pos, active, drop_oob=True)
            dep, drawn, _ = self._walk(self._draft, big, pos, dep, lambda level, j=j: level_streams(seeds, j, G, level),
                                       lambda level: active, drop_oob=True)  # fmt: skip
            proposals.append([(preds, draws)] + drawn)
        return proposals, mask, seeds_out

    def _spec_round_na(self, st: dict, seeds: torch.Tensor) -> dict:
        """One speculative round on an NA model (JAX's ``_spec_verify_na``
        after `_spec_draft_na`): ONE teacher-forced target forward over the
        ``k + 1``-event window from the last committed event, with
        ``partial_content_levels`` and the carried history heads, scores
        every level of every proposal, so its level-``l`` predictions are
        what the sequential cached walk computes (level 0 from the preceding
        position, levels >= 1 from the event's own). The accept walk runs
        level by level (`spec_accept_level`); an event is accepted when every
        level is, and the first rejected level of the first rejected event
        is its break level ``l_sel`` (0 for the bonus event, a target draw
        off the window's last position). The commit: level 0 appended where
        the break is at 0; else the event's levels from the break up
        stripped and the breaking level's residual filled in; then the
        correction walk: a one-event re-contextualize forward of the event
        before the correction (the history head of its predecessor) seeds
        the walk of the levels above the break, each row frozen below it.
        The sequence caches roll to the new cursor, the dep-graph caches are
        the walk's (lockstep scratch, as in JAX), the history heads take the
        window's contextualized embeddings at the new next-to-last event, and
        the draft's dep-graph caches are rebuilt for the last committed event
        (its seed from the draft chunk, then a teacher-forced replay of its
        levels). Returns the next state; inactive slots keep theirs."""
        active = self.live & ~st["done"]
        proposals, dmask, draft_seeds = self._spec_draft_na(st, seeds, active)
        verdict = self._spec_verify_na(st, seeds, active, proposals)
        return self._spec_commit_na(st, seeds, active, verdict, dmask, draft_seeds)

    def _spec_verify_na(self, st: dict, seeds: torch.Tensor, active: torch.Tensor, proposals: list) -> dict:
        """The window forward and the per-level accept walk of `_spec_round_na`:
        the window's output, the target cache's merged mask and lengths, the
        accepted count ``a``, the committed count ``m``, ``needs_corr``, the
        break level ``l_sel`` and each level's candidates."""
        big, K, G = self.big, self.spec.k, self._n_levels
        c, base = st["cursor"], self.base_len
        out, cache_mask, cache_len = self._unfused_forward(
            self._window_view(c - 1, K + 1), st["cache_mask"], st["cache_len"], active, partial_content_levels=True,
            history_head=tuple(self.spec_history), return_contextualized=True,
        )  # fmt: skip
        acc_events, lrejs = [], []
        level_cands = [[] for _ in range(G)]
        for t in range(1, K + 1):
            accs = []
            for level in range(G):
                # Window index v holds position c - 1 + v: level 0 is the
                # preceding position's whole-event prediction, levels >= 1 the
                # event's own graph encodings.
                src = t - 1 if level == 0 else t
                tgt = self._level_preds(_slice_preds_at(out.preds, src), level)
                dft_preds, dft_draws = proposals[t - 1][level]
                streams = level_streams(seeds, c + t - 1 - base, G, level)
                acc, cand = spec_accept_level(
                    tgt, dft_preds, dft_draws, self._draw_rows(tgt, streams), streams,
                    self._take(big.event_mask, c + t - 2 if level == 0 else c + t - 1), greedy=self.greedy,
                    rtol=self.spec.value_rtol, atol=self.spec.value_atol, top_k=self.top_k, top_p=self.top_p,
                )  # fmt: skip
                accs.append(acc)
                level_cands[level].append(cand)
            acc_stack = torch.stack(accs).to(torch.int32)
            lrejs.append(torch.cumprod(acc_stack, dim=0).sum(0, dtype=torch.int32))  # the first rejected level
            acc_events.append(acc_stack.prod(0).bool())
        # The bonus event's level 0; its levels come from the correction walk,
        # so levels >= 1 repeat the last candidate (never selected).
        bonus = self._level_preds(_slice_preds_at(out.preds, K), 0)
        draws = self._draw_rows(bonus, level_streams(seeds, c + K - base, G, 0))
        level_cands[0].append(assemble_event_sample(bonus, draws, self._take(big.event_mask, c + K - 1)))
        for level in range(1, G):
            level_cands[level].append(level_cands[level][-1])

        a = torch.cumprod(torch.stack(acc_events).to(torch.int32), dim=0).sum(0, dtype=torch.int32)
        prop_em = torch.stack([self._take(big.event_mask, c + t - 1) for t in range(1, K + 1)])
        m, needs_corr = self._spec_round_caps(c, a, prop_em)
        l_sel = torch.where(a < K, torch.stack(lrejs).gather(0, a.clamp(max=K - 1).long()[None])[0], 0)
        return dict(out=out, cache_mask=cache_mask, cache_len=cache_len, a=a, m=m, needs_corr=needs_corr, l_sel=l_sel,
                    level_cands=level_cands)  # fmt: skip

    def _spec_commit_na(self, st: dict, seeds, active, verdict: dict, dmask, draft_seeds: list) -> dict:
        """The commit of `_spec_round_na` after `_spec_verify_na`: the
        correction event's verify-side levels, the correction walk, the
        history heads, the state advance and the draft's dep-graph caches."""
        cfg, big, K, G = self.config, self.big, self.spec.k, self._n_levels
        W = K + 1
        c, base = st["cursor"], self.base_len
        rows = torch.arange(self.n_slots, device=c.device)
        out, a, m, l_sel, level_cands = (verdict[k] for k in ("out", "a", "m", "l_sel", "level_cands"))
        needs_corr, cache_mask, cache_len = verdict["needs_corr"], verdict["cache_mask"], verdict["cache_len"]
        corr_cursor = c + m - 1
        commit = active & needs_corr
        history = tuple(self.spec_history)

        # The correction event's verify-side levels: level 0 appended where
        # the break is at 0; else the levels from the break up stripped (the
        # draft's elements there; the accepted levels' stay in their build
        # order) and the breaking level's residual filled in.
        append_new_event(big, select_candidate(level_cands[0], a), self.config, corr_cursor, commit & (l_sel == 0))
        at = corr_cursor.long().clamp(0, self.max_len - 1)
        meas = big.dynamic_measurement_indices[rows, at]
        strip = (commit & (l_sel >= 1))[:, None] & (meas != 0) & (self._level_of_meas[meas.long()] >= l_sel[:, None])
        for name in ("dynamic_indices", "dynamic_measurement_indices", "dynamic_values", "dynamic_values_mask"):
            buf = getattr(big, name)
            buf[rows, at] = torch.where(strip, False if buf.dtype == torch.bool else 0, buf[rows, at])
        for level in range(1, G):
            update_last_event_data(big, select_candidate(level_cands[level], a.clamp(max=K - 1)), cfg, corr_cursor + 1,
                                   self._to_fill[level], commit & (l_sel == level))  # fmt: skip

        # The correction walk: the re-contextualize forward of the event
        # before the correction (its history: the round's input head where the
        # first proposal broke, else the window's embedding of the last
        # accepted proposal) writes its sequence-cache entry and seeds the
        # walk of the correction event's levels above the break.
        hist_r = tuple(
            torch.where((a == 0)[:, None], h, ctx[rows, (a - 1).clamp(0, W - 1).long()])
            for h, ctx in zip(history, out.contextualized)
        )
        out_r, cache_mask, cache_len = self._unfused_forward(
            self._window_view(corr_cursor - 1, 1), cache_mask, torch.where(commit, corr_cursor - 1, cache_len), commit,
            partial_content_levels=True, history_head=hist_r,
        )  # fmt: skip
        j = corr_cursor - base
        dep, _, _ = self._walk(self._model, big, corr_cursor, out_r.past_key_values.dep_graph_past,
                               lambda level: level_streams(seeds, j, G, level),
                               lambda level: commit & (l_sel < level), mask_levels=True)  # fmt: skip
        self._store_dep(dep)
        # The next round's window starts at the new last committed event; its
        # predecessor (window index m - 1) gives the history heads.
        last = (m - 1).clamp(0, W - 1).long()
        for h, ctx in zip(self.spec_history, out.contextualized):
            h.copy_(torch.where(active[:, None], ctx[rows, last], h))
        nxt = self._spec_advance(st, active, m, needs_corr, out.preds, cache_mask, cache_len, dmask)

        # The draft's dep-graph caches for the new last committed event: the
        # seed its position's target-0 forward left, then its levels replayed.
        pick = torch.where(active, m - 1, 0).clamp(0, K).long()
        seed = tuple(
            KVCache(torch.stack([d[i].key for d in draft_seeds])[pick, rows],
                    torch.stack([d[i].value for d in draft_seeds])[pick, rows], draft_seeds[0][i].mask, 1)
            for i in range(len(draft_seeds[0]))
        )  # fmt: skip
        ddep, _, _ = self._walk(self._draft, big, nxt["cursor"] - 1, seed, mask_levels=True)
        self._store_dep(ddep, draft=True)
        return nxt

    def _spec_chunk(self) -> None:
        """The spec chunk: ``decode_chunk`` rounds (JAX dispatches a draft
        and a verify program a round) from the engine's state buffers, the
        final state copied back into them and the packed ``(7, n_slots)``
        boundary (done, cursor, base_len, n_generated, health, proposed,
        accepted) written into its buffer; on the card one captured program
        an engine, as `_decode_chunk` is."""
        st = {k: getattr(self, k) for k in _SPEC_STATE}
        seeds = self.seeds.long()
        spec_round = self._spec_round_na if self._na else self._spec_round
        for _ in range(self.decode_chunk):
            st = spec_round(st, seeds)
        for k in _SPEC_STATE:
            getattr(self, k).copy_(st[k])
        rows = [self.done.to(torch.int32), self.cursor, self.base_len, self.n_generated, self.health.to(torch.int32)]
        torch.stack(rows + [self.spec_proposed, self.spec_accepted], out=self._boundary)

    # ------------------------------------------------ prefill and extraction
    def _run_program(self, kind: str, key, inputs: dict, outputs: dict, body, fill, inert, device_in=None) -> tuple:
        """Runs the ``kind`` program of ``key``: ``body(x)``, where ``x`` holds
        its static inputs and outputs, views of two device buffers laid out
        by ``inputs`` and ``outputs`` (`ByteLayout`s made at the key's first
        use). ``fill(views)`` first writes this call's inputs into a staging
        buffer (pinned on the card, zeroed) that one copy moves to the
        device. ``device_in``, a device buffer of the ``outputs`` layout, is
        copied into the second buffer first, which then holds inputs that
        are already on the device (an admitted handoff; zeros for the
        warm-up). Eager on the CPU or with ``cuda_graph=False``; else one
        replay of the key's captured program, which its first use warms up
        on inputs that ``inert`` wrote (every row inert) and captures.
        Returns the outputs' ``(layout, buffer)``."""
        if (kind, key) not in self._statics:
            layout, out_layout = ByteLayout(inputs), ByteLayout(outputs)
            buf, out_buf = layout.empty(self.device), out_layout.empty(self.device)
            x = {**layout.views(buf), **out_layout.views(out_buf)}
            self._statics[(kind, key)] = layout, buf, out_layout, out_buf, x
        layout, buf, out_layout, out_buf, x = self._statics[(kind, key)]

        def upload(write, device_src=None):
            host = layout.empty("cpu", pin_memory=buf.is_cuda).zero_()
            write(layout.views(host))
            buf.copy_(host, non_blocking=buf.is_cuda)
            if device_src is not None:
                out_buf.copy_(device_src)
            elif device_in is not None:
                out_buf.zero_()

        family = self._families.get(kind)
        if family is None:
            upload(fill, device_in)
            body(x)
            return out_layout, out_buf
        program, new = family.get(key, lambda: body(x))
        if new:
            upload(inert)
            program.warmup()
            program.capture()
        upload(fill, device_in)
        program.replay()
        return out_layout, out_buf

    def _request_seed(self, req: Request) -> int:
        """A request's seed (JAX's ``_request_key``): its own ``key``; for a
        fork branch ``derive_request_seed(session, branch_index)``, the
        session being the fork's ``key`` or ``derive_request_seed(engine
        seed, branch 0's admission index)``; else ``derive_request_seed(engine
        seed, admission index)``."""
        if req.key is not None:
            return int(req.key)
        if req.fork is not None:
            session = req.fork.session_key
            if session is None:
                session = derive_request_seed(self.seed, req.fork.session_admission_index)
            return derive_request_seed(session, req.branch_index)
        return derive_request_seed(self.seed, req.admission_index)

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

    def _row_fields(self, g: int) -> dict:
        """The staged content rows of a ``g``-row program."""
        return {f: ((g,) + tuple(getattr(self.big, f).shape[1:]), getattr(self.big, f).dtype)
                for f in _CORE_FIELDS if getattr(self.big, f) is not None}  # fmt: skip

    def _dispatch_group(self, group) -> None:
        """Bucketed prefill forward + first-event sample + admission into the
        slots: one prefill program of key (bucket, group width); the group
        padded to the width as JAX's ``_group_arrays`` pads it, with inert
        rows (no content, ``plen`` 1, budget 1, seed 0). The pad rows are
        aimed at distinct slots outside the group, whose contents the
        admission writes back unchanged (`_admit_rows`). A paged engine plans
        the group's blocks on the host first (`_plan_admission_tables`) and
        stages its read and scatter tables. A fork group is staged as its
        branches' independent submissions would be, one copy of the prompt
        a branch (JAX runs the prompt's forward once, at batch 1, which need
        not give a row the bits a group's forward gives it); its scatter
        table lets only branch 0 write the shared blocks."""
        reqs, n, g = group.requests, len(group.requests), group.group_size
        taken = set(group.slots)
        slots = list(group.slots) + [s for s in range(self.n_slots) if s not in taken][: g - n]
        fields, stage = self._stage_group(reqs, g)
        fields["slot"] = ((g,), torch.int32)
        tables = None
        if self.paged_kv:
            tables = self._plan_admission_tables(group)
            fields.update({k: ((g, self.max_len // self.block_size), torch.int32)
                           for k in ("read_table", "scatter_table")})  # fmt: skip

        def inert(x):
            stage(x, inert=True)
            x["slot"].copy_(torch.arange(g))

        def fill(x):
            stage(x)
            x["slot"].copy_(torch.tensor(slots))
            if tables is not None:
                x["read_table"].copy_(torch.from_numpy(tables[0]))
                x["scatter_table"].copy_(torch.from_numpy(tables[1]))

        body = lambda x: self._prefill_admit(group.bucket_len, x)  # noqa: E731
        self._run_program("prefill", (group.bucket_len, g), fields, {}, body, fill, inert)
        for r, s in zip(reqs, group.slots):
            self._table[s] = r
            self._slot_epoch[s] = self._dispatched_chunks

    def _stage_group(self, reqs: list, g: int) -> tuple:
        """A prefill group's staged inputs: ``(fields, stage)``, the layout of
        its ``g`` content rows, ``plen``, ``budget``, ``seed`` and ``valid``,
        and ``stage(views, inert=False)``, which writes the requests' rows
        after inert ones (no content, ``plen`` 1, budget 1, seed 0, not
        valid: JAX's ``_group_arrays`` padding); ``inert`` writes only those."""
        n = len(reqs)
        fields = self._row_fields(g)
        fields.update({k: ((g,), torch.int32) for k in ("plen", "budget", "seed")})
        fields["valid"] = ((g,), torch.bool)

        def stage(x, inert=False):
            x["plen"].fill_(1)
            x["budget"].fill_(1)
            if inert:
                return
            for i, r in enumerate(reqs):
                self._stage_prompt(x, i, r.prompt)
            x["plen"][:n] = torch.tensor([r.prompt_len for r in reqs])
            x["budget"][:n] = torch.tensor([r.max_new_events for r in reqs])
            x["seed"][:n] = torch.tensor([_int32_word(self._request_seed(r)) for r in reqs])
            x["valid"][:n] = True

        return fields, stage

    def _staged_rows(self, x: dict) -> EventStreamBatch:
        return EventStreamBatch(**{f: x.get(f) for f in _CORE_FIELDS})

    def _prefill_admit(self, bucket_len: int, x: dict) -> None:
        """The prefill program (JAX's ``_prefill_ci``: ``_prefill_forward_ci``
        then ``_admit``; paged, ``_prefill_paged``; spec, ``_prefill_spec_ci``;
        NA, ``_prefill_na``; NA spec, ``_prefill_spec_na``) on the staged
        group ``x``: `_prefill_compute`, then `_admit`."""
        self._admit({**x, **self._prefill_compute(bucket_len, x)})

    def _prompt_forward(self, model, cfg, view: EventStreamBatch, last: torch.Tensor, **kw) -> tuple:
        """``model``'s forward of the prompt rows ``view`` on a fresh float
        cache of ``max_len`` positions (an NA model's with its dep-graph
        history seeded from each row's event ``last``): the output, the
        stacked keys and values ``(layers, rows, H, max_len, D)``, the cache
        mask and an NA model's dep-graph caches."""
        past = init_kv_caches(cfg, view.batch_size, self.max_len, self.device)
        if self._na:
            out = model(view, past=NAPast(seq_past=past), use_cache=True, last_event_index=last, **kw)
            seq, dep = out.past_key_values.seq_past, out.past_key_values.dep_graph_past
        else:
            out = model(view, past=past, use_cache=True)
            seq, dep = out.past_key_values, None
        kv = [torch.stack([getattr(c, w) for c in seq]) for w in ("key", "value")]
        return out, kv, seq[0].mask, dep

    def _prefill_compute(self, bucket_len: int, x: dict) -> dict:
        """The compute half of the prefill (JAX's ``_prefill_forward_ci`` /
        ``_prefill_forward_na``, and for spec engines
        ``_prefill_forward_*_spec`` and ``_prefill_draft_forward``) on the
        staged group ``x``: the model forward of the rows' first
        ``bucket_len`` events on a fresh float cache (an NA model's with its
        dep-graph history seeded from each row's last prompt event,
        ``last_event_index``), the first event of each row sampled (counter
        0 of its stream: a spec engine's event 0) and written after its
        prompt into the staged rows, in place (NA: its time, then the level
        walk over the prefill's dep-graph caches); a spec engine's draft
        forward of the same prompt rows (an NA draft's dep-graph caches then
        walk the first event's levels teacher-forced, and the target's
        contextualized embeddings of the last prompt event are the first
        history heads). Returns the tensors `_admit` takes beside ``x``:
        ``first`` (each first event's mask), ``key`` / ``value`` / ``mask``
        and, as they apply, ``dep_*``, ``draft_*`` and ``history``."""
        pbig = self._staged_rows(x)
        view = pbig.slice((slice(None), slice(0, bucket_len)))
        plen64, seeds = x["plen"].long(), x["seed"].long()
        last = plen64 - 1
        na_spec = self._na and self.spec is not None
        kw = {"return_contextualized": True} if na_spec else {}
        out, (key, value), mask, dep = self._prompt_forward(self._model, self.config, view, last, **kw)
        h = dict(key=key, value=value, mask=mask)
        preds = out.preds
        if self._na:  # level 0: the time to the event
            preds = GenerativeSequenceModelPredictions(time_to_event=preds.time_to_event)
        counter = torch.zeros_like(seeds)
        sample = self._sample_rows(_slice_preds_at(preds, last), take_event(pbig.event_mask, last), seeds, counter)
        append_new_event(pbig, sample, self.config, plen64)
        if self._na:
            dep, _ = self._level_walk(pbig, plen64, dep, seeds, counter)
            h.update(dep_key=torch.stack([c.key for c in dep]), dep_value=torch.stack([c.value for c in dep]),
                     dep_mask=dep[0].mask)  # fmt: skip
        else:
            update_last_event_data(pbig, sample, self.config, plen64 + 1, self._to_fill)
        h["first"] = sample.event_mask
        if self.spec is not None:
            _, (dkey, dvalue), dmask, ddep = self._prompt_forward(self._draft, self.spec.config, view, last)
            h.update(draft_key=dkey, draft_value=dvalue, draft_mask=dmask)
            if self._na:
                ddep, _, _ = self._walk(self._draft, pbig, plen64, ddep, mask_levels=True)
                h.update(draft_dep_key=torch.stack([c.key for c in ddep]),
                         draft_dep_value=torch.stack([c.value for c in ddep]), draft_dep_mask=ddep[0].mask,
                         history=torch.stack([take_event(ctx, last) for ctx in out.contextualized]))  # fmt: skip
        return h

    def _admit(self, x: dict) -> None:
        """The admission scatter (JAX's ``_admit``, and ``_admit_draft`` for
        a spec engine): the staged rows of ``x`` (their first event written)
        into slots ``x["slot"]``, whole rows; the prefill's keys and values
        ``x["key"]`` / ``x["value"]`` (``(layers, rows, H, max_len, D)``, in
        the compute dtype) and ``x["mask"]`` into the slot planes or, paged,
        into the blocks of ``x["scatter_table"]`` with ``x["read_table"]`` as
        the slots' block tables (quantized for an int8 or fp8 cache); an NA
        model's dep-graph caches as whole rows (JAX's ``_scatter_caches``, no
        length a row); then cursors, budget, seed and counter, flags; a spec
        engine's draft cache seed into the draft's planes, its counts zeroed,
        and an NA spec engine's draft dep-graph caches and history heads
        ``(layers, rows, hidden)``. Rows not ``x["valid"]`` write back what
        their slots hold."""
        pbig = self._staged_rows(x)
        plen, budget = x["plen"], x["budget"]
        slots, valid = x["slot"].long(), x["valid"]
        for f in _CORE_FIELDS:
            if f in x:
                _admit_rows(getattr(self.big, f), x[f], slots, valid)
        self._admit_planes(self._planes(), (x["key"], x["value"]), x, slots, valid)
        if self.paged_kv:
            _admit_rows(self.block_table, x["read_table"], slots, valid)
        if self._na:
            _admit_rows(self.dep_key, x["dep_key"], slots, valid, dim=1)
            _admit_rows(self.dep_value, x["dep_value"], slots, valid, dim=1)
            _admit_rows(self.dep_mask, x["dep_mask"], slots, valid)
        cursor1 = plen + 1
        n_gen1 = x["first"].to(torch.int32)
        admitted = (
            (self.cache_mask, x["mask"]),
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
        if self.spec is not None:
            self._admit_planes(self._planes(draft=True), (x["draft_key"], x["draft_value"]), x, slots, valid)
            admitted += ((self.draft_cache_mask, x["draft_mask"]), (self.draft_cache_len, plen),
                         (self.spec_proposed, 0), (self.spec_accepted, 0))  # fmt: skip
            if self._na:
                _admit_rows(self.draft_dep_key, x["draft_dep_key"], slots, valid, dim=1)
                _admit_rows(self.draft_dep_value, x["draft_dep_value"], slots, valid, dim=1)
                _admit_rows(self.draft_dep_mask, x["draft_dep_mask"], slots, valid)
                _admit_rows(self.spec_history, x["history"], slots, valid, dim=1)
        for dst, src in admitted:
            _admit_rows(dst, src, slots, valid)

    def _admit_planes(self, planes: tuple, kv: list, x: dict, slots, valid) -> None:
        """A group's prefill keys and values into cache ``planes`` (`_planes`):
        the slot rows or, paged, the blocks of ``x["scatter_table"]``,
        quantized on admission for an int8 or fp8 cache."""
        keys, values, key_scale, value_scale = planes
        for plane, scale, rows_kv in zip((keys, values), (key_scale, value_scale), kv):
            rows_scale = None
            if scale is not None:  # quantize on admission: the prefill ran on float caches
                rows_kv, rows_scale = quantize_kv(rows_kv, plane.dtype)
            if self.paged_kv:
                self._scatter_blocks(plane, rows_kv, x["scatter_table"])
                if scale is not None:
                    self._scatter_blocks(scale, rows_scale, x["scatter_table"])
                continue
            if scale is not None:
                _admit_rows(scale, rows_scale, slots, valid, dim=1)
            _admit_rows(storage(plane), storage(rows_kv), slots, valid, dim=1)

    def _scatter_blocks(self, pool: torch.Tensor, rows: torch.Tensor, table: torch.Tensor) -> None:
        """JAX's ``_scatter_kv_paged`` on one pool: block ``j`` of staged row
        ``i`` (positions ``j * block_size`` on of ``rows[:, i]``, ``(layers,
        rows, H, max_len, ...)``) written to physical block ``table[i, j]`` of ``pool``
        ``(layers, num_blocks, H, block_size, ...)``, all layers at once. An
        entry 0 is dropped: it writes back what the zero block holds (a pad
        row, an unallocated entry, a shared block a fork's branch 0 lands)."""
        g, T = table.shape
        L, _, H = rows.shape[:3]
        rows = storage(rows)
        blocks = rows.reshape(L, g, H, T, self.block_size, *rows.shape[4:]).transpose(2, 3)
        blocks = blocks.reshape(L, g * T, H, self.block_size, *rows.shape[4:])
        phys = table.reshape(-1).long()
        keep = (phys != 0).view(1, -1, *[1] * (blocks.ndim - 2))
        dst = storage(pool)
        dst.index_copy_(1, phys, torch.where(keep, blocks, dst.index_select(1, phys)))

    # ------------------------------------------------ prefill-stream handoff
    def _handoff_fields(self, g: int) -> dict:
        """The layout of a ``g``-row `PrefillHandoff` (each name prefixed
        ``h_``): the content rows, ``plen``, ``budget``, ``seed``, ``valid``,
        ``first`` and what `_prefill_compute` returns, at this engine's
        shapes; two engines with the same model, template and ``max_len``
        give the same layout."""
        cfg, G = self.config, self._n_levels + 1
        planes = (cfg.num_hidden_layers, g, cfg.num_attention_heads, self.max_len, cfg.head_dim)
        fields = self._row_fields(g)
        fields.update({k: ((g,), torch.int32) for k in ("plen", "budget", "seed")})
        fields.update({k: ((g,), torch.bool) for k in ("valid", "first")})
        fields.update(key=(planes, self.cdt), value=(planes, self.cdt), mask=((g, self.max_len), torch.bool))
        if self._na:
            dep = planes[:3] + (G, cfg.head_dim)
            fields.update(dep_key=(dep, self.cdt), dep_value=(dep, self.cdt), dep_mask=((g, G), torch.bool))
        if self.spec is not None:
            d = self.spec.config
            dplanes = (d.num_hidden_layers, g, d.num_attention_heads, self.max_len, d.head_dim)
            fields.update(draft_key=(dplanes, d.compute_dtype), draft_value=(dplanes, d.compute_dtype),
                          draft_mask=((g, self.max_len), torch.bool))  # fmt: skip
            if self._na:
                ddep = dplanes[:3] + (G, d.head_dim)
                fields.update(draft_dep_key=(ddep, d.compute_dtype), draft_dep_value=(ddep, d.compute_dtype),
                              draft_dep_mask=((g, G), torch.bool),
                              history=((cfg.num_hidden_layers, g, cfg.hidden_size), self.cdt))  # fmt: skip
        return {f"h_{k}": v for k, v in fields.items()}

    def _prefill_compute_into(self, bucket_len: int, x: dict) -> None:
        """The ``prefill_compute`` program: `_prefill_compute` on the staged
        group, everything `_admit` reads written into the handoff outputs."""
        h = self._prefill_compute(bucket_len, x)
        for k in [f for f in _CORE_FIELDS if f in x] + ["plen", "budget", "seed", "valid"]:
            x[f"h_{k}"].copy_(x[k])
        for k, v in h.items():
            x[f"h_{k}"].copy_(v)

    @torch.inference_mode()
    def prefill_compute(self, requests: list, bucket_len: int, group: int) -> PrefillHandoff:
        """Runs the bucketed prefill forward and the first event's draw for
        ``requests`` on THIS engine without touching its slot state (JAX's
        ``prefill_compute``, the dedicated prefill stream's compute half):
        one call of the ``prefill_compute`` program of key (``bucket_len``,
        ``group``), padded to ``group`` rows as a local prefill is. Returns a
        `PrefillHandoff` holding a device copy of the outputs; a decode
        engine's `admit_prefilled` turns it into the slot state a local
        prefill gives. Every request must carry its ``key`` (the service
        binds them at accept time)."""
        if self.paged_kv:
            raise NotImplementedError(_PAGED_STREAM)
        for r in requests:
            if r.key is None:
                raise ValueError(
                    "prefill_compute requires explicit request keys (the service/fleet assign them at accept "
                    "time); a key derived from the prefill replica's base key would not survive the cross-engine "
                    "handoff"
                )
        g = int(group)
        if not 1 <= len(requests) <= g:
            raise ValueError(f"{len(requests)} requests for a prefill group of width {g}")
        fields, stage = self._stage_group(list(requests), g)
        body = lambda x: self._prefill_compute_into(bucket_len, x)  # noqa: E731
        layout, out = self._run_program("prefill_compute", (bucket_len, g), fields, self._handoff_fields(g), body,
                                        stage, lambda x: stage(x, inert=True))  # fmt: skip
        self._prefill_computes += 1
        return PrefillHandoff(list(requests), g, layout, out.clone(), has_draft=self.spec is not None)

    @torch.inference_mode()
    def admit_prefilled(self, handoff: PrefillHandoff, slots: list) -> None:
        """Scatters a `PrefillHandoff` into this engine's ``slots`` (JAX's
        ``admit_prefilled``): one call of the ``admit`` program of the
        handoff's group width, which reads the handoff's buffer and runs the
        admission alone, the draft's and quantize-on-admit included. The pad
        rows aim at slots outside ``slots`` and write back what they hold."""
        if self.paged_kv:
            raise NotImplementedError(_PAGED_HANDOFF)
        n, g = len(handoff.requests), handoff.group
        if len(slots) != n:
            raise ValueError(f"{n} handoff rows need {n} slots, got {len(slots)}")
        if handoff.has_draft != (self.spec is not None):
            raise ValueError(
                "prefill-stream handoff/engine spec-mode mismatch: a speculative decode replica needs the draft "
                "cache seed in the handoff (and a non-spec replica cannot admit one) — pair spec targets with a "
                "spec-configured prefill stream"
            )
        fields = self._handoff_fields(g)
        if handoff.layout.fields != fields:
            raise ValueError("the handoff's layout is not this engine's: build both engines alike")
        taken = set(slots)
        padded = list(slots) + [s for s in range(self.n_slots) if s not in taken][: g - n]

        def fill(x):
            x["slot"].copy_(torch.tensor(padded))

        body = lambda x: self._admit({**{k[2:]: v for k, v in x.items() if k.startswith("h_")}, "slot": x["slot"]})  # noqa: E731
        self._run_program("admit", g, {"slot": ((g,), torch.int32)}, fields, body, fill,
                          lambda x: x["slot"].copy_(torch.arange(g)), device_in=handoff.buffer)  # fmt: skip
        self._handoffs_admitted += 1
        for r, s in zip(handoff.requests, slots):
            self._table[s] = r
            self._slot_epoch[s] = self._dispatched_chunks

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
        of their group width (padded with slot 0; as wide as the rows when the
        scheduler's largest group is narrower, as in JAX), copied to the host
        once: ``({slot: one-row CPU batch trimmed to its events}, {slot:
        (cursor, base_len, n_generated)})``."""
        g = max(self.scheduler.group_size_for(len(fetch_slots)), len(fetch_slots))
        fields = self._row_fields(g)
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

    # ------------------------------------------------------ block planning
    def _free_slot_blocks(self, slot: int) -> None:
        """Releases the blocks the slot's previous tenant held (the deferred
        free, `BlockAllocator`); at re-admission."""
        row = self._tables[slot]
        held = [int(b) for b in row if b != 0]
        if held:
            self._block_alloc.decref(held)
        row[:] = 0

    def _plan_admission_tables(self, group) -> tuple[np.ndarray, np.ndarray]:
        """Host block planning for one admission group (JAX's
        ``_plan_admission_tables``): frees the target slots' previous
        blocks, allocates each row's ``prompt + budget`` events, and returns
        the ``(read, scatter)`` tables, ``(group width, max_len //
        block_size)`` int32. A fork group allocates the prompt's whole
        blocks once (refcount ``n_branches``) and each branch its partial
        prompt block and generation tail: decode's first write lands at
        ``plen >= n_full * block_size``, so shared blocks stay frozen."""
        g, bs = group.group_size, self.block_size
        T = self.max_len // bs
        alloc = self._block_alloc
        read = np.zeros((g, T), np.int32)
        scat = np.zeros((g, T), np.int32)
        covers = [min(r.prompt_len + r.max_new_events, self.max_len) for r in group.requests]
        blocks_per_row = [-(-c // bs) for c in covers]
        for s in group.slots:
            self._free_slot_blocks(s)
        n_full = group.requests[0].prompt_len // bs if group.fork is not None else 0
        need = sum(blocks_per_row) - n_full * max(len(group.requests) - 1, 0)
        if need > alloc.free_blocks:
            raise RuntimeError(
                f"block pool exhausted planning an admission: need {need} blocks, {alloc.free_blocks} free of "
                f"{alloc.num_blocks - 1} usable (size the pool with num_blocks >= n_slots * (max_len // block_size) "
                "+ 1 for worst-case occupancy)"
            )
        shared = []
        if group.fork is not None:
            shared = alloc.alloc(n_full)
            if len(group.requests) > 1:
                alloc.incref(shared, len(group.requests) - 1)
        for i, (s, cover, n) in enumerate(zip(group.slots, covers, blocks_per_row)):
            read[i, :n_full] = shared
            read[i, n_full:n] = alloc.alloc(n - n_full)
            # Branches after the first never write the shared prefix: each
            # shared block is admitted once, by branch 0.
            lo = 0 if i == 0 else n_full
            scat[i, lo:n] = read[i, lo:n]
            self._tables[s, :] = read[i]
            alloc.note_cover(cover, n)
        return read, scat

    # ---------------------------------------------------------- host pieces
    def _harvest(
        self, boundary: np.ndarray, chunk_index: int, now: float, fetch_results: bool = True
    ) -> list[EngineResult]:
        """Harvests slots whose request finished (rows: done, cursor, base_len,
        n_generated, health; spec: proposed, accepted), admitted before chunk ``chunk_index`` was
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
            spec_proposed = spec_accepted = 0
            if self.spec is not None:
                # This tenant's proposals and accepted events (zeroed at its
                # admission); the scheduler keeps the engine-wide totals.
                spec_proposed, spec_accepted = int(boundary[5][s]), int(boundary[6][s])
                self.scheduler.note_spec_harvest(proposed=spec_proposed, accepted=spec_accepted,
                                                 committed=int(boundary[1][s]) - int(boundary[2][s]))  # fmt: skip
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
                    spec_proposed=spec_proposed,
                    spec_accepted=spec_accepted,
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

    def fork(
        self,
        prompt: EventStreamBatch,
        n_branches: int,
        max_new_events: int,
        *,
        key: Optional[int] = None,
        request_id=None,
        request_ids=None,
        arrival_time: float = 0.0,
    ) -> list[Request]:
        """Submits one prompt as ``n_branches`` copy-on-write branches (JAX's
        ``fork``): one prefill lands the prompt in refcounted blocks, each
        branch holds only its partial prompt block and generation tail, and
        branch ``j`` draws from ``derive_request_seed(session, j)``, so each
        result equals an independent submission of the prompt with that
        ``key`` bit for bit. ``key`` is the session seed; without it the
        session is ``derive_request_seed(engine seed, branch 0's admission
        index)``, what an independent submission of branch 0 would bind.
        Results carry ``(request_id, j)``, or ``request_ids[j]``. The group
        is queued whole or not at all (`AdmissionRejected`) and admitted in
        one dispatch, strict FIFO."""
        if not self.paged_kv:
            raise ValueError(
                "fork() needs the paged KV cache (paged_kv=True): branched rollouts share prefix blocks "
                "copy-on-write, which the monolithic per-slot cache cannot express"
            )
        n_branches = int(n_branches)
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        if request_ids is not None:
            if request_id is not None:
                raise ValueError("pass request_id or request_ids, not both")
            if len(request_ids) != n_branches:
                raise ValueError(f"request_ids has {len(request_ids)} entries for {n_branches} branches")
        if n_branches > self.n_slots:
            raise ValueError(
                f"a fork group admits atomically: n_branches ({n_branches}) cannot exceed n_slots ({self.n_slots})"
            )
        sched = self.scheduler
        if sched.max_pending is not None and len(sched.queue) + n_branches > sched.max_pending:
            sched._rejected += 1
            raise AdmissionRejected(
                f"admission queue cannot hold a {n_branches}-branch fork group ({len(sched.queue)}/"
                f"{sched.max_pending}); rejecting the whole group (branches admit atomically)"
            )
        spec = ForkSpec(group_id=self._next_fork_group, n_branches=n_branches, session_key=key)
        self._next_fork_group += 1
        out = []
        for j in range(n_branches):
            rid = request_ids[j] if request_ids is not None else (None if request_id is None else (request_id, j))
            r = Request(prompt=prompt, max_new_events=max_new_events, request_id=rid, arrival_time=arrival_time,
                        fork=spec, branch_index=j)  # fmt: skip
            # Branch 0's check at the door covers the shared prompt.
            r.prompt_validated = bool(out)
            out.append(self.submit(r))
        return out

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
        waits for the device. An installed `reliability.serving_faults`
        plan acts first, keyed on this engine's dispatched-chunk count
        (JAX's order): death raises, a hang sleeps, and poisoned slots get
        `_poison_slots`."""
        if _sfaults.active_serving_fault_plan() is not None:
            _sfaults.maybe_die(self.fault_scope, self._dispatched_chunks)
            _sfaults.maybe_hang(self.fault_scope, self._dispatched_chunks)
            poison = [s for s in _sfaults.poison_slots(self.fault_scope, self._dispatched_chunks)
                      if 0 <= s < self.n_slots and self._table[s] is not None]  # fmt: skip
            if poison:
                self._poison_slots(poison)
        if self._program is not None:
            self._program.replay()
        else:
            self._chunk()
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

    def _poison_slots(self, slots: list[int]) -> None:
        """The ``nan_slot`` fault (JAX's ``_poison_jit``): NaN into each
        slot's ``big.time_delta`` at ``max(cursor - 2, 0)``, the delta behind
        the last committed event. Every forward reads the slot's time as the
        cumulative sum of its row's deltas (`time_from_deltas`, in
        `_trim_to_event`, the spec and prefill windows), so the next one
        embeds a NaN time and the health sentinel quarantines the slot (the
        last event's own delta is overwritten by the next append before any
        forward reads it). An eager indexed write between replays, in place
        (the captured chunk reads ``big`` by address); the slot list is a
        host-to-device copy, which no capture sees. Row-local: co-resident
        slots are untouched."""
        rows = torch.tensor(slots, dtype=torch.long, device=self.device)
        cols = (self.cursor[rows].long() - 2).clamp(min=0)
        self.big.time_delta[rows, cols] = float("nan")

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
        if self.paged_kv:
            # Every block back to the pool (the device tables were zeroed
            # above); the high-water and fragmentation counters and the
            # fork-group ids carry on, as in JAX.
            self._block_alloc.reset_occupancy()
            self._tables[:] = 0
            self.scheduler.block_pool_stats = self._block_pool_stats

    # ---------------------------------------------------- hot weight swap
    @property
    def params(self) -> dict:
        """The live weights as a ``state_dict`` (in the compute dtype; views
        of the tensors the programs read)."""
        return self._model.state_dict()

    @property
    def draft_params(self) -> Optional[dict]:
        """A spec engine's live draft weights as a ``state_dict``, else None."""
        return None if self._draft is None else self._draft.state_dict()

    @staticmethod
    def _check_tree(live: dict, new: dict, what: str, live_name: str) -> None:
        """JAX's tree check on a staged checkpoint: the live names, each at its live shape."""
        missing, extra = sorted(set(live) - set(new)), sorted(set(new) - set(live))
        shapes = [f"{k}: {tuple(new[k].shape)} vs {tuple(v.shape)}" for k, v in live.items()
                  if k in new and tuple(new[k].shape) != tuple(v.shape)]  # fmt: skip
        if missing or extra or shapes:
            raise ValueError(
                f"shadow {what}checkpoint's parameter tree does not match the live {live_name}: missing {missing}, "
                f"unexpected {extra}, shapes {shapes}"
            )

    def _stage(self, live, shadow, state: dict):
        """``state`` copied into ``shadow`` (made once as a copy of the live
        model ``live``), each tensor cast to the live tensor's dtype."""
        if shadow is None:
            shadow = copy.deepcopy(live)
        with torch.no_grad():
            for name, t in shadow.state_dict().items():
                t.copy_(state[name])
        return shadow

    def load_shadow(self, new_params, new_draft_params=None) -> None:
        """Stages ``new_params`` (a ``state_dict``, such as `load_pretrained`'s
        model's) in the shadow weights beside the live ones
        (JAX's ``load_shadow``): cast to the compute dtype where the live
        weights are, with kernel B's stacked layer weights built from them.
        Serving continues on the live weights; `flip` promotes them at a
        drained boundary. A spec engine stages ``new_draft_params`` (the
        draft's ``state_dict``) beside them and `flip` then swaps both at
        once; ``None`` keeps the live draft (a target-only promotion) and
        drops a draft staged for rollback by an earlier promotion."""
        if not self.hot_swap:
            raise RuntimeError(
                "hot_swap is disabled for this engine; construct with hot_swap=True to reserve the shadow weight "
                "buffer"
            )
        self._check_tree(self._model.state_dict(), new_params, "", "weights")
        if new_draft_params is None:
            self._shadow_draft = None
        else:
            if self.spec is None:
                raise ValueError(
                    "new_draft_params on a non-speculative engine; construct with spec=SpecConfig(...) to serve a "
                    "draft model"
                )
            self._check_tree(self._draft.state_dict(), new_draft_params, "draft ", "draft")
            self._shadow_draft = self._stage(self._draft, self._shadow_draft, new_draft_params)
        # A fault plan may garble the staged target (JAX's order: after the draft).
        new_params = _sfaults.maybe_corrupt_shadow(self.fault_scope, new_params)
        self._shadow = self._stage(self._model, self._shadow, new_params)
        self._shadow_stacked = {} if self._unfused else stack_layer_weights(self._shadow.encoder.blocks(), self.cdt)

    @property
    def shadow_loaded(self) -> bool:
        return self._shadow is not None

    @torch.inference_mode()
    def probe_shadow(self) -> Optional[str]:
        """The promotion gate (JAX's ``probe_shadow``): the prefill forward of
        the template's first row (as long as a prompt may be) on the SHADOW
        weights, eagerly, its first event drawn, and every float output
        checked finite; a staged draft's prompt forward too. Returns ``None``
        when healthy, else a reason; runs no captured program and touches no
        live state."""
        if self._shadow is None:
            raise RuntimeError("no shadow checkpoint loaded (call load_shadow first)")
        t = self._template
        Lb = min(t.sequence_length, self.max_prompt_len)
        view = t.slice((slice(0, 1), slice(0, Lb))).map(lambda x: x.to(self.device))
        last = torch.full((1,), Lb - 1, dtype=torch.int64, device=self.device)
        out, kv, _, dep = self._prompt_forward(self._shadow, self.config, view, last)
        preds = out.preds
        if self._na:
            preds = GenerativeSequenceModelPredictions(time_to_event=preds.time_to_event)
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        sample = self._sample_rows(_slice_preds_at(preds, last), take_event(view.event_mask, last), zero, zero)
        outputs = [(f"preds.{k}", x) for k, x in _named_floats(preds)] + [(f"sample.{k}", x) for k, x in
                                                                          _named_floats(sample)]  # fmt: skip
        caches = [("key", kv[0]), ("value", kv[1])] + [(f"dep[{i}].{w}", getattr(c, w)) for i, c in
                                                       enumerate(dep or ()) for w in ("key", "value")]  # fmt: skip
        checks = [(outputs, "prompt-forward outputs"), (caches, "prefill cache values")]
        if self._shadow_draft is not None:
            _, dkv, _, _ = self._prompt_forward(self._shadow_draft, self.spec.config, view, last)
            checks.append(([("key", dkv[0]), ("value", dkv[1])], "draft prefill cache values"))
        for named, what in checks:
            for path, x in named:
                if not bool(torch.isfinite(x).all()):
                    return f"staged shadow checkpoint produced non-finite {what} at {path}"
        return None

    def flip(self) -> None:
        """Promotes the shadow weights (JAX's ``flip``) on a drained engine (no
        resident slots, no boundary in flight; queued requests are fine: they
        prefill after the flip, on the new weights). The contents of every
        live tensor (the model's, kernel B's stacked weights and, when a
        draft was staged, the draft's) are exchanged with the shadow's in
        place, through the scratch buffer on the current stream, so every
        captured program keeps its addresses and replays on the new weights
        with no capture. The old weights stay in the shadow: a second flip
        rolls back."""
        if self._shadow is None:
            raise RuntimeError("no shadow checkpoint loaded (call load_shadow first)")
        if self.occupied or self._inflight:
            raise RuntimeError(
                f"flip requires a drained engine: {self.occupied} resident slots, {len(self._inflight)} in-flight "
                "boundaries — drain (stop admitting, resolve every boundary) before flipping"
            )
        pairs = list(zip(_weights(self._model), _weights(self._shadow)))
        pairs += [(v, self._shadow_stacked[k]) for k, v in self._stacked.items()]
        if self._shadow_draft is not None:
            pairs += list(zip(_weights(self._draft), _weights(self._shadow_draft)))
        with torch.no_grad():
            for live, shadow in pairs:
                tmp = self._swap_scratch[: live.numel() * live.element_size()].view(live.dtype).view(live.shape)
                tmp.copy_(live)
                live.copy_(shadow)
                shadow.copy_(tmp)
        self.weights_version += 1

    def drop_shadow(self) -> None:
        """Releases the shadow weights (the rollback checkpoint)."""
        self._shadow = self._shadow_draft = None
        self._shadow_stacked = {}

    def spec_signature(self) -> tuple:
        """The spec-mode identity replicas must share (JAX's
        ``spec_signature``): ``(greedy, None)`` for a non-spec engine, else
        ``(greedy, (k, value_rtol, value_atol, draft hidden size, draft
        layers))``. Draft weights are compared apart (`serving.fleet._params_mismatch`)."""
        if self.spec is None:
            return (self.greedy, None)
        d = self.spec.config
        return (self.greedy, (self.spec.k, self.spec.value_rtol, self.spec.value_atol, d.hidden_size,
                              d.num_hidden_layers))  # fmt: skip

    # ---------------------------------------------------------- accounting
    def _block_pool_stats(self) -> dict:
        """The block-pool counters `Scheduler.padding_report` merges in (JAX's
        ``_block_pool_stats``); they live on the allocator, so the lifetime
        ones survive `reset`."""
        a = self._block_alloc
        return {
            "block_pool_num_blocks": a.num_blocks,
            "block_pool_block_size": a.block_size,
            "block_pool_in_use": a.in_use,
            "block_pool_free": a.free_blocks,
            "block_pool_high_water": a.high_water,
            "block_pool_utilization": round(a.in_use / max(a.num_blocks - 1, 1), 4),
            "block_pool_shared_blocks": a.shared_blocks(),
            "block_pool_frag_events": a.frag_events,
            "block_pool_frag_frac": round(a.frag_events / max(a.frag_events + a.cover_events, 1), 4),
            "block_pool_allocs_total": a.allocs_total,
            "block_pool_frees_total": a.frees_total,
        }

    def _paged_report(self, branch_factor: int = 1, pool_budget_bytes: int | None = None) -> dict:
        """Block-granular capacity of the paged engine (JAX's
        ``_paged_report``): ``effective_slots`` measured from the resident
        tables (usable blocks over the mean unique blocks a resident row
        holds; branches sharing a prefix shrink that mean), and
        ``effective_slots_at_branch_factor`` for a full-table tenant whose
        prompt (all but one block) is shared ``branch_factor`` ways."""
        cfg, a = self.config, self._block_alloc
        T = self.max_len // self.block_size
        usable = a.num_blocks - 1
        bpb = paged_kv_bytes_per_block(cfg.num_hidden_layers, cfg.num_attention_heads, self.block_size, cfg.head_dim,
                                       cache_dtype_name(self._kv_buf_dtype), cfg.compute_dtype)  # fmt: skip
        resident_rows = int((self._tables != 0).any(axis=1).sum())
        logical_blocks = int((self._tables != 0).sum())
        unique_blocks = a.in_use
        if resident_rows:
            effective = usable / max(unique_blocks / resident_rows, 1e-9)
        else:
            effective = float(usable) / max(T, 1)
        B = max(int(branch_factor), 1)
        per_branch = (T - 1) / B + 1
        return {
            "pool_budget_bytes": pool_budget_bytes,
            "max_pool_blocks_in_budget": None if pool_budget_bytes is None else int(pool_budget_bytes // bpb),
            "block_size": self.block_size,
            "num_blocks": a.num_blocks,
            "blocks_per_slot": T,
            "bytes_per_block": bpb,
            "pool_bytes": usable * bpb,
            "blocks_in_use": unique_blocks,
            "pool_utilization": round(unique_blocks / max(usable, 1), 4),
            "high_water": a.high_water,
            "resident_rows": resident_rows,
            "sharing_ratio": round(logical_blocks / max(unique_blocks, 1), 3),
            "effective_slots": round(effective, 2),
            "effective_slots_at_branch_factor": round(usable / per_branch, 2),
            "branch_factor": B,
        }

    def slots_report(
        self, hbm_gb: float | None = None, config: StructuredTransformerConfig | None = None,
        max_len: int | None = None, params_bytes: int | None = None, branch_factor: int = 1,
    ) -> dict:  # fmt: skip
        """Device-memory capacity of each cache dtype (`ops.kv_quant.CACHE_DTYPES`),
        allocating nothing: the sequence-cache bytes a slot pins at ``max_len``
        (planes, scale tables, mask) and the most slots that fit a budget of
        ``hbm_gb`` GB net of the engine's resident weights (the model in the
        compute dtype and the stacked layer weights kernel B reads) and each
        slot's other state (content rows, cursors, streams; an NA engine's
        dep-graph caches, float under every cache dtype, as JAX's state
        holds them: a mask and an int32 length a layer), as the JAX engine's
        `slots_report` counts them; a paged engine adds ``paged``
        (`_paged_report` at ``branch_factor``, the pool against the same
        budget). A spec engine charges the draft as JAX does: its weights
        (``draft_params_bytes``, every parameter of the draft, shared ones
        too) against the budget and its cache row at the active cache dtype
        (``draft_kv_bytes_per_slot``) against every slot. ``hbm_gb`` defaults
        to the engine device's own memory; on the CPU it must be given.
        Under ``hot_swap`` the shadow weights are charged from construction
        on, as in JAX: ``params_bytes`` and ``draft_params_bytes`` double
        (once; the paged report's budget takes them as they are), and the
        flip's scratch buffer (``swap_scratch_bytes``, the largest live
        tensor) comes off the budget beside them.

        ``config``, ``max_len`` and ``params_bytes`` override the engine's
        own geometry, as in JAX (its width ladder reads capacity through
        them): the cache bytes follow ``config`` and ``max_len``, the row
        bytes measured on this engine are scaled by the ``max_len`` ratio,
        and ``params_bytes`` replaces the resident weights."""
        if hbm_gb is None:
            if self.device.type != "cuda":
                raise ValueError("slots_report: pass hbm_gb for an engine that is not on a CUDA device")
            hbm_gb = torch.cuda.get_device_properties(self.device).total_memory / 1e9
        cfg = self.config if config is None else config
        max_len = self.max_len if max_len is None else int(max_len)

        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors if t is not None)

        rest = [getattr(self.big, f) for f in _CORE_FIELDS]
        rest += [self.cursor, self.base_len, self.budget, self.n_generated, self.done, self.live, self.health,
                 self.seeds, self.counters, self.active_steps, self.dep_key, self.dep_value]  # fmt: skip
        state = nbytes(rest)
        if self._na:  # JAX's dep-graph caches hold a mask and a length a layer
            state += self.dep_key.shape[0] * (nbytes([self.dep_mask]) + 4)
        row_bytes = max(state // self.n_slots, 1)
        if max_len != self.max_len:
            row_bytes = max(int(row_bytes * max_len / self.max_len), 1)
        if params_bytes is None:
            params_bytes = nbytes(list(self._model.parameters()) + list(self._model.buffers())
                                  + list(self._stacked.values()))  # fmt: skip
        active = cache_dtype_name(self._kv_buf_dtype)
        draft_params_bytes = draft_kv = 0
        if self.spec is not None:
            draft_params_bytes = nbytes(list(self._draft.parameters()) + list(self._draft.buffers()))
            d = self.spec.config
            draft_kv = kv_cache_bytes_per_slot(d.num_hidden_layers, d.num_attention_heads, max_len, d.head_dim,
                                               active, d.compute_dtype)  # fmt: skip
        scratch = 0
        if self.hot_swap:
            params_bytes, draft_params_bytes = 2 * params_bytes, 2 * draft_params_bytes
            scratch = nbytes([self._swap_scratch])
        budget = max(int(hbm_gb * 1e9) - params_bytes - draft_params_bytes - scratch, 0)
        per_dtype = {}
        for name in CACHE_DTYPES:
            kv = kv_cache_bytes_per_slot(cfg.num_hidden_layers, cfg.num_attention_heads, max_len, cfg.head_dim,
                                         name, cfg.compute_dtype)  # fmt: skip
            per_dtype[name] = {"kv_bytes_per_slot": kv, "max_slots": int(budget // (kv + row_bytes + draft_kv))}
        return {
            "paged_kv": self.paged_kv,
            "paged": self._paged_report(branch_factor, budget) if self.paged_kv else None,
            "kv_cache_dtype": active,
            "hbm_budget_gb": hbm_gb,
            "hot_swap": self.hot_swap,
            "params_bytes": params_bytes,
            "swap_scratch_bytes": scratch,
            "spec": self.spec is not None,
            "draft_params_bytes": draft_params_bytes,
            "draft_kv_bytes_per_slot": draft_kv,
            "row_bytes_per_slot": row_bytes,
            "per_dtype": per_dtype,
            "slots_per_chip_ratio_vs_bf16": round(
                per_dtype[active]["max_slots"] / max(per_dtype["bf16"]["max_slots"], 1), 3
            ),
        }

    def program_stats(self) -> dict:
        """Captures and replays of the engine's programs: ``graph_*`` the
        decode (or spec) chunk's; ``prefill_*``, ``extract_*``,
        ``prefill_compute_*`` and ``admit_*`` those of the prefill (bucket,
        group width), extraction (group width), prefill-stream compute
        (bucket, group width) and handoff admission (group width) keys, with
        the keys' count (zeros when nothing is captured)."""
        out = {
            "cuda_graph": self._program is not None,
            "graph_warmup_chunks": 0 if self._program is None else self._program.warmups,
            "graph_captures": 0 if self._program is None else self._program.captures,
            "graph_replays": 0 if self._program is None else self._program.replays,
        }
        for kind in _PROGRAM_KINDS:
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
                "decode_step_impl": self.decode_step_impl,
                **self.program_stats(),
                "prefill_computes": self._prefill_computes,
                "handoffs_admitted": self._handoffs_admitted,
                "hot_swap": self.hot_swap,
                "weights_version": self.weights_version,
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
        if self.spec is not None:
            report.update(
                {
                    "spec_k": self.spec.k,
                    "spec_rounds": int(self.spec_rounds.item()),
                    "spec_value_rtol": self.spec.value_rtol,
                    "spec_value_atol": self.spec.value_atol,
                    "spec_draft_hidden_size": self.spec.config.hidden_size,
                    "spec_draft_num_layers": self.spec.config.num_hidden_layers,
                }
            )
        return report
