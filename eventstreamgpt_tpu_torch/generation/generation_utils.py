"""The autoregressive generation loop, cohort ``generate()``, and the one-event views the engine shares.

Counterpart: ``eventstreamgpt_tpu/generation/generation_utils.py``
(`GenerationOutput`, `generate`, `_generate_ci`, `_generate_na`,
`_should_stop`, the per-shape program cache ``_STEP_CACHE``, and
`_trim_to_event`, `_slice_preds_at`, `_mask_through_cursor`).

The output batch is preallocated to ``input_len + max_new_events`` events
and every event is written at a cursor, so each program has fixed shapes.
With the caches (``use_cache=True``) a call runs two programs, each the
counterpart of a jitted JAX program:

* the prefix program: the prompt staged into the preallocated batch, the
  prefix forward on fresh caches, and the first event with its whole level
  walk;
* the decode-step program: one event, run ``max_new_events - 1`` times (JAX's
  ``lax.scan`` body). A CI step is the cached one-event forward, the draws
  and the writes; an NA step is the target-0 contextualization and the
  ``G - 1`` level decodes (``G = len(measurements_per_dep_graph_level)``).
  It reads the cursor from a device int32 that it advances in place, and
  the sequence caches take the per-row-cursor write with every row's cursor
  equal (a selection, so the values equal JAX's ``dynamic_update_slice``).

Every tensor the programs read or write outside their temporaries (the
staged prompt, the preallocated batch, the caches, the cursor, the row
seeds) keeps its address for the life of the key's entry in the program
cache (an LRU of 32 keys, as JAX's ``_STEP_CACHE``, keyed on the model
object, held weakly, the config's JSON as JAX keys it, ``B``,
``input_len``, ``max_new_events`` and the prompt's layout). On the card
each program is captured into a CUDA graph at the key's first call
(`utils.graphs.CapturedProgram`: both run
eagerly once as the warm-up, then both are captured, then replayed) and
every call replays them: one host launch for the prefix and one an event.
A stopping criterion (other than `MaxLengthCriteria`, folded into the
bound) replays the same step with a host check between events, one sync
an event as JAX's `_should_stop` has. ``cuda_graph=False`` (and the CPU)
run the same programs eagerly. ``use_cache=False``, JAX's O(T^2)
reference path of full forwards (for NA models, through kernel D on the
card), runs eagerly.

Randomness: row ``b`` draws from ``RowStreams(derive_request_seed(seed,
b), j * G + level)`` at its ``j``-th new event (``G`` = 1 for CI), so a
row's trajectory depends only on ``(seed, b)``, repeated rows of
``num_return_sequences`` differ, and the cached, uncached and stopped runs
draw the same numbers at the same events. Every categorical head is drawn
by kernel A (`ops.fused_sampling.fused_categorical_stream`; on CPU tensors
its plain version, bit for bit ``Categorical.sample(stream)``). JAX's
Threefry chain is not reproduced; greedy draws equal JAX's.

As in JAX, the uncached NA path runs full forwards (target ``None``) at
every level, which the cached walk equals.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import weakref

import torch

from ..data.types import X32, EventStreamBatch
from ..models.config import StructuredEventProcessingMode, StructuredTransformerConfig
from ..models.model_output import GenerativeSequenceModelPredictions
from ..models.transformer import KVCache, NAPast, time_from_deltas
from ..ops.fused_sampling import fused_categorical_stream
from ..ops.tensor_ops import take_event
from ..utils.device import resolve_device
from ..utils.graphs import CapturedProgram
from .sampling import (
    RowStreams,
    append_new_event,
    derive_request_seed,
    measurements_to_fill,
    sample_predictions,
    update_last_event_data,
)
from .stopping_criteria import MaxLengthCriteria, StoppingCriteriaList

# The batch fields with an event axis, preallocated and written at the cursor.
_SEQ_FIELDS = (
    "event_mask",
    "time_delta",
    "dynamic_indices",
    "dynamic_measurement_indices",
    "dynamic_values",
    "dynamic_values_mask",
)
# The per-row fields the model reads besides them, staged with the prompt.
_ROW_FIELDS = ("static_indices", "static_measurement_indices", "start_time")
_NONFINITE = (
    "Non-finite values (NaN/inf) in the prompt batch; generation would propagate them. Clean the inputs or pass "
    "do_validate_batch=False."
)


def _slice_preds_at(preds: GenerativeSequenceModelPredictions, idx) -> GenerativeSequenceModelPredictions:
    """Slices ``(B, L, ...)`` prediction parameters down to event ``idx``: ``(B, ...)``."""
    return preds.map(lambda x: x[:, 0] if x.shape[1] == 1 else take_event(x, idx))


def _trim_to_event(batch: EventStreamBatch, idx) -> EventStreamBatch:
    """A one-event view of the batch at event ``idx`` (per row), with absolute time set."""
    t_full = time_from_deltas(batch)
    return batch.replace(
        event_mask=take_event(batch.event_mask, idx)[:, None],
        time_delta=take_event(batch.time_delta, idx)[:, None],
        time=take_event(t_full, idx)[:, None],
        dynamic_indices=take_event(batch.dynamic_indices, idx)[:, None],
        dynamic_measurement_indices=take_event(batch.dynamic_measurement_indices, idx)[:, None],
        dynamic_values=take_event(batch.dynamic_values, idx)[:, None],
        dynamic_values_mask=take_event(batch.dynamic_values_mask, idx)[:, None],
    )


def _mask_through_cursor(batch: EventStreamBatch, cursor: torch.Tensor) -> EventStreamBatch:
    """Event mask restricted to positions ``< cursor`` (hides the preallocated tail)."""
    positions = torch.arange(batch.sequence_length, device=cursor.device)[None, :]
    return batch.replace(event_mask=batch.event_mask & (positions < cursor[:, None]))


@dataclasses.dataclass
class GenerationOutput:
    """A completed generation plus per-row accounting: ``n_generated`` ``(B,)``
    int32 counts the REAL events each row generated."""

    batch: EventStreamBatch
    n_generated: torch.Tensor
    input_len: int = 0


def _with_accounting(batch: EventStreamBatch, input_len: int) -> GenerationOutput:
    n_gen = batch.event_mask[:, input_len:].sum(dim=1).to(torch.int32)
    return GenerationOutput(batch=batch, n_generated=n_gen, input_len=input_len)


def _batch_nonfinite(batch: EventStreamBatch) -> torch.Tensor:
    """True if any float tensor of the batch holds a NaN or inf (a 0-dim bool tensor)."""
    bad = torch.zeros((), dtype=torch.bool, device=batch.event_mask.device)
    for x in (batch.time_delta, batch.dynamic_values):
        if x is not None:
            bad = bad | ~torch.isfinite(x).all()
    return bad


def _preallocate(batch: EventStreamBatch, max_new_events: int) -> EventStreamBatch:
    """Right-pads the sequence axis with ``max_new_events`` empty events (``time`` dropped)."""

    def pad_seq(x):
        return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2) + (0, max_new_events))

    return batch.replace(time=None, **{f: pad_seq(getattr(batch, f)) for f in _SEQ_FIELDS})


def generate(
    model,
    batch: EventStreamBatch,
    config: StructuredTransformerConfig,
    seed: int = 0,
    max_new_events: int | None = None,
    max_length: int | None = None,
    num_return_sequences: int = 1,
    use_cache: bool = True,
    stopping_criteria: StoppingCriteriaList | None = None,
    do_validate_batch: bool = True,
    mesh=None,
    return_output: bool = False,
    *,
    device=None,
    cuda_graph: bool = True,
) -> EventStreamBatch | GenerationOutput:
    """Autoregressively samples future events (JAX ``generate``).

    Args:
        model: a `CIPPTForGenerativeSequenceModeling` or
            `NAPPTForGenerativeSequenceModeling` whose parameters are on
            ``device`` (they are read where they are, each call).
        batch: the prompt batch, right-aligned real events a row (no
            interior padding), on any device; it is staged onto ``device``.
        config: the model configuration.
        seed: the integer the rows' random streams derive from (JAX's ``key``).
        max_new_events, max_length: the bound; at most one is needed, else
            ``config.max_seq_len - input_len``; a `MaxLengthCriteria` in
            ``stopping_criteria`` bounds it too (the tightest bound holds).
        num_return_sequences: samples a prompt row; the batch is expanded in order.
        use_cache: the cached walk (two programs a call) or full forwards each event.
        stopping_criteria: a `StoppingCriteriaList`, consulted before the loop
            (a criterion the prompt meets returns the prompt) and after every
            completed event.
        do_validate_batch: raise on a non-finite prompt.
        mesh: not ported; raises.
        return_output: return a `GenerationOutput` instead of the bare batch.
        device: where the programs run; ``None`` is the CUDA device.
        cuda_graph: on the card, capture the programs (``False`` runs them eagerly).

    Returns:
        The batch of ``input_len + max_new_events`` events (those past a
        stopping criterion's cut masked), or a `GenerationOutput` around it.
    """
    if batch.segment_ids is not None:
        raise NotImplementedError(
            "generate() requires padded (one subject per row) prompt batches; packed segment_ids rows are a "
            "training/eval layout. De-pack the prompts first."
        )
    if mesh is not None:
        raise ValueError(
            "generate(mesh=...): data-parallel generation over a mesh is not part of the PyTorch port yet "
            "(ROADMAP Queue 1 item 7: meshes and tensor parallelism)"
        )
    device = resolve_device(device, "generate()")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    param = next(model.parameters())
    if param.device != device:
        raise ValueError(f"generate(): the model's parameters are on {param.device}, not {device}; move it first")

    input_len = batch.sequence_length
    if num_return_sequences > 1:
        batch = batch.repeat_batch_elements(num_return_sequences)

    bad_prompt = None
    if do_validate_batch:
        floats = [x for x in (batch.time_delta, batch.dynamic_values) if x is not None]
        if all(x.device.type == "cpu" for x in floats):
            if any(not bool(torch.isfinite(x).all()) for x in floats):
                raise ValueError(_NONFINITE)
        else:  # read after the generation is dispatched
            bad_prompt = _batch_nonfinite(batch)

    def check_prompt():
        if bad_prompt is not None and bool(bad_prompt):
            raise ValueError(_NONFINITE)

    bounds = []
    if stopping_criteria is not None:
        if bool(stopping_criteria(batch, n_events=input_len)):
            check_prompt()
            return _with_accounting(batch, input_len) if return_output else batch
        if stopping_criteria.max_length is not None:
            bounds.append(stopping_criteria.max_length - input_len)
    if max_new_events is not None:
        bounds.append(max_new_events)
    elif max_length is not None:
        bounds.append(max_length - input_len)
    elif not bounds:
        bounds.append(config.max_seq_len - input_len)
    max_new_events = min(bounds)
    if max_new_events <= 0:
        raise ValueError(f"max_new_events must be positive; got {max_new_events}")
    if stopping_criteria is not None and all(isinstance(c, MaxLengthCriteria) for c in stopping_criteria):
        stopping_criteria = None

    try:
        with torch.no_grad():
            program = _programs(model, batch, config, input_len, max_new_events, use_cache, device, cuda_graph)
            result = program.run(batch, seed, stopping_criteria)
    except Exception:
        check_prompt()  # a non-finite prompt's own error, not the downstream failure
        raise
    check_prompt()
    return _with_accounting(result, input_len) if return_output else result


def _should_stop(big: EventStreamBatch, cursor: torch.Tensor, n_events: int, stopping_criteria) -> bool:
    """Consults stopping criteria after a completed event (``n_events`` held a row)."""
    if stopping_criteria is None:
        return False
    return bool(stopping_criteria(_mask_through_cursor(big, cursor), n_events=n_events))


# ------------------------------------------------------------ program cache
_PROGRAMS: collections.OrderedDict = collections.OrderedDict()
_PROGRAMS_MAX = 32


def _layout(batch: EventStreamBatch) -> tuple:
    """The staged fields' trailing shapes and (32-bit) types."""
    out = []
    for name in _SEQ_FIELDS + _ROW_FIELDS:
        x = getattr(batch, name)
        out.append(None if x is None else (name, tuple(x.shape[2 if name in _SEQ_FIELDS else 1 :]), X32.get(x.dtype, x.dtype)))
    return tuple(out)


# The last config signature of each live model (JAX's ``_SIG_CACHE``): a hit
# on the same model and config object does not serialize the config again.
_SIGNATURES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _config_signature(model, config) -> str:
    """The JSON of ``config.to_dict()`` (JAX's ``_model_config_signature``),
    memoized weakly on the model together with the config object it was made
    from, so that another config on the same model gets its own signature."""
    hit = _SIGNATURES.get(model)
    if hit is not None and hit[0]() is config:
        return hit[1]
    sig = json.dumps(config.to_dict(), sort_keys=True, default=str)
    _SIGNATURES[model] = (weakref.ref(config), sig)
    return sig


def _programs(model, batch, config, input_len, max_new_events, use_cache, device, cuda_graph) -> "_Generation":
    """The key's entry of the program cache (LRU, entries of dead models dropped first)."""
    for k in [k for k, v in _PROGRAMS.items() if v.model_ref() is None]:
        del _PROGRAMS[k]
    graphed = device.type == "cuda" and bool(cuda_graph) and use_cache
    key = (id(model), _config_signature(model, config), batch.batch_size, input_len, max_new_events,
           bool(use_cache), _layout(batch), str(device), graphed,
           tuple(p.data_ptr() for p in model.parameters()))  # fmt: skip
    hit = _PROGRAMS.get(key)
    if hit is not None and hit.model_ref() is model:
        _PROGRAMS.move_to_end(key)
        return hit
    entry = _Generation(model, batch, config, input_len, max_new_events, use_cache, device, graphed)
    if len(_PROGRAMS) >= _PROGRAMS_MAX:
        _PROGRAMS.popitem(last=False)
    _PROGRAMS[key] = entry
    return entry


def program_stats(model=None) -> dict:
    """Keys in the program cache (of ``model``'s alone when given), and the
    warm-ups, captures and replays of their programs."""
    entries = [g for g in _PROGRAMS.values() if model is None or g.model_ref() is model]
    progs = [p for g in entries for p in (g.prefix, g.step) if p is not None]
    return {
        "keys": len(entries),
        "warmups": sum(p.warmups for p in progs),
        "captures": sum(p.captures for p in progs),
        "replays": sum(p.replays for p in progs),
    }


class _Generation:
    """One key's buffers and programs (`generate`'s module docs)."""

    def __init__(self, model, batch, config, input_len, max_new_events, use_cache, device, graphed):
        self.model_ref = weakref.ref(model)
        self.config, self.device, self.use_cache = config, device, use_cache
        self.B, self.input_len, self.max_new_events = batch.batch_size, input_len, max_new_events
        total_len = input_len + max_new_events
        self.na = config.structured_event_processing_mode == StructuredEventProcessingMode.NESTED_ATTENTION
        if self.na:
            levels = config.measurements_per_dep_graph_level
            # Level 0 appends the event (its time); level l fills its measurements,
            # frozen in JAX's order (a set built from the sorted names).
            self.to_fill = [None] + [set(sorted(level, key=str)) for level in levels[1:]]
        else:
            self.to_fill = [measurements_to_fill(config)]
        self.n_levels = len(self.to_fill)

        def alloc(x, length=None):
            shape = (self.B, length) + tuple(x.shape[2:]) if length else tuple(x.shape)
            return torch.zeros(shape, dtype=X32.get(x.dtype, x.dtype), device=device)

        self.staged = EventStreamBatch(**{f: alloc(getattr(batch, f)) for f in _SEQ_FIELDS + _ROW_FIELDS
                                          if getattr(batch, f) is not None})  # fmt: skip
        self.big = EventStreamBatch(
            **{f: alloc(getattr(batch, f), total_len) for f in _SEQ_FIELDS},
            **{f: getattr(self.staged, f) for f in _ROW_FIELDS},
        )
        self.cursor = torch.zeros((), dtype=torch.int32, device=device)
        self.seeds = torch.zeros(self.B, dtype=torch.int64, device=device)
        H, D, L = config.num_attention_heads, config.head_dim, config.num_hidden_layers
        cdt = config.compute_dtype

        def planes(length):
            return ([torch.zeros(self.B, H, length, D, dtype=cdt, device=device) for _ in range(L)],
                    [torch.zeros(self.B, H, length, D, dtype=cdt, device=device) for _ in range(L)],
                    torch.zeros(self.B, length, dtype=torch.bool, device=device))  # fmt: skip

        self.prefix = self.step = None
        if use_cache:
            self.seq = planes(total_len)
            self.dep = planes(self.n_levels + 1) if self.na else None
            if graphed:
                pool = torch.cuda.graph_pool_handle()
                self.prefix = CapturedProgram(self._prefix_program, "the generate() prefix program", device=device,
                                              pool=pool)  # fmt: skip
                if max_new_events > 1:
                    self.step = CapturedProgram(self._step_program, "the generate() decode-step program",
                                                device=device, pool=pool)  # fmt: skip

    # ------------------------------------------------------------ pieces
    def _stage(self, batch: EventStreamBatch, seed: int) -> None:
        for f, dst in vars(self.staged).items():
            if dst is not None:
                dst.copy_(getattr(batch, f))
        self.seeds.copy_(torch.tensor([derive_request_seed(seed, b) for b in range(self.B)], dtype=torch.int64))

    def _cur(self) -> torch.Tensor:
        return self.cursor.expand(self.B)

    def _sample_write(self, preds_last, cur: torch.Tensor, level: int) -> None:
        """Draws level ``level`` of the event at ``cur`` (level 0: opens it at
        ``cur`` with the time to it; CI fills its content too) and writes it."""
        big = self.big
        counters = (cur.long() - self.input_len) * self.n_levels + level
        em = take_event(big.event_mask, cur - 1 if level == 0 else cur)
        # Kernel A draws every categorical head, the noise of the head's stream drawn inside.
        sample = sample_predictions(preds_last, em, RowStreams(self.seeds, counters), fused_categorical_stream)
        if level == 0:
            append_new_event(big, sample, self.config, cur)
        to_fill = self.to_fill[level]
        if to_fill:
            update_last_event_data(big, sample, self.config, cur + 1, to_fill)

    def _caches(self, planes, length) -> tuple:
        keys, values, mask = planes
        return tuple(KVCache(k, v, mask, length) for k, v in zip(keys, values))

    @staticmethod
    def _store(planes, presents) -> None:
        keys, values, mask = planes
        for k, v, c in zip(keys, values, presents):
            k.copy_(c.key)
            v.copy_(c.value)
        mask.copy_(presents[0].mask)

    def _forward(self, view, seq_len, dep_len, target):
        """The model's cached forward of ``view``; its new caches stored in place."""
        model = self.model_ref()
        seq = self._caches(self.seq, seq_len)
        if not self.na:
            out = model(view, past=seq, use_cache=True, is_generation=True)
            self._store(self.seq, out.past_key_values)
            return out.preds
        dep = None if dep_len is None else self._caches(self.dep, dep_len)
        out = model(view, past=NAPast(seq_past=seq, dep_graph_past=dep), use_cache=True, is_generation=True,
                    dep_graph_el_generation_target=target)  # fmt: skip
        if target is None or target == 0:
            self._store(self.seq, out.past_key_values.seq_past)
        self._store(self.dep, out.past_key_values.dep_graph_past)
        return out.preds

    def _level_walk(self, cur: torch.Tensor) -> None:
        """NA levels 1 .. G-1 of the event at ``cur``, each decoded against the dep-graph caches."""
        for level in range(1, self.n_levels):
            preds = self._forward(_trim_to_event(self.big, cur), cur, level, level)
            self._sample_write(_slice_preds_at(preds, 0), cur, level)

    # ---------------------------------------------------------- programs
    def _preallocate(self) -> None:
        """The staged prompt, then empty events, in the preallocated batch; the cursor at its end."""
        padded = _preallocate(self.staged, self.max_new_events)
        for f in _SEQ_FIELDS:
            getattr(self.big, f).copy_(getattr(padded, f))
        self.cursor.fill_(self.input_len)

    def _prefix_program(self) -> None:
        """Preallocation, the prefix forward on fresh caches and the first event."""
        n = self.input_len
        self._preallocate()
        for planes in (self.seq, self.dep):
            if planes is not None:
                for x in planes[0] + planes[1] + [planes[2]]:
                    x.zero_()
        cur = self._cur()
        preds = self._forward(self.big.slice((slice(None), slice(0, n))), 0, None, None)
        self._sample_write(_slice_preds_at(preds, n - 1), cur, 0)
        if self.na:
            self._level_walk(cur)
        self.cursor.add_(1)

    def _step_program(self) -> None:
        """One event: the cached forward of the last completed event (NA: target
        0, then the level walk), the draws and the writes."""
        cur = self._cur()
        last = cur - 1
        preds = self._forward(_trim_to_event(self.big, last), last, self.n_levels, 0)
        self._sample_write(_slice_preds_at(preds, 0), cur, 0)
        if self.na:
            self._level_walk(cur)
        self.cursor.add_(1)

    def _full_forward(self, n_events: torch.Tensor):
        """The uncached reference: a full forward of the events before ``n_events``."""
        return self.model_ref()(_mask_through_cursor(self.big, n_events), is_generation=True).preds

    def _uncached_event(self) -> None:
        """One event of full forwards: level 0 reads event ``cur - 1``, a later
        level the event at ``cur`` as far as it is written."""
        cur = self._cur()
        for level in range(self.n_levels):
            at = cur - 1 if level == 0 else cur
            self._sample_write(_slice_preds_at(self._full_forward(at + 1), at), cur, level)
        self.cursor.add_(1)

    # -------------------------------------------------------------- run
    def run(self, batch: EventStreamBatch, seed: int, stopping_criteria) -> EventStreamBatch:
        """One call: stage, run (capturing at the key's first call), return a copy of the result."""
        self._stage(batch, seed)
        if not self.use_cache:
            first, step = (lambda: (self._preallocate(), self._uncached_event())), self._uncached_event
        elif self.prefix is None:
            first, step = self._prefix_program, self._step_program
        else:
            if self.prefix.graph is None:  # warm both up eagerly, then capture both
                for program in (self.prefix, self.step):
                    if program is not None:
                        program.warmup()
                for program in (self.prefix, self.step):
                    if program is not None:
                        program.capture()
            first, step = self.prefix.replay, (self.step.replay if self.step is not None else None)
        first()
        n_events, total = self.input_len + 1, self.input_len + self.max_new_events
        while not _should_stop(self.big, self._cur(), n_events, stopping_criteria) and n_events < total:
            step()
            n_events += 1
        out = _mask_through_cursor(self.big, self._cur())
        fields = {f: getattr(out, f).clone() for f in _SEQ_FIELDS}
        fields.update({f: getattr(self.staged, f).clone() for f in _ROW_FIELDS if getattr(self.staged, f) is not None})
        rest = batch.replace(time=None, **{f: None for f in _SEQ_FIELDS + _ROW_FIELDS}).map(lambda x: x.to(self.device))
        return rest.replace(**fields)
