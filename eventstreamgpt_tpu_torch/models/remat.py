"""Rematerialization (remat) of the encoders' blocks: activations recomputed in the backward.

Counterpart: ``eventstreamgpt_tpu/models/transformer.py`` `_remat_policy` and
`remat_block_cls`. ``config.gradient_checkpointing`` names the policy, and
each layer's block (`InnerBlock` of the CI encoder,
`StructuredTransformerBlock` of the NA encoder) runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``:

* ``"none"``: no remat;
* ``"block"``: the whole block is recomputed in the backward;
* ``"dots_no_batch"``: the outputs of products without batch dimensions
  (``aten.mm`` / ``aten.addmm``: the projections and the MLP) are saved
  (``create_selective_checkpoint_contexts``), everything else recomputed;
* ``"dots"``: batched products (``aten.bmm`` / ``aten.baddbmm``: the band
  and einsum attention scores) are saved as well;
* ``"save_attention"``: ``"dots_no_batch"`` plus the attention output of
  every path (einsum, band, kernels E/F, kernel D), JAX's
  ``ATTENTION_CHECKPOINT_NAME``. The attention runs once, outside the
  recomputed region (its own saved tensors are kept), and the recompute
  takes its output from the `RematTape`: the backward never re-runs an
  attention kernel.

Remat applies where a gradient is taken: with autograd on and no cache. A
kernel launched through ``ctypes`` (E/F, D) is not an ATen operation, so a
selective policy never saves it: under ``"block"``, ``"dots"`` and
``"dots_no_batch"`` it launches again in the recompute, as JAX recomputes
attention there (``bench.py:1438-1442``).

Dropout under recompute. The port draws every keep mask from an explicit
``torch.Generator``, which ``checkpoint``'s ``preserve_rng_state`` does not
restore, so a block's recompute would draw other masks. A `RematTape` sits
between the block and its generator: the forward draws each mask from the
generator in the order the unrematerialized block draws it, and the
recompute is handed the same masks in the same order. The masks (bool, one
byte an element) are what the block keeps; no generator state is read or
set, so the same code runs eagerly and inside a captured CUDA graph, and a
rematerialized step draws, and computes, what the plain step does bit for
bit. Nothing on the path draws from a default generator, so
``preserve_rng_state=False``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..ops.tensor_ops import generator_of, keep_mask

POLICIES = ("none", "block", "dots", "dots_no_batch", "save_attention")

_aten = torch.ops.aten
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}
SAVED_OPS = {"block": frozenset(), "dots": _DOTS, "dots_no_batch": _NO_BATCH_DOTS, "save_attention": _NO_BATCH_DOTS}


def _keep(t):
    return t


class RematTape:
    """What a rematerialized block's recompute must see again: its dropout
    keep masks, in draw order, and (``save_attention``) its attention
    outputs. The block's first run records; every later run (the recompute)
    replays from the start. It stands where the block takes its dropout
    generator (`ops.tensor_ops.keep_mask`, `ops.tensor_ops.generator_of`)
    and draws from what the block was given (``source``: a generator, or
    any object with ``generator`` and ``keep(shape, keep_prob, device)``)."""

    def __init__(self, source, save_attention: bool):
        self.source = source
        self.generator = generator_of(source)
        self.save_attention = save_attention
        self.masks: list = []
        self.outputs: list = []
        self.runs = 0
        self._mask = self._out = 0

    def start(self) -> None:
        """Called as the block begins a run: the first records, later ones replay."""
        self.runs += 1
        self._mask = self._out = 0

    def keep(self, shape, keep_prob: float, device) -> torch.Tensor:
        if self.runs > 1:
            mask = self.masks[self._mask]
            self._mask += 1
            return mask
        mask = keep_mask(shape, keep_prob, self.source, device)
        self.masks.append(mask)
        return mask

    def attend(self, core):
        """``core(rng)``, the attention of one path up to its output. Under
        ``save_attention`` the first run computes it outside the selective
        policy's caching and outside the checkpoint's saved-tensor hooks (the
        attention keeps its own saved tensors, its masks drawn straight from
        the source, so they are not replayed) and the recompute takes the
        output it recorded; otherwise it runs (again) with the tape's masks."""
        if not self.save_attention:
            return core(self)
        if self.runs > 1:
            out = self.outputs[self._out]
            self._out += 1
            return out
        with _disable_current_modes(), torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            out = core(self.source)
        self.outputs.append(out)
        return out


def attend(rng, core):
    """``core(rng)``, or through the tape when ``rng`` is a `RematTape`."""
    return rng.attend(core) if isinstance(rng, RematTape) else core(rng)


def _policy_fn(ops, ctx, func, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if func in ops else CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(policy: str, block, hidden_states, dropout_rng=None, **kwargs):
    """``block(hidden_states, dropout_rng=..., **kwargs)`` under the remat
    ``policy`` (one of `POLICIES`). Runs the block as it is with ``"none"``
    or with autograd off."""
    if policy not in POLICIES:
        raise ValueError(f"gradient_checkpointing must be one of {POLICIES}; got {policy!r}")
    if policy == "none" or not torch.is_grad_enabled():
        return block(hidden_states, dropout_rng=dropout_rng, **kwargs)
    tape = RematTape(dropout_rng, save_attention=policy == "save_attention")

    def run(h):
        tape.start()
        return block(h, dropout_rng=tape, **kwargs)

    ops = SAVED_OPS[policy]
    context = {}
    if ops:
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                  functools.partial(_policy_fn, ops))  # fmt: skip
    return checkpoint(run, hidden_states, use_reentrant=False, preserve_rng_state=False, **context)
